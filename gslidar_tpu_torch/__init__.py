"""gslidar_tpu_torch — the PyTorch / CUDA port of gslidar_tpu for one
NVIDIA H100.

The package mirrors ``gslidar_tpu``'s layout and names module for module,
so each port sits where its JAX counterpart does (``raster/preprocess.py``
ports ``gslidar_tpu/raster/preprocess.py``, and so on). ``gslidar_tpu``
stays the reference: every module here is held against it by the
``tests/test_torch_*.py`` parity tests.

Plain tensor code is PyTorch. Each Pallas TPU kernel on a ported path is
a CUDA C++ kernel under ``csrc/``, built with ``nvcc`` at first use
(``kernels.py``) and launched through a wrapper that keeps a plain PyTorch
version of the same function beside it. The wrapper runs the plain version
for CPU tensors and the kernel for CUDA tensors; it never falls back.

This package imports no JAX and nothing of ``gslidar_tpu``. It carries
its own copies of the numpy modules it needs from there (``config``,
``data.cameras``, ``data.kitti360``, ``data.opv2v``, ``data.synthetic``,
``data.preprocess``, ``engine.viewer``, ``utils.general``, ``utils.misc``,
``utils.ply``, ``utils.system``, ``native``), each named after its
original.
"""

__version__ = "0.1.0"
