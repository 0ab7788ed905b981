"""Microbenchmark kernels (ports of scripts/microbench_dma_gather.py and
scripts/microbench_vpu_ops.py) and the least-time bound of every kernel of
the port (``bounds``)."""
