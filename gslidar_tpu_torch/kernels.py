"""Build and load the port's CUDA kernels.

The sources under ``gslidar_tpu_torch/csrc/`` are compiled at first use
with ``nvcc`` into one shared library with a plain C interface, which is
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
Each source compiles in its own nvcc process, all started together, and
one more links them:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xptxas=-v -Xcompiler -fPIC -c -o <obj>.o
         gslidar_tpu_torch/csrc/<src>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o build/gslidar_tpu_torch/<lib>.so <obj>.o ...

The library goes to ``build/gslidar_tpu_torch/`` beside the package and
is named by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is reused. The compiler's output (ptxas's
register and shared-memory report per kernel) is kept beside it as
``<lib>.log``. A failed build raises with the
compiler's output. Nothing is built or imported while this module is
imported.

``--fmad=false`` keeps nvcc from contracting a*b + c into fused
multiply-adds, so each kernel runs the same IEEE operation sequence as its
plain PyTorch version (see the note in csrc/composite_fwd.cu), and the
backward kernel recomputes the forward's walk bit for bit.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build",
                         "gslidar_tpu_torch")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xptxas=-v",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_D = ctypes.c_double
# C signatures of the exported launchers: name -> argtypes (restype int)
SIGNATURES = {
    "gslidar_composite_fwd": [
        _I, _P, _I, _P,                  # device, rows, D, tile_starts
        _P, _I,                          # chunk_off, grid
        _I, _I, _I, _I, _I, _I, _I, _I,  # n_tiles, tiles_x, tile_h, tile_w,
                                         # H, W, C, S
        _F, _F, _F, _F, _F, _F, _F, _F,  # near, far, vmin, vmax, hmin,
                                         # hmax, wrap_w, wrap_inv
        _I, _I,                          # compute_distortion, contrib
        _I, _P,                          # n_ends, window_ends (host int[])
        _P, _P, _P, _P,                  # prod, T_start, walked, part
        _P,                              # ckpt (or null)
        _P, _P, _P, _P,                  # color, feat, depth, misc
        _P,                              # stream
    ],
    "gslidar_composite_bwd": [
        _I, _P, _I, _P, _P,              # device, rows, D, tile_starts,
                                         # walked
        _P, _P, _I,                      # chunk_off, ckpt, grid
        _I, _I, _I, _I, _I, _I, _I, _I,  # n_tiles, tiles_x, tile_h, tile_w,
                                         # H, W, C, S
        _F, _F, _F, _F, _F, _F, _F, _F,  # near, far, vmin, vmax, hmin,
                                         # hmax, wrap_w, wrap_inv
        _I,                              # compute_distortion
        _P, _P, _P, _P,                  # gC, gF, gD4, gT
        _P, _P, _P, _P,                  # color, feat, depth, misc
        _P, _P,                          # grad, stream
    ],
    "gslidar_composite_fwd_info": [
        _I, _I, _I, _I, _I, _I, _I, _P,  # device, pass, tile_h, tile_w, C,
                                         # S, checkpoints, out
    ],
    "gslidar_composite_bwd_info": [
        _I, _I, _I, _I, _I, _P,          # device, tile_h, tile_w, C, S, out
    ],
    "gslidar_gather_rows": [
        _I, _P, _L, _I,                  # device, table, P, D
        _P, _L, _P, _P,                  # ids, K, out, stream
    ],
    "gslidar_op_chain": [
        _I, _I, _I, _I,                  # device, dtype, case, steps
        _P, _P, _I, _P,                  # x, out, cols, stream
    ],
    "gslidar_op_chain_info": [
        _I, _I, _I, _I, _P,              # device, dtype, case, cols, out
    ],
    "gslidar_preprocess_fwd": [
        _I, _P,                          # device, params (host PrepParams)
        _P, _P, _P, _P, _P,              # means, scales, quats, opacity,
                                         # mask
        _P, _P, _P, _P,                  # sh_dc, sh_rest, features, colors
        _P, _P, _P, _P,                  # viewmat, campos, sin_a, cos_a
        _P, _P, _P, _P, _P, _P, _P,      # T, xy, depth, normal, color,
                                         # payload, radius
        _P, _P, _P, _P, _P,              # rect_min, rect_max, tiles, valid,
                                         # clamped
        _P,                              # stream
    ],
    "gslidar_chamfer_fwd": [
        _I, _P, _I, _I, _I, _P,          # device, x1, n1, row1, col1, mask1
        _P, _I, _I, _I, _P,              # x2, n2, row2, col2, mask2
        _P, _P,                          # keys, merge counts
        _P, _P, _P, _P,                  # dist1, idx1, dist2, idx2
        _P,                              # stream
    ],
    "gslidar_chamfer_bwd": [
        _I, _P, _I, _I, _I,              # device, x1, n1, row1, col1
        _P, _I, _I, _I,                  # x2, n2, row2, col2
        _P, _P, _P, _P,                  # idx1, idx2, g1, g2
        _P, _P, _P,                      # dx1, dx2, stream
    ],
    "gslidar_adam": [
        _I, _I, _P, _P, _P,              # device, groups, ptrs, sizes, lrs
                                         # (host arrays)
        _F, _F, _F, _F, _F, _F, _F,      # b1, 1 - b1, b2, 1 - b2, 1 / c1,
                                         # 1 / c2, eps
        _P,                              # stream
    ],
    "gslidar_bn_act_fwd": [
        _I, _P, _P, _P, _P,              # device, x, u, weight, bias
        _P, _P, _P, _P,                  # running_mean, running_var,
                                         # saved, part
        _P, _P, _L, _I, _L,              # y, keep, B, C, HW
        _I, _F, _F, _F, _F, _D,          # relu, p, scale, momentum,
                                         # 1 - momentum, eps
        _I, _P,                          # max_parts, stream
    ],
    "gslidar_bn_act_bwd": [
        _I, _P, _P, _P, _P, _P,          # device, dy, x, keep, weight, bias
        _P, _P, _P, _P, _P,              # saved, part, dx, dweight, dbias
        _L, _I, _L, _I, _I, _F,          # B, C, HW, relu, drop, scale
        _I, _P,                          # max_parts, stream
    ],
    "gslidar_preprocess_bwd": [
        _I, _P,                          # device, params (host PrepParams)
        _P, _P, _P, _P, _P,              # means, scales, quats, sh_dc,
                                         # sh_rest
        _P, _P,                          # viewmat, campos
        _P, _P, _P,                      # clamped, dT, dcolor
        _P, _P, _P, _P, _P,              # dmeans, dscales, dquats, d_dc,
                                         # d_rest
        _P,                              # stream
    ],
}


class KernelLibrary:
    """The loaded shared library and what its build cost."""

    def __init__(self, path: str, build_seconds: float):
        self.path = path
        self.build_seconds = build_seconds
        self.lib = ctypes.CDLL(path)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self.lib, name)


_lock = threading.Lock()
_loaded: KernelLibrary | None = None


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    hdrs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources under {CSRC_DIR}")
    return srcs, hdrs


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def library_path() -> str:
    """Path of the library for the current sources and flags."""
    srcs, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs + hdrs:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libgslidar_tpu_torch_"
                                   f"{h.hexdigest()[:16]}.so")


def _run_all(cmds):
    """Run the commands in parallel; returns [(cmd, returncode, output)]."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    results = []
    for cmd, p in procs:
        out, _ = p.communicate()
        results.append((cmd, p.returncode, out))
    return results


def build() -> tuple[str, float]:
    """Compile the sources unless the library for them exists.
    Returns (path, seconds spent building)."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0
    srcs, _ = _sources()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in srcs]
    t0 = time.perf_counter()
    try:
        runs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                         for src, obj in zip(srcs, objs)])
        if all(rc == 0 for _, rc, _ in runs):
            runs += _run_all([[nvcc, *ARCH, "-shared", "-o", tmp, *objs]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    seconds = time.perf_counter() - t0
    log = "".join(f"$ {' '.join(cmd)}\n{out}" for cmd, _, out in runs)
    if any(rc != 0 for _, rc, _ in runs):
        raise RuntimeError(f"nvcc failed:\n{log}")
    with open(path[:-3] + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, path)
    return path, seconds


def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library, once per process."""
    global _loaded
    with _lock:
        if _loaded is None:
            path, seconds = build()
            _loaded = KernelLibrary(path, seconds)
        return _loaded


def launch(name: str, dev, *args) -> None:
    """Call launcher ``name`` of the library for CUDA device ``dev`` with
    ``args`` and the device's current stream; raise on a CUDA error."""
    import torch
    lib = load_library()
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    with torch.cuda.device(index):
        err = getattr(lib, name)(index, *args,
                                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


RESOURCE_FIELDS = ("registers", "static_smem", "local_bytes",
                   "dynamic_smem", "ctas_per_sm")


# the forward compositor's passes (csrc/composite_fwd.cu: the product and
# scan passes run once per window of batches, then the blend and the
# merge); pass p's kernel is fwd_<p>_kernel
FWD_PASSES = ("product", "scan", "blend", "merge")
COMPOSITORS = (*(f"composite_fwd.{p}" for p in FWD_PASSES), "composite_bwd")


def kernel_resources(kernel: str, tile_h: int, tile_w: int, C: int, S: int,
                     checkpoints: bool = False, device: int = 0) -> dict:
    """What compositor ``kernel`` (one of ``COMPOSITORS``: a pass of the
    forward, "composite_fwd.<pass>", or "composite_bwd") takes at a launch
    for tile_h x tile_w tiles: registers per thread, static shared memory
    and local (spill) bytes per thread (``cudaFuncGetAttributes``), the
    launch's dynamic shared memory, and the CTAs resident per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``). For the forward's
    merge, ``checkpoints`` picks the instance that stores them (training)
    over the one that does not (serving)."""
    if kernel not in COMPOSITORS:
        raise ValueError(f"unknown compositor {kernel!r}, not one of "
                         f"{COMPOSITORS}")
    lib = load_library()
    out = (ctypes.c_int * len(RESOURCE_FIELDS))()
    if kernel == "composite_bwd":
        err = lib.gslidar_composite_bwd_info(device, tile_h, tile_w, C, S,
                                             out)
    else:
        err = lib.gslidar_composite_fwd_info(
            device, FWD_PASSES.index(kernel.split(".")[1]), tile_h, tile_w,
            C, S, int(checkpoints), out)
    if err != 0:
        raise RuntimeError(f"{kernel} resource query failed: CUDA error {err}")
    return dict(zip(RESOURCE_FIELDS, out))


OP_CHAIN_FIELDS = ("grid", "cta_warps", "regs_per_thread", "registers",
                   "local_bytes", "ctas_per_sm", "sms")


def op_chain_resources(dtype_id: int, case_id: int, cols: int,
                       device: int = 0) -> dict:
    """The launch of the op chain of (dtype_id, case_id) on a [256, cols]
    block (``csrc/op_chain.cu``): its grid, warps per CTA, the layout's
    registers per thread, the registers and local (spill) bytes per thread
    (``cudaFuncGetAttributes``), the CTAs resident per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the SMs the
    grid reaches in one wave."""
    lib = load_library()
    out = (ctypes.c_int * len(OP_CHAIN_FIELDS))()
    err = lib.gslidar_op_chain_info(device, dtype_id, case_id, cols, out)
    if err != 0:
        raise RuntimeError(f"op-chain resource query failed: CUDA error "
                           f"{err}")
    return dict(zip(OP_CHAIN_FIELDS, out))
