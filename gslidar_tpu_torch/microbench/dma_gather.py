"""Row gather: the CUDA kernel's wrapper, its plain version and the
microbenchmark entry point (port of scripts/microbench_dma_gather.py::
_gather_kernel, the Pallas per-row DMA gather).

    python -m gslidar_tpu_torch.microbench.dma_gather [--device cuda|cpu]
        [--rows P --width D --ids K --seed S]

``out[i] = table[ids[i]]`` for a [P, D] float32 table and [K] int32 ids.
The defaults are the script's: P = 1,000,000, D = 128 and K = 17,664 x 128
= 2,260,992, made with numpy in the script's order
(``default_rng(seed)``: ``normal((P, D))`` first, then ``integers(0, P,
K)``), so both packages see the same data. The binning pipeline pays this
gather per sorted instance (``raster/binning.py``, ``payload[gid_s]``:
D = 18 there).

``gather_rows`` is the wrapper: CPU tensors go to the plain version,
``gather_rows_reference`` (``index_select``), CUDA tensors to the kernel
in ``csrc/gather_rows.cu``, anything else raises. It checks the types,
shapes, devices and contiguity; an id outside [0, P) raises IndexError on
the CPU (``index_select``) and traps the kernel on the card, as
``index_select``'s device-side assert does. The entry point checks the
kernel bitwise against the script's own oracle ``table[gid]``, times the
kernel and ``torch.index_select`` (the plain version) in turns (CUDA
events, median), and prints each time beside the least time the card
could take for the same bytes (``bounds.gather_bound``).
"""

from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

from gslidar_tpu_torch.microbench import bounds
from gslidar_tpu_torch.microbench.timing import entry_device, time_ms
from gslidar_tpu_torch.utils.trace import count

ROWS = 1_000_000
WIDTH = 128
IDS = 17664 * 128
SEED = 0
REPS = 10


def make_inputs(rows: int, width: int, n_ids: int, seed: int, device):
    """The script's table and ids: (table [P, D] float32, ids [K] int32)."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, width)).astype(np.float32)
    ids = rng.integers(0, rows, n_ids).astype(np.int32)
    return (torch.from_numpy(table).to(device),
            torch.from_numpy(ids).to(device))


def gather_rows_reference(table: torch.Tensor,
                          ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [K, D] rows of ``table``."""
    return table.index_select(0, ids)


def _check_inputs(table, ids):
    if table.dtype != torch.float32 or table.dim() != 2:
        raise TypeError(f"table must be a 2-D float32 tensor, got "
                        f"{table.dtype} {tuple(table.shape)}")
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise TypeError(f"ids must be a 1-D int32 tensor, got {ids.dtype} "
                        f"{tuple(ids.shape)}")
    if table.device != ids.device:
        raise ValueError(f"table on {table.device}, ids on {ids.device}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("table and ids must be contiguous")
    if table.shape[0] == 0:
        raise ValueError("the table has no rows")


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: [K, D] float32.

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (the counter ``launches.gather_rows`` counts those
    launches); any other device raises.
    """
    _check_inputs(table, ids)
    P, D = table.shape
    if table.device.type == "cpu":
        return gather_rows_reference(table, ids)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cpu or cuda tensors, not "
                         f"{table.device}")
    from gslidar_tpu_torch.kernels import load_library
    lib = load_library()
    out = torch.empty(ids.numel(), D, dtype=torch.float32,
                      device=table.device)
    dev = table.device.index if table.device.index is not None \
        else torch.cuda.current_device()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gslidar_gather_rows(dev, table.data_ptr(), P, D,
                                      ids.data_ptr(), ids.numel(),
                                      out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error "
                           f"{err}")
    count("launches.gather_rows")
    return out


def run(device, rows=ROWS, width=WIDTH, n_ids=IDS, seed=SEED, reps=REPS):
    """Check and time the gather at one shape. Returns a dict: the shape,
    ``bitwise`` (kernel == table[gid]), the median ms of the kernel and of
    ``torch.index_select``, the plain version (each alone, in turns after
    one warm-up), the bytes and the bound."""
    device = torch.device(device)
    table, ids = make_inputs(rows, width, n_ids, seed, device)
    out = gather_rows(table, ids)
    bitwise = bool(torch.equal(out, table[ids.long()]))
    del out
    # the plain version is the library call, torch.index_select
    stages = {"kernel": lambda: gather_rows(table, ids),
              "index_select": lambda: gather_rows_reference(table, ids)}
    for fn in stages.values():                  # warm-up
        fn()
    ms = {k: [] for k in stages}
    for _ in range(reps):
        for k, fn in stages.items():
            ms[k].append(time_ms(fn, device))
    n_bytes = bounds.gather_bytes(width, ids)
    return dict(rows=rows, width=width, ids=n_ids, seed=seed,
                device=str(device), bitwise=bitwise,
                ms={k: statistics.median(v) for k, v in ms.items()},
                n_bytes=n_bytes, bound=bounds.gather_bound(width, ids))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--rows", type=int, default=ROWS)
    parser.add_argument("--width", type=int, default=WIDTH)
    parser.add_argument("--ids", type=int, default=IDS)
    parser.add_argument("--seed", type=int, default=SEED)
    parser.add_argument("--reps", type=int, default=REPS)
    a = parser.parse_args(argv)
    device = entry_device(a.device)
    r = run(device, a.rows, a.width, a.ids, a.seed, a.reps)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu (the plain version, no kernel)")
    print(f"gather [{a.ids / 1e6:.2f}M ids of a {a.rows} x {a.width} f32 "
          f"table] on {where}, median of {a.reps}:")
    for k, label in (("kernel", "gather_rows"),
                     ("index_select", "torch.index_select (plain)")):
        t = r["ms"][k]
        print(f"  {label:26s} {t:9.3f} ms = {t / a.ids * 1e6:6.3f} ns/row, "
              f"{r['n_bytes'] / t / 1e6:8.1f} GB/s")
    b = r["bound"]
    print(f"  bound on an H100: {r['n_bytes']} bytes / 3.35 TB/s = "
          f"{b.ms:.3f} ms"
          + (f"; kernel at {b.ms / r['ms']['kernel']:.3f} of it"
             if device.type == "cuda" else ""))
    if not r["bitwise"]:
        raise RuntimeError("the gather disagrees with table[gid]")
    print("correctness: OK")
    return r


if __name__ == "__main__":
    main()
