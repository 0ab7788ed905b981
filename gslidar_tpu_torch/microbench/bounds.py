"""The least time an H100 could take for each kernel's work.

A bound is the largest of its terms, each the work of one resource over
that resource's peak rate on one NVIDIA H100 SXM (NVIDIA's data sheet, at
the 700 W power limit):

* bytes: each input read once and each output written once, over
  3.35 TB/s of device memory;
* fp32: float32 adds, subtracts and multiplies over their issue rate, 128
  per clock per SM on 132 SMs at the card's SM clock (33.5e12 per second
  at 1,980 MHz). The data sheet's 67 TFLOP/s counts an FMA as 2 flops;
  the port's library is built with --fmad=false, so its kernels issue no
  FMA and each add or multiply takes an issue slot of its own;
* mufu: exp2, reciprocal, square root and reciprocal square root over the
  MUFU unit's 16 per clock per SM, on 132 SMs at the card's SM clock;
* issue terms of the op chains (``chain_bound``): instructions over their
  pipe's issue rate, 128 per clock per SM for float32 add, multiply and
  select, 16 for MUFU, 32 for warp shuffles.

The compositors' operation counts are read off their sources and kept as
named constants with the lines they were counted from. Only add, subtract
and multiply count as fp32 operations (compares, selects, min and the
polynomial parts of atan2f, sinf and cosf do not), and an IEEE division,
sqrtf, rsqrtf, expf or atan2f counts as its one MUFU operation, so each
count is a least count and the bound a least time. Where the work depends
on the data, it is what this run's data needs:

* *needed* (instance, pixel) pairs: the sum over pixels of n_contrib (misc
  slot 1, composite_fwd.cu:166), since each pixel must test every instance
  up to its last accepted one; the bound uses these;
* *walked* pairs: the sum over tiles of the instances walked (misc slot 5,
  composite_fwd.cu:170) times the tile's pixels, what the kernels do; the
  ratio walked / needed is what the tile-wide early exit costs.
"""

from __future__ import annotations

import subprocess
from typing import NamedTuple

import torch

HBM_BYTES_PER_S = 3.35e12
SMS = 132
BOOST_CLOCK_HZ = 1.98e9          # the published maximum SM clock
ISSUE_PER_SM_CLOCK = {"fp32": 128, "mufu": 16, "shfl": 32}

# per pixel: its ray (composite_common.cuh:44-59; sinf/cosf uncounted)
RAY_FP32, RAY_MUFU = 8, 2
# per staged instance: splat centre, normal and the three cross products
# (composite_common.cuh:61-126)
STAGE_FP32, STAGE_MUFU = 73, 7
# per (instance, pixel) pair: the intersection (composite_common.cuh:
# 136-160)
INTERSECT_FP32, INTERSECT_MUFU = 29, 2
# per accepted pair of the forward: blend, 14 + 2 (C + S) (composite_fwd
# .cu:117-134), and the distortion moments (:135-143)
FWD_ACCEPT_FP32 = 14
FWD_DIST_FP32, FWD_DIST_MUFU = 16, 1
# per accepted pair of the backward, 3d branch: 51 + 2 C + (C + S + 3) and
# 2 MUFU (composite_bwd.cu:292-357), and the distortion terms (:310-314,
# :320-324)
BWD_ACCEPT_FP32, BWD_ACCEPT_MUFU = 51, 2
BWD_DIST_FP32, BWD_DIST_MUFU = 21, 2
# per instance of the backward: its gradient row (composite_bwd.cu:105-175)
FINISH_FP32, FINISH_MUFU = 209, 7


class Bound(NamedTuple):
    ms: float
    by: str                 # the term that sets it
    terms: dict             # term -> ms

    @property
    def bound_by(self) -> str:
        """"bytes" or "operations", as the kernels line names them."""
        return "bytes" if self.by == "bytes" else "operations"


def bound(**terms_ms) -> Bound:
    """The largest of the terms (ms each), and which one it is."""
    by = max(terms_ms, key=terms_ms.get)
    return Bound(ms=terms_ms[by], by=by, terms=dict(terms_ms))


def bytes_ms(n_bytes) -> float:
    return float(n_bytes) / HBM_BYTES_PER_S * 1e3


def issue_ms(instructions, pipe: str, clock_hz: float) -> float:
    return (float(instructions)
            / (ISSUE_PER_SM_CLOCK[pipe] * SMS * clock_hz) * 1e3)


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()
    return float(out[0]) * 1e6


# ------------------------------------------------------------- gather
def gather_bytes(width: int, ids: torch.Tensor) -> int:
    """Distinct rows read, the ids, and the output rows written."""
    distinct = int(torch.unique(ids).numel())
    k = ids.numel()
    return distinct * width * 4 + k * 4 + k * width * 4


def gather_bound(width: int, ids: torch.Tensor) -> Bound:
    return bound(bytes=bytes_ms(gather_bytes(width, ids)))


# ---------------------------------------------------------- op chains
# per element and op, the instructions each pipe must issue (float32;
# bfloat16 packs two elements per instruction): csrc/op_chain.cu F32/BF16
CHAIN_OP_ISSUE = {
    "mul": {"fp32": 1},
    "fma": {"fp32": 2},                        # unfused multiply, add
    "select": {"fp32": 2},                     # v * v, the select
    "exp": {"fp32": 1, "mufu": 1},             # the log2 e scale, ex2
    "div": {"fp32": 1, "mufu": 1},             # v + 1, the reciprocal
    "rsqrt": {"fp32": 1, "mufu": 1},           # v + 1, rsqrt
    "roll1": {"fp32": 1, "shfl": 1},           # the multiply, the shuffle
    "roll8": {"fp32": 1, "shfl": 1},
}
CHAIN_STEP_ISSUE = {"fp32": 2}                 # v - floor(v)


def chain_op_bound(case: str, elements: int, packed: bool,
                   clock_hz: float) -> Bound:
    """Least time of one full-block op of ``case``."""
    lanes = 2 if packed else 1
    return bound(**{pipe: issue_ms(n * elements / lanes, pipe, clock_hz)
                    for pipe, n in CHAIN_OP_ISSUE[case].items()})


def chain_bound(case: str, ops_per_step: int, steps: int, elements: int,
                element_bytes: int, packed: bool, clock_hz: float) -> Bound:
    """Least time of a whole chain: the block in and out, and every op
    and renormalisation of every step."""
    lanes = 2 if packed else 1
    per_el = {}
    for pipe, n in CHAIN_OP_ISSUE[case].items():
        per_el[pipe] = per_el.get(pipe, 0) + n * ops_per_step
    for pipe, n in CHAIN_STEP_ISSUE.items():
        per_el[pipe] = per_el.get(pipe, 0) + n
    terms = {pipe: issue_ms(n * steps * elements / lanes, pipe, clock_hz)
             for pipe, n in per_el.items()}
    return bound(bytes=bytes_ms(2 * elements * element_bytes), **terms)


# -------------------------------------------------------- compositors
class CompositeWork(NamedTuple):
    needed_pairs: int
    walked_pairs: int
    needed_instances: int    # per tile, up to its furthest n_contrib
    accepting_pixels: int    # pixels with at least one accepted instance
    pixels: int
    n_bytes: int
    fp32: int
    mufu: int

    @property
    def walked_over_needed(self) -> float:
        return self.walked_pairs / max(self.needed_pairs, 1)

    def bound(self, clock_hz: float = BOOST_CLOCK_HZ) -> Bound:
        return bound(bytes=bytes_ms(self.n_bytes),
                     fp32=issue_ms(self.fp32, "fp32", clock_hz),
                     mufu=issue_ms(self.mufu, "mufu", clock_hz))


def _tiled(plane: torch.Tensor, settings) -> torch.Tensor:
    """[H, W] -> [n_tiles, tile pixels], zero in the tile padding."""
    th, tw = settings.tile_h, settings.tile_w
    gy, gx = settings.tiles_y, settings.tiles_x
    pad = plane.new_zeros(gy * th, gx * tw)
    pad[:settings.height, :settings.width] = plane
    return pad.reshape(gy, th, gx, tw).permute(0, 2, 1, 3).reshape(
        gy * gx, th * tw)


def composite_work(fwd, settings, n_rows: int, C: int, S: int,
                   backward: bool = False) -> CompositeWork:
    """The work of the forward (or, with ``backward``, the backward)
    compositing kernel on the inputs that gave the forward outputs
    ``fwd`` (a CompositeOut with n_contrib and the walked counts)."""
    n_contrib = _tiled(fwd.misc[1].to(torch.float64), settings)
    inside = _tiled(torch.ones_like(fwd.misc[1], dtype=torch.float64),
                    settings)
    walked = fwd.misc[5, ::settings.tile_h, ::settings.tile_w].reshape(-1)
    needed_pairs = int(n_contrib.sum())
    walked_pairs = int((walked.to(torch.float64) * inside.sum(1)).sum())
    needed_inst = int(n_contrib.amax(1).sum())
    accepting = int((n_contrib > 0).sum())
    pixels = settings.height * settings.width
    n_tiles = settings.num_tiles
    D = 10 + C + S
    dist = bool(settings.compute_distortion)
    rows_in = needed_inst * D * 4 + (n_tiles + 1) * 4
    if not backward:
        planes_out = C + (S + 3) + 4 + 8
        n_bytes = rows_in + planes_out * pixels * 4
        accept_fp32 = FWD_ACCEPT_FP32 + 2 * (C + S) + dist * FWD_DIST_FP32
        accept_mufu = dist * FWD_DIST_MUFU
        inst_fp32, inst_mufu = STAGE_FP32, STAGE_MUFU
    else:
        # cotangents gC, gF, gD4, gT; the forward planes it reads: color,
        # the 3 normals, depth 0 and 3, misc 0, 2, 3, 4, 6; the walked
        # counts in; the whole gradient table out
        planes_in = (C + S + 3 + 4 + 1) + (C + 3 + 2 + 5)
        n_bytes = (rows_in + n_tiles * 4 + planes_in * pixels * 4
                   + n_rows * D * 4)
        accept_fp32 = (BWD_ACCEPT_FP32 + 2 * C + (C + S + 3)
                       + dist * BWD_DIST_FP32)
        accept_mufu = BWD_ACCEPT_MUFU + dist * BWD_DIST_MUFU
        inst_fp32 = STAGE_FP32 + FINISH_FP32
        inst_mufu = STAGE_MUFU + FINISH_MUFU
    fp32 = (pixels * RAY_FP32 + needed_pairs * INTERSECT_FP32
            + needed_inst * inst_fp32 + accepting * accept_fp32)
    mufu = (pixels * RAY_MUFU + needed_pairs * INTERSECT_MUFU
            + needed_inst * inst_mufu + accepting * accept_mufu)
    return CompositeWork(needed_pairs=needed_pairs,
                         walked_pairs=walked_pairs,
                         needed_instances=needed_inst,
                         accepting_pixels=accepting, pixels=pixels,
                         n_bytes=n_bytes, fp32=fp32, mufu=mufu)
