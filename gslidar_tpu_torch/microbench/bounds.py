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
  slot 1), since each pixel must test every instance up to its last
  accepted one; the bound uses these;
* *walked* pairs: the sum over tiles of the instances walked (misc slot 5)
  times the tile's pixels, what the forward's blend pass and the backward
  kernel do; the ratio walked / needed is what the tile-wide early exit
  costs;
* *product* pairs: what the forward's product pass walks, the instances
  of each tile up to the end of the window of batches in which its walk
  ended (``composite_fwd.WINDOW_ENDS``; the whole list where the walk ran
  to its end) times the tile's pixels: it forms each window's products
  before the scan finds where the walk ends. Like the walked pairs they
  are a cost of the design, not work the function must do, and the bound
  leaves them out.
"""

from __future__ import annotations

import subprocess
from typing import NamedTuple

import torch

from gslidar_tpu_torch.raster.composite_fwd import WINDOW_ENDS

HBM_BYTES_PER_S = 3.35e12
SMS = 132
BOOST_CLOCK_HZ = 1.98e9          # the published maximum SM clock
ISSUE_PER_SM_CLOCK = {"fp32": 128, "mufu": 16, "shfl": 32}

# per pixel: its ray (composite_common.cuh pixel_ray; sinf/cosf uncounted)
RAY_FP32, RAY_MUFU = 8, 2
# per staged instance: splat centre, normal and the three cross products
# (composite_common.cuh splat_centre, splat_normal, stage_instance)
STAGE_FP32, STAGE_MUFU = 73, 7
# per (instance, pixel) pair: the intersection (composite_common.cuh
# intersect)
INTERSECT_FP32, INTERSECT_MUFU = 29, 2
# per accepted pair of the forward: blend, 14 + 2 (C + S), and the
# distortion moments (composite_fwd.cu fwd_blend_kernel's walk)
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


# --------------------------------------------------------- preprocess
# per gaussian, least counts read off csrc/preprocess.cu. MUFU: the
# forward's quaternion sqrtf and 4 divisions, the centre's 2 atan2f and 2
# sqrtf, the cutoff's logf and sqrtf, 12 samples x (2 atan2f + sqrtf), the
# view direction's sqrtf and 3 divisions; the backward's quaternion sqrtf
# and 4 divisions, 4 more for its gradient, the view direction's sqrtf
# and 3 divisions and 3 for its gradient. fp32: the forward's 12 samples
# x 27 (position 15, guard 3, theta's argument 3, pixel maps 6) and its
# frame (110: normalisation, rotation, four 3x3 products, flip), the
# backward's 160 (its four 3x3 products, rotation, quaternion gradient
# and normalisation), plus the SH terms below
PREP_FWD_MUFU, PREP_BWD_MUFU = 51, 16
PREP_FWD_FP32, PREP_BWD_FP32 = 12 * 27 + 110, 160


def preprocess_bytes(P: int, n_sh: int, K: int, C: int, scale_cols: int,
                     backward: bool = False) -> int:
    """The bytes the preprocess pass must move for P gaussians with n_sh
    active SH coefficients of K, C channels (n_sh = 0: the colors were
    given) and scales of scale_cols columns. Forward: reads means 12,
    two scales 8, the quaternion 16, opacity 4, mask 1 and the active SH
    4 n_sh C; writes T 36, xy 8, depth 4, normal 12, color 4 C, radius 4,
    the rects 16, the tile count 4, valid 1 and the clamp mask C (with SH).
    Backward: reads means, two scales, the quaternion, dT 36 and with SH
    the active coefficients, the clamp mask and d color 4 C; writes d means
    12, d scales 4 scale_cols, d quats 16 and d SH 4 K C."""
    if backward:
        read = 12 + 8 + 16 + 36 + (4 * n_sh * C + C + 4 * C if n_sh else 0)
        write = 12 + 4 * scale_cols + 16 + (4 * K * C if n_sh else 0)
    else:
        read = 12 + 8 + 16 + 4 + 1 + 4 * n_sh * C
        write = 36 + 8 + 4 + 12 + 4 + 16 + 4 + 1 + (5 * C if n_sh else 0)
    return P * (read + write)


def preprocess_bound(P: int, n_sh: int, K: int, C: int, scale_cols: int,
                     clock_hz: float, backward: bool = False) -> Bound:
    """The least time of the preprocess pass (``preprocess_bytes``), the
    forward or the backward: its bytes, its fp32 adds and multiplies (the
    SH sum 2 n_sh C + C in the forward; in the backward 2 n_sh C for the
    basis' gradients, n_sh C for d SH and 6 (n_sh - 1) for d direction)
    and its MUFU operations."""
    if backward:
        fp32 = PREP_BWD_FP32 + 3 * n_sh * C + 6 * max(n_sh - 1, 0)
        mufu = PREP_BWD_MUFU
    else:
        fp32 = PREP_FWD_FP32 + (2 * n_sh * C + C if n_sh else 0)
        mufu = PREP_FWD_MUFU
    return bound(bytes=bytes_ms(preprocess_bytes(P, n_sh, K, C, scale_cols,
                                                 backward)),
                 fp32=issue_ms(P * fp32, "fp32", clock_hz),
                 mufu=issue_ms(P * mufu, "mufu", clock_hz))


# ---------------------------------------------------------- op chains
# per element and op, the instructions each pipe must issue (float32;
# bfloat16 packs two elements per instruction where sm_90a has the packed
# form): csrc/op_chain.cu F32/BF16
CHAIN_OP_ISSUE = {
    "mul": {"fp32": 1},
    "fma": {"fp32": 2},                        # unfused multiply, add
    "select": {"fp32": 2},                     # v * v, the select
    "exp": {"fp32": 1, "mufu": 1},             # the log2 e scale, ex2
    "div": {"fp32": 1, "mufu": 1},             # v + 1, the reciprocal
    "rsqrt": {"fp32": 1, "mufu": 1},           # v + 1, rsqrt
    # the multiply; and a roll of a 256-row column held by 32 lanes moves
    # at least one value out of each lane: one shuffle per 8 rows
    "roll1": {"fp32": 1, "shfl": 1 / 8},
    "roll8": {"fp32": 1, "shfl": 1 / 8},
}
# v - floor(v), each step: the floor and the subtract
CHAIN_STEP_ISSUE = {"floor": {"fp32": 1}, "sub": {"fp32": 1}}
# (op, pipe) whose count per element does not halve in bfloat16, where
# sm_90a has no packed form (microbench/isa_probe.py): ptxas refuses
# rcp.approx.ftz.bf16x2, rsqrt.approx.ftz.bf16x2 and cvt.rmi.bf16x2, and
# takes ex2.approx.ftz.bf16x2 as two MUFU.EX2.BF16, one per half. A lane
# holds 8 rows in bfloat16 too, so a roll still moves one value out of each
# lane.
UNPACKED_BF16 = {("exp", "mufu"), ("div", "mufu"), ("rsqrt", "mufu"),
                 ("roll1", "shfl"), ("roll8", "shfl"), ("floor", "fp32")}


def chain_lanes(op: str, pipe: str, packed: bool) -> int:
    """Elements one instruction of ``pipe`` takes in ``op`` (a case, or a
    part of the step's v - floor(v))."""
    return 2 if packed and (op, pipe) not in UNPACKED_BF16 else 1


def chain_op_bound(case: str, elements: int, packed: bool,
                   clock_hz: float) -> Bound:
    """Least time of one full-block op of ``case``."""
    return bound(**{pipe: issue_ms(n * elements
                                   / chain_lanes(case, pipe, packed),
                                   pipe, clock_hz)
                    for pipe, n in CHAIN_OP_ISSUE[case].items()})


def chain_bound(case: str, ops_per_step: int, steps: int, elements: int,
                element_bytes: int, packed: bool, clock_hz: float) -> Bound:
    """Least time of a whole chain: the block in and out, and every op
    and renormalisation of every step."""
    per_el = {}
    for pipe, n in CHAIN_OP_ISSUE[case].items():
        per_el[pipe] = per_el.get(pipe, 0) + n * ops_per_step / chain_lanes(
            case, pipe, packed)
    for op, issue in CHAIN_STEP_ISSUE.items():
        for pipe, n in issue.items():
            per_el[pipe] = per_el.get(pipe, 0) + n / chain_lanes(op, pipe,
                                                                 packed)
    terms = {pipe: issue_ms(n * steps * elements, pipe, clock_hz)
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
    # the walk per tile: instances walked, the largest and the mean, the
    # share of the walked pairs in the heaviest tenth of the tiles, and
    # the staging batches (tile-pixel chunks) walked, summed over tiles
    tile_walked_max: int = 0
    tile_walked_mean: float = 0.0
    heavy_tenth_share: float = 0.0
    walked_chunks: int = 0
    # the forward's product pass: the pairs and the staging batches it
    # walks (0 when the tile ranges were not given)
    product_pairs: int = 0
    product_chunks: int = 0

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
                   backward: bool = False,
                   tile_starts: torch.Tensor | None = None) -> CompositeWork:
    """The work of the forward (or, with ``backward``, the backward)
    compositing kernel on the inputs that gave the forward outputs
    ``fwd`` (a CompositeOut with n_contrib and the walked counts); with
    the tile ranges ``tile_starts`` ([n_tiles + 1]), also the pairs the
    forward's product pass walks."""
    misc = fwd.misc.detach()
    n_contrib = _tiled(misc[1].to(torch.float64), settings)
    inside = _tiled(torch.ones_like(misc[1], dtype=torch.float64),
                    settings)
    walked = misc[5, ::settings.tile_h, ::settings.tile_w].reshape(-1)
    needed_pairs = int(n_contrib.sum())
    tile_pairs = walked.to(torch.float64) * inside.sum(1)
    walked_pairs = int(tile_pairs.sum())
    product_pairs = product_chunks = 0
    if tile_starts is not None:
        counts = (tile_starts[1:] - tile_starts[:-1]).to(walked.device,
                                                          torch.int64)
        batches = product_batches(walked.to(torch.int64), counts,
                                  settings.tile_h * settings.tile_w)
        inst = torch.minimum(counts, batches * settings.tile_h
                             * settings.tile_w)
        product_pairs = int((inst.to(torch.float64) * inside.sum(1)).sum())
        product_chunks = int(batches.sum())
    heavy = tile_pairs.sort(descending=True).values[
        :-(-tile_pairs.numel() // 10)]
    pix = settings.tile_h * settings.tile_w
    walked_i = walked.to(torch.int64)
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
                         n_bytes=n_bytes, fp32=fp32, mufu=mufu,
                         tile_walked_max=int(walked_i.max()),
                         tile_walked_mean=float(walked_i.double().mean()),
                         heavy_tenth_share=float(heavy.sum())
                         / max(walked_pairs, 1),
                         walked_chunks=int(((walked_i + pix - 1)
                                            // pix).sum()),
                         product_pairs=product_pairs,
                         product_chunks=product_chunks)


def product_batches(walked: torch.Tensor, counts: torch.Tensor, B: int,
                    window_ends=WINDOW_ENDS) -> torch.Tensor:
    """Per tile, the staging batches the forward's product pass walks,
    from the instances walked and held: the tile's whole list where the
    walk ran to its end; else up to the end of the window that holds the
    batch where the vote stopped it, within the list."""
    n_b = (counts + B - 1) // B
    stop = walked // B                 # the batch the vote stopped at
    # the window ends, then the last window's: the end of the list
    ends = torch.cat([torch.tensor(window_ends, dtype=torch.int64,
                                   device=walked.device).expand(len(n_b), -1),
                      n_b[:, None]], 1)
    k = torch.searchsorted(ends[:, :-1].contiguous(), stop[:, None],
                           right=True)
    hi = torch.gather(ends, 1, k)[:, 0]
    return torch.where(walked < counts, torch.minimum(hi, n_b), n_b)
