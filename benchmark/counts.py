"""The work the mathematics of a training step needs, and its least time
on one NVIDIA H100 SXM.

The count functions and peak terms are a frozen copy of the port's
``gslidar_tpu_torch/microbench/bounds.py`` (``benchmark/tests/
test_benchmark_frozen_counts.py`` holds the copy equal to the port's on a
seeded fixture), kept here so that a change to the program cannot move
the yardstick. The compositors' pairs come from the benchmark's
reference (``benchmark/reference``), which composites the same views:
its ``n_contrib`` gives the needed (instance, pixel) pairs, its walk the
walked instances, its binning the instance count.

``least_s`` sums the bytes, the float32 operations and the MUFU
operations of every part of the work and takes the largest of the three
times: the least time of the whole step, whatever kernels carry
it. ``mfu`` shares of ``benchmark/metrics`` divide it by a measured time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# the ends of the windows of staging batches the kernel's product and scan
# passes take in rounds, the last window running to the end of the list
# (csrc/composite_fwd.cu)
WINDOW_ENDS = (4, 16, 64)


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



# ------------------------------------------------------ the whole step
# the render's activations (engine/render.py: the SHM means, the marginal
# in t, the scales, the velocity features) read per gaussian: xyz 12,
# velocity 12, t 4, scaling_t 4, opacity 4, scaling 12 bytes
ACTIVATION_BYTES = 48
# Adam per parameter element: p, g, mu and nu read, p, mu and nu written
ADAM_BYTES = 7 * 4


class Work(NamedTuple):
    """Bytes, float32 operations and MUFU operations, by part."""
    parts: dict

    @property
    def n_bytes(self) -> float:
        return sum(p[0] for p in self.parts.values())

    @property
    def fp32(self) -> float:
        return sum(p[1] for p in self.parts.values())

    @property
    def mufu(self) -> float:
        return sum(p[2] for p in self.parts.values())

    def least_s(self, clock_hz: float = BOOST_CLOCK_HZ) -> float:
        """The largest of the bytes' time at the HBM rate and the
        operations' at their issue rates, in seconds."""
        return max(bytes_ms(self.n_bytes),
                   issue_ms(self.fp32, "fp32", clock_hz),
                   issue_ms(self.mufu, "mufu", clock_hz)) / 1e3


def preprocess_work(P: int, n_sh: int, K: int, C: int, scale_cols: int,
                    backward: bool = False):
    """(bytes, fp32, mufu) of the preprocess pass, the terms of
    ``preprocess_bound``."""
    if backward:
        fp32 = PREP_BWD_FP32 + 3 * n_sh * C + 6 * max(n_sh - 1, 0)
        mufu = PREP_BWD_MUFU
    else:
        fp32 = PREP_FWD_FP32 + (2 * n_sh * C + C if n_sh else 0)
        mufu = PREP_FWD_MUFU
    return (preprocess_bytes(P, n_sh, K, C, scale_cols, backward),
            P * fp32, P * mufu)


def composite_parts(composited, C: int, S: int, backward: bool):
    """(bytes, fp32, mufu) of the compositor on each of ``composited``
    (``benchmark.reference.raster.Composited``), averaged over them."""
    works = [composite_work(c.fwd, c.settings, c.num_pairs, C, S,
                            backward=backward) for c in composited]
    n = max(len(works), 1)
    return (sum(w.n_bytes for w in works) / n,
            sum(w.fp32 for w in works) / n, sum(w.mufu for w in works) / n)


def composite_bound_ms(composited, C: int, S: int, backward: bool) -> float:
    """The compositor's least time per render, averaged over
    ``composited``."""
    ms = [composite_work(c.fwd, c.settings, c.num_pairs, C, S,
                         backward=backward).bound().ms for c in composited]
    return sum(ms) / max(len(ms), 1)


def step_work(P: int, floats_per_gaussian: int, prior_elements: int,
              composited, n_sh: int, K: int, C: int, S: int) -> Work:
    """One training step: the render's activations, preprocess forward
    and backward, the compositors at the needed pairs, the loss planes
    and Adam over every group and the prior."""
    st = composited[0].settings
    pixels = st.height * st.width
    planes = C + (S + 3) + 4 + 1        # the render's outputs the losses read
    return Work(parts={
        "activations": (P * ACTIVATION_BYTES, 0, 0),
        "preprocess_fwd": preprocess_work(P, n_sh, K, C, 3),
        "preprocess_bwd": preprocess_work(P, n_sh, K, C, 3, backward=True),
        "composite_fwd": composite_parts(composited, C, S, False),
        "composite_bwd": composite_parts(composited, C, S, True),
        "loss_planes": ((2 * planes + 2) * pixels * 4, 0, 0),
        "adam": ((P * floats_per_gaussian + prior_elements) * ADAM_BYTES,
                 0, 0),
    })
