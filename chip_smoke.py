#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (gslidar_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (sm_90, an H100) and the CUDA toolkit; it builds the
port's kernels from the sources in this checkout and exits non-zero, with
no result line, when there is no card. Each phase prints one line and a
failing phase raises:

1. device: the card's name and power limit (nvidia-smi), torch.version.cuda
   and the compute capability, which must be (9, 0);
2. build: nvcc builds the kernel library (seconds and ptxas's report);
3. kernel vs plain: the forward and the backward compositing kernels
   against their plain PyTorch versions on seeded scenes (a 66x1030 wrap_x
   panorama with splats across the seam, distortion on and off; a 16x16
   tile that walks 12 staging batches, with pixels whose median and 1e-4
   floor fall after the first, which must walk >= 3; a tile of >= 40
   batches that turns opaque within its first 2, where the walk must stop
   after 2; a tile of >= 263 batches, the heaviest 360-degree tile's
   length, walked to its end; the edge-on fixture), the backward with
   seeded random cotangents, the kernel started per chunk from the forward
   kernel's checkpoints and the plain version walking each tile from its
   start; the forward kernel's outputs must be the same bit for bit run
   twice, and with and without its checkpoint buffer, and its checkpoints
   agree with the plain forward's;
4. serving path: a seeded 1,000,000-gaussian model of kitti360_nvs_1908's
   shape (SH degree 3, 66x515 halves rendered as one 66x1030 wrap_x
   panorama) served through ``gslidar_tpu_torch.render.render_scene`` over
   4 front/back camera pairs of the procedural Synthetic scene; the
   forward kernel's launch count must rise once per 360-degree render, and
   one pair's 360 pass is held against the two-half stitch (see
   ``stitch_vs_360`` for why that comparison counts pixels by their
   distance to a tile edge);
5. the forward kernel vs plain at full size on one of those views, timed
   with CUDA events in turns (median of 10 each after warm-up), with the
   whole 360 render, its preprocess and its binning (median of 5), and
   the device time of each of the forward's four passes (product, scan,
   blend, merge; ``torch.profiler``, median of 10 forwards); the walk per
   tile there (instances walked, largest and mean, the heaviest tenth's
   share of the walked pairs, the batches the blend pass walks and the
   tiles hold) and what each compositor and each forward pass takes at
   its launch (registers, shared memory, spills, resident CTAs per SM,
   grid);
6. training path (the main path): ``gslidar_tpu_torch.train.training`` for
   6 steps of the same seeded 1M-gaussian model on the Synthetic scene at
   kitti360_nvs_1908's shape (66x515 half panoramas, its lambdas and
   learning rates); each step must launch the forward and the backward
   kernel exactly once, give a finite loss and finite gradients, and every
   param group with a gradient and a learning rate, and the prior, must
   move; then ``python -m gslidar_tpu_torch.train`` on
   configs/synthetic_smoke.yaml for 5 steps in a subprocess (scene,
   ``create_from_pcd`` and the CLI);
7. one full-size training step (iteration 7001, every loss schedule on,
   densification statistics on): the forward kernel and its checkpoints
   against the plain version, and the backward kernel against its plain
   version, on that step's rows with seeded random cotangents; CUDA-event
   timings (median of 5 after warm-up) of the whole step and of its
   stages (the forward kernel with and without checkpoints, and the
   device time of each of its passes with them, as in phase 5), the
   backward kernel against the plain version (median of 3), and the
   device's idle share over 3 steps from ``torch.profiler``; the walk and the compositors' resources as in
   phase 5;
   with the least-time bounds (``gslidar_tpu_torch.microbench.bounds``)
   of the forward kernel on phase 5's 360-degree view and of both kernels
   on this training view, their walked / needed pair ratios, and the
   pairs the forward's product pass walks;
8. gather path: ``python -m gslidar_tpu_torch.microbench.dma_gather``
   driven in-process at the script's shape (a) [1M, 128] f32 by 2,260,992
   ids and at the binning payload's shape (b) [1M, 18] by 2,662,848 ids
   (its launch count read just after); then the kernel against its plain
   version, bitwise, at both shapes; the kernel and
   ``torch.index_select`` (the plain version) timed in turns (CUDA
   events, median of 10), with GB/s and the bound;
9. op-chain path: ``python -m gslidar_tpu_torch.microbench.vpu_ops``
   driven in-process (its launch count read just after): ns per
   full-block op by slope between 64 and 512 steps, beside the bound of
   one op; then all 8 cases x {float32, bfloat16} against their plain
   versions at 64 steps and at 1 step, where the rolls move the block by
   16 (roll1) or 128 (roll8) rows (at 64 steps by a multiple of 256, so
   a wrong roll would go unseen), the bfloat16 rolls also against
   ``torch.roll`` alone; the plain versions timed; and per chain its
   launch (``kernels.op_chain_resources``: grid, warps per CTA, the
   layout's registers per thread, registers, spills, CTAs per SM, SMs
   reached) and the slope's share of its op bound, chains under half of
   it flagged (a flag does not fail the run);
10. the result: the card's nvidia-smi line, one JSON line of the kernels,
   and the last line ``{"ok": true, "device": {...}}``.

Tolerances, forward kernel vs plain: color, features, normal, alpha and
final T at atol 1e-4; mean depth and sum w*d^2 at rtol 1e-4 + atol 1e-3;
distortion at atol 1e-4. The two run the same IEEE per-pixel arithmetic
and carry T across batches alike (T times the batch's product), but take
the products inside a batch and the channel sums in another order, so a
T_before within rounding of 0.5 (median) or of the 1e-4 floor can flip a
choice: median depth, median position and n_contrib must be equal on
>= 99.9% of pixels, and a pixel whose n_contrib flipped is left out of the
continuous comparisons (its last contribution is in one sum and not the
other). The instances each tile walked (misc slot 5) must be equal on
every tile. Flip counts and maximum errors are printed.

Backward kernel vs plain: per gradient column, the maximum error relative
to the column's largest magnitude must be finite and <= 1e-4, and the
kernel's table finite everywhere. The two walk the same instances with the
same decisions, but the kernel starts each chunk from the forward
kernel's checkpoints, while the plain version carries T and the prefix
sums from the tile's start with cumprod/cumsum and takes its pixel sums
in another order.

Forward checkpoints, kernel vs plain, over every staging batch both walks
took and the pixels whose n_contrib did not flip: T at atol 1e-4; each
running sum within 1e-4 of its field's largest magnitude. The largest T
step between two batches of one tile must exceed the T bar, so that a
checkpoint written to the wrong batch would fail.

Gather kernel vs plain: bitwise equal (a copy). Op chains vs plain
(``vpu_ops.check``): float32 mul, fma, select, roll1 and roll8 bit for
bit on every element (the same IEEE operations: the library is built
with --fmad=false), and float32 div too (the kernel's division is the
correctly rounded quotient, as torch's is); float32 exp and rsqrt within
1e-5 (each side calls its own expf and rsqrtf) and bfloat16 within one
bfloat16 ulp, each on >= 99.9 % of the elements, since a floor that
wraps near 1.0 may flip an element; the bfloat16 rolls vs ``torch.roll``
bit for bit on every element.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# configs/kitti360_nvs_1908.yaml
HW = (66, 515)
VFOV = (-24.9, 2.0)
HFOV = (-90.0, 90.0)
NUM_GAUSSIANS = 1_000_000
SH_DEGREE = 3
N_PAIRS = 4
ATOL = 1e-4
DEPTH_RTOL, DEPTH_ATOL = 1e-4, 1e-3
MAX_FLIP_FRAC = 1e-3
BWD_RTOL = 1e-4           # backward: per column, of its largest magnitude
CKPT_RTOL = 1e-4          # checkpoint sums: per field, of its largest one
TRAIN_STEPS = 6
CLI_STEPS = 5
TIMED_ITERATION = 7001    # every loss schedule on (distortion > 3000,
                          # normal consistency > 7000)
# 360 pass vs two-half stitch (stitch_vs_360): the pixels outside the
# phase-3 tolerances must sit at tile-column edges, where the two layouts
# clip splats differently; a layout fault spreads them over every column
STITCH_EDGE_MARGIN = 3        # px from a tile-column edge
STITCH_MIN_AT_EDGES = 0.95    # of the differing pixels, < MARGIN from one
STITCH_MAX_INTERIOR = 0.01    # of the pixels >= MARGIN from every edge


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


class Args(dict):
    """Attribute-access dict standing in for the YAML config."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k) from None

    def __setattr__(self, k, v):
        self[k] = v


# ---------------------------------------------------------------- phase 1
def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke test runs only on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    say(1, f"device: {smi} | torch {torch.__version__} | cuda "
           f"{torch.version.cuda} | capability {cap} | count "
           f"{torch.cuda.device_count()}")
    if cap != (9, 0):
        raise RuntimeError(f"compute capability {cap}, the kernels are "
                           "built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# ---------------------------------------------------------------- phase 2
def phase_build():
    from gslidar_tpu_torch.kernels import load_library
    lib = load_library()
    report = ""
    log = lib.path[:-3] + ".log"
    if os.path.exists(log):
        with open(log) as f:
            report = " ".join(ln.strip() for ln in f
                              if "registers" in ln or "spill" in ln)
    say(2, f"build: {lib.build_seconds:.1f} s -> "
           f"{os.path.relpath(lib.path, REPO)} | ptxas: {report}")


# ---------------------------------------------------------------- compare
def compare(kern, plain, C, S):
    """Kernel vs plain CompositeOut under the stated tolerances.
    Returns (ok, summary dict)."""
    import torch
    n_pix = kern.misc[0].numel()
    contrib_flip = kern.misc[1] != plain.misc[1]
    med_flip = ((kern.misc[2] != plain.misc[2])
                | (kern.depth[1] != plain.depth[1]))
    walked_diff = kern.misc[5] != plain.misc[5]
    keep = ~contrib_flip

    def err(a, b):
        d = (a - b).abs()
        return float(d[:, keep].max()) if keep.any() else 0.0

    def rel_bad(a, b):
        d = (a - b).abs() - (DEPTH_ATOL + DEPTH_RTOL * b.abs())
        return float(d[keep].max()) if keep.any() else -1.0

    T_k, T_p = kern.misc[0:1], plain.misc[0:1]
    e = dict(
        color=err(kern.color, plain.color),
        feature=err(kern.feature[:S], plain.feature[:S]) if S else 0.0,
        normal=err(kern.feature[S:], plain.feature[S:]),
        alpha=err(1 - T_k, 1 - T_p),
        final_T=err(T_k, T_p),
        distortion=err(kern.depth[2:3], plain.depth[2:3]),
        moments=err(kern.misc[3:5], plain.misc[3:5]),
        wsum=err(kern.misc[6:7], plain.misc[6:7]),
    )
    depth_over = max(rel_bad(kern.depth[0], plain.depth[0]),
                     rel_bad(kern.depth[3], plain.depth[3]))
    raw = float(max((kern.color - plain.color).abs().max(),
                    (kern.feature - plain.feature).abs().max(),
                    (T_k - T_p).abs().max()))
    flips = dict(n_contrib=int(contrib_flip.sum()),
                 median=int(med_flip.sum()), walked=int(walked_diff.sum()))
    finite = all(bool(torch.isfinite(x).all()) for x in kern)
    ok = (finite and all(v <= ATOL for v in e.values()) and depth_over <= 0
          and all(v <= MAX_FLIP_FRAC * n_pix for v in flips.values())
          and flips["walked"] == 0)
    summary = dict(max_err={k: float(f"{v:.3g}") for k, v in e.items()},
                   depth_over_tol=float(f"{depth_over:.3g}"), flips=flips,
                   pixels=n_pix, finite=finite, raw_max_abs_err=raw)
    return ok, summary


def taken_batches(kern, plain, ckpt, settings):
    """The staging batches both walks took, as indices into a checkpoint
    buffer, and their batch number within their tile."""
    import torch
    from gslidar_tpu_torch.raster.composite_bwd import walked_per_tile
    dev = ckpt.state.device
    B = settings.tile_pixels
    walked = torch.minimum(walked_per_tile(kern, settings),
                           walked_per_tile(plain, settings)).long()
    n_b = (walked + B - 1) // B                       # batches per tile
    tile_of = torch.repeat_interleave(
        torch.arange(settings.num_tiles, device=dev), n_b)
    c = (torch.arange(tile_of.numel(), device=dev)
         - (torch.cumsum(n_b, 0) - n_b)[tile_of])
    return ckpt.chunk_off.long()[tile_of] + c, c, tile_of


def compare_checkpoints(kern, plain, kern_ck, plain_ck, settings):
    """The forward kernel's checkpoints against the plain forward's, over
    every staging batch both walks took (the batches the backward starts
    from), leaving out the pixels whose n_contrib flipped (as ``compare``
    does). T at ATOL; every running sum within CKPT_RTOL of its field's
    largest magnitude. A checkpoint of the wrong batch would be off by
    that batch's decay: the largest T step between two batches of one
    tile in the plain walk is printed, and must exceed the T bar wherever
    a tile walks two batches. Returns (ok, summary dict)."""
    import torch
    from gslidar_tpu_torch.raster.composite_bwd import _tile
    taken, c, tile_of = taken_batches(kern, plain, kern_ck, settings)
    keep = _tile((kern.misc[1:2] == plain.misc[1:2]).float(),
                 settings)[:, 0][tile_of][:, None, :] > 0
    k, p = kern_ck.state[taken], plain_ck.state[taken]
    d = torch.where(keep, (k - p).abs(), 0.0).amax((0, 2))    # per field
    T_err = float(d[0])
    sum_rel = float((d[1:] / (p[:, 1:].abs().amax((0, 2))
                              .clamp_min(1e-30))).max())
    nxt = c[1:] == c[:-1] + 1                         # same tile, next batch
    gap = (float((p[1:, 0] - p[:-1, 0])[nxt].abs().max())
           if bool(nxt.any()) else None)
    ok = (bool(torch.isfinite(k).all()) and T_err <= ATOL
          and sum_rel <= CKPT_RTOL and (gap is None or gap > ATOL)
          and torch.equal(kern_ck.chunk_off, plain_ck.chunk_off))
    return ok, dict(batches=int(taken.numel()),
                    T_max_abs_err=float(f"{T_err:.3g}"),
                    sums_max_rel_err=float(f"{sum_rel:.3g}"),
                    next_batch_T_step=(None if gap is None
                                       else float(f"{gap:.3g}")))


def run_pair(rows, tile_starts, params, settings, C, S):
    """Forward kernel vs plain: (ok, summary, the kernel's CompositeOut,
    its checkpoints). The kernel runs twice with the checkpoint buffer and
    once without: all three must give the same bits, and the two buffers
    the same checkpoints; the plain version fills a buffer of its own,
    which the kernel's must agree with (``compare_checkpoints``)."""
    import torch
    from gslidar_tpu_torch.raster.composite_fwd import (
        composite_forward, composite_forward_reference, new_checkpoints)
    ckpt = new_checkpoints(tile_starts, rows.shape[0], settings, C)
    again_ck = new_checkpoints(tile_starts, rows.shape[0], settings, C)
    plain_ck = new_checkpoints(tile_starts, rows.shape[0], settings, C)
    kern = composite_forward(rows, tile_starts, params, settings, C, S, ckpt)
    again = composite_forward(rows, tile_starts, params, settings, C, S,
                              again_ck)
    bare = composite_forward(rows, tile_starts, params, settings, C, S)
    plain = composite_forward_reference(rows, tile_starts, params, settings,
                                        C, S, plain_ck)
    torch.cuda.synchronize()
    ok, summ = compare(kern, plain, C, S)
    same = all(torch.equal(a, b) for a, b in zip(kern, bare))
    taken = taken_batches(kern, kern, ckpt, settings)[0]
    repeats = (all(torch.equal(a, b) for a, b in zip(kern, again))
               and torch.equal(ckpt.state[taken], again_ck.state[taken]))
    summ["checkpoints_leave_outputs_bitwise_equal"] = same
    summ["repeats_bitwise"] = repeats
    ck_ok, summ["checkpoints_vs_plain"] = compare_checkpoints(
        kern, plain, ckpt, plain_ck, settings)
    del plain_ck, again_ck
    return ok and same and repeats and ck_ok, summ, kern, ckpt


def random_cotangents(settings, C, S, seed, device):
    """Seeded N(0, 1) cotangents of color, features, depth and final T."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    H, W = settings.height, settings.width
    return [torch.as_tensor(rng.normal(size=s).astype(np.float32),
                            device=device)
            for s in ((C, H, W), (S + 3, H, W), (4, H, W), (1, H, W))]


def run_bwd_pair(rows, tile_starts, fwd, cts, params, settings, C, S,
                 ckpt):
    """Backward kernel vs plain on the same inputs: (ok, summary). The
    kernel starts each chunk from the forward kernel's checkpoints
    ``ckpt``; the plain version walks each tile from its start, carrying T
    and the prefix from batch to batch, so it does not lean on them. The
    kernel runs twice: its table must repeat bit for bit."""
    import torch
    from gslidar_tpu_torch.raster.composite_bwd import (
        composite_backward, composite_backward_reference)
    with torch.no_grad():
        kern = composite_backward(rows, tile_starts, fwd, cts, params,
                                  settings, C, S, ckpt)
        again = composite_backward(rows, tile_starts, fwd, cts, params,
                                   settings, C, S, ckpt)
        plain = composite_backward_reference(rows, tile_starts, fwd, cts,
                                             params, settings, C, S)
    torch.cuda.synchronize()
    scale = plain.abs().amax(0).clamp_min(1e-30)
    col = ((kern - plain).abs().amax(0) / scale).cpu()
    finite = bool(torch.isfinite(kern).all())
    repeats = bool(torch.equal(kern, again))
    ok = finite and repeats and bool(torch.isfinite(col).all()) and \
        float(col.max()) <= BWD_RTOL
    return ok, dict(
        max_rel_err_per_column=[float(f"{x:.3g}") for x in col.tolist()],
        rows_differing=int((kern != plain).any(1).sum()),
        rows=rows.shape[0], finite=finite, repeats_bitwise=repeats,
        raw_max_abs_err=float((kern - plain).abs().max()))


# ---------------------------------------------------------------- phase 3
def seam_scene(device, n=12000):
    """Splats all around the camera plus a dense cluster straddling the
    phi = +-pi seam, as the 66x1030 panorama sees them."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 3)
    half = n // 2
    phi = np.concatenate([rng.uniform(-np.pi, np.pi, half),
                          np.pi + rng.normal(0, 0.05, n - half)])
    el = np.radians(rng.uniform(-24, 1.5, n))
    r = rng.uniform(4, 40, n)
    means = np.stack([r * np.cos(el) * np.sin(phi), -r * np.sin(el),
                      r * np.cos(el) * np.cos(phi)], 1)
    opac = np.concatenate([rng.uniform(0.2, 0.95, half),
                           rng.uniform(0.6, 0.99, n - half)])
    t = dict(means=means, scales=rng.uniform(0.1, 1.0, (n, 3)),
             quats=rng.normal(size=(n, 4)), opac=opac,
             shs=rng.normal(size=(n, 16, 4)) * 0.2,
             feats=rng.normal(size=(n, 4)))
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in t.items()}


def edge_on_rows(device):
    """The edge-on fixture of tests/test_pallas_interpret.py: splat 0 is
    seen nearly edge-on (p3 ~ 1e-36, s2 overflows to inf), splat 1 is an
    ordinary splat nearer in the same tile. Rows in sorted (depth)
    order: splat 1, then splat 0."""
    import torch
    T = torch.zeros(2, 3, 3)
    T[1] = torch.tensor([[1, 0, 0], [0, 1e-36, 0], [0, -1.43365, 4.79005]])
    T[0] = torch.tensor([[0.5, 0, 0], [0, 0.5, 0], [0, -1.14692, 3.83204]])
    rows = torch.cat([T.transpose(1, 2).reshape(2, 9),
                      torch.full((2, 1), 0.9), torch.full((2, 4), 0.8)], 1)
    return rows.to(device).contiguous()


def deep_tile(device):
    """``gslidar_tpu_torch.raster.scenes.deep_tile_scene``: one 16x16 tile
    walks 12 staging batches, with pixels whose median (T = 0.5) and 1e-4
    floor fall after the first. Both kernels against their plain versions
    there: ((ok, summary), (ok, summary))."""
    import numpy as np
    import torch
    from gslidar_tpu_torch.raster import scenes
    from gslidar_tpu_torch.raster.composite_fwd import make_params
    from gslidar_tpu_torch.raster.settings import RasterSettings
    s = RasterSettings(height=30, width=130, vfov=(-20.0, 20.0),
                       hfov=(-60.0, 60.0), num_extra_features=2)
    sc = {k: torch.as_tensor(v, device=device) for k, v in
          scenes.deep_tile_scene(np.random.default_rng(7)).items()}
    rows, starts = scenes.port_rows(sc, s)
    params = make_params(1.0, s)
    ok, summ, fwd, ckpt = run_pair(rows, starts, params, s, 4, 2)
    walked = fwd.misc[5, ::s.tile_h, ::s.tile_w].reshape(-1).long()
    chunks = ((walked + s.tile_pixels - 1) // s.tile_pixels).tolist()
    t = max(range(len(chunks)), key=chunks.__getitem__)
    ty, tx = divmod(t, s.tiles_x)
    px = (slice(ty * s.tile_h, (ty + 1) * s.tile_h),
          slice(tx * s.tile_w, (tx + 1) * s.tile_w))
    T, n_contrib, med_pos = (fwd.misc[i][px] for i in range(3))
    late = dict(median=int((med_pos > s.tile_pixels).sum()),
                floor=int(((T < 1e-4) & (n_contrib > s.tile_pixels)).sum()))
    say(3, f"deep tile: staging batches walked per tile {chunks} (max "
           f"{chunks[t]}, bar 3); in tile {t}, pixels whose median falls "
           f"after its first batch {late['median']}, whose 1e-4 floor does "
           f"{late['floor']}")
    if chunks[t] < 3 or not all(late.values()):
        raise RuntimeError("the deep-tile scene does not walk past its "
                           "first batch")
    summ["instances"] = rows.shape[0]
    return (ok, summ), run_bwd_pair(
        rows, starts, fwd, random_cotangents(s, 4, 2, SEED + 8, device),
        params, s, 4, 2, ckpt)


def heavy_tile(device, name):
    """One 16x16 tile of a 30x130 panorama that holds many staging
    batches (``gslidar_tpu_torch.raster.scenes``): ``opaque``, >= 40
    batches behind splats that make every pixel opaque within the first 2,
    where the walk must stop after 2; ``long``, >= 263 batches (the
    heaviest tile of a 360-degree view of 1M gaussians), walked to its
    end, so that the scan and the merge cross every one. Both kernels
    against their plain versions there: ((ok, summary), (ok, summary))."""
    import numpy as np
    import torch
    from gslidar_tpu_torch.raster import scenes
    from gslidar_tpu_torch.raster.composite_fwd import make_params
    from gslidar_tpu_torch.raster.settings import RasterSettings
    s = RasterSettings(height=30, width=130, vfov=(-20.0, 20.0),
                       hfov=(-60.0, 60.0), num_extra_features=2)
    scene, seed = {"opaque": (scenes.opaque_front_tile_scene, 11),
                   "long": (scenes.long_tile_scene, 12)}[name]
    sc = {k: torch.as_tensor(v, device=device) for k, v in
          scene(np.random.default_rng(seed)).items()}
    rows, starts = scenes.port_rows(sc, s)
    params = make_params(1.0, s)
    ok, summ, fwd, ckpt = run_pair(rows, starts, params, s, 4, 2)
    counts = (starts[1:] - starts[:-1]).long()
    t = int(counts.argmax())
    B = s.tile_pixels
    n_b = -(-int(counts[t]) // B)
    walked = int(fwd.misc[5, ::s.tile_h, ::s.tile_w].reshape(-1)[t])
    want = ((n_b >= 40 and walked == 2 * B) if name == "opaque"
            else (n_b >= 263 and walked == int(counts[t])))
    say(3, f"{name} tile: tile {t} holds {int(counts[t])} instances, "
           f"{n_b} staging batches; walked {walked} instances "
           f"({-(-walked // B)} batches; the bar: "
           + ("2 of >= 40)" if name == "opaque" else "all of >= 263)"))
    if not want:
        raise RuntimeError(f"the {name} tile scene does not walk as it "
                           "should")
    summ["instances"] = rows.shape[0]
    return (ok, summ), run_bwd_pair(
        rows, starts, fwd, random_cotangents(s, 4, 2, SEED + 10 + seed,
                                             device),
        params, s, 4, 2, ckpt)


def phase_kernel_vs_plain(device):
    import dataclasses
    import torch
    from gslidar_tpu_torch.engine.evaluate import wrap360_settings
    from gslidar_tpu_torch.raster.binning import bin_gaussians
    from gslidar_tpu_torch.raster.composite_fwd import (make_params,
                                                        pack_payload)
    from gslidar_tpu_torch.raster.preprocess import preprocess
    from gslidar_tpu_torch.raster.settings import RasterSettings

    base = wrap360_settings(RasterSettings(height=HW[0], width=HW[1],
                                           vfov=VFOV, hfov=HFOV,
                                           num_extra_features=4))
    sc = seam_scene(device)
    eye = torch.eye(4, device=device)
    results, bwd = {}, {}
    for dist in (True, False):
        s = dataclasses.replace(base, compute_distortion=dist)
        prep = preprocess(sc["means"], sc["scales"], sc["quats"], sc["opac"],
                          sc["shs"], torch.ones_like(sc["opac"], dtype=bool),
                          eye, torch.zeros(3, device=device), SH_DEGREE, 1.0,
                          s)
        b = bin_gaussians(prep.rect_min, prep.rect_max, prep.depth,
                          prep.tiles_touched, 1.0, s,
                          payload=pack_payload(prep, sc["opac"], sc["feats"]))
        rows, params = b.data_rows.contiguous(), make_params(1.0, s)
        ok, summ, fwd, ckpt = run_pair(rows, b.tile_starts, params, s, 4, 4)
        summ["instances"] = b.num_pairs
        name = f"seam_distortion_{'on' if dist else 'off'}"
        results[name] = (ok, summ)
        bwd[name] = run_bwd_pair(rows, b.tile_starts, fwd,
                                 random_cotangents(s, 4, 4, SEED + 5 + dist,
                                                   device), params, s, 4, 4,
                                 ckpt)
    results["deep_tile"], bwd["deep_tile"] = deep_tile(device)
    for name in ("opaque", "long"):
        results[f"{name}_tile"], bwd[f"{name}_tile"] = heavy_tile(device,
                                                                  name)

    es = RasterSettings(height=48, width=96, vfov=(-20.0, 20.0),
                        hfov=(-60.0, 60.0), tile_h=8, tile_w=128)
    starts = torch.zeros(es.num_tiles + 1, dtype=torch.int32, device=device)
    starts[1:] = 2
    rows, params = edge_on_rows(device), make_params(1.0, es)
    ok, summ, fwd, ckpt = run_pair(rows, starts, params, es, 4, 0)
    results["edge_on"] = (ok, summ)
    bwd["edge_on"] = run_bwd_pair(rows, starts, fwd,
                                  random_cotangents(es, 4, 0, SEED + 7,
                                                    device), params, es, 4, 0,
                                  ckpt)
    for kind, res in (("forward", results), ("backward", bwd)):
        for name, (ok, summ) in res.items():
            say(3, f"{kind} kernel vs plain {name}: "
                   f"{'ok' if ok else 'FAIL'} {json.dumps(summ)}")
    if not all(ok for ok, _ in [*results.values(), *bwd.values()]):
        raise RuntimeError("a kernel disagrees with its plain version")
    # the edge-on splat's 1e-36 tangent makes its normal's 1/|u x v| reach
    # 1e15 and its T gradient 1e14 (finite, as in the Pallas kernel): its
    # absolute error is left out of the kernels line, its relative one not
    return (max(s["raw_max_abs_err"] for _, s in results.values()),
            max(s["raw_max_abs_err"] for k, (_, s) in bwd.items()
                if k != "edge_on"))


# ---------------------------------------------------------------- phase 4
def scene_args():
    h, w = HW
    return Args(
        scene_type="Synthetic", seed=SEED, frames=8, hw=[h, w],
        vfov=list(VFOV), hfov=list(HFOV), num_pts=NUM_GAUSSIANS,
        time_duration=[-0.5, 0.5], cam_num=2, eval=True, test_only=False,
        dynamic=False, model_path=os.path.join(REPO, "build", "chip_smoke"),
        resolution=-1, resolution_scales=[1], sh_degree=SH_DEGREE,
        cycle=0.2, velocity_decay=1.0, t_init=0.1, random_init_point=0,
        sky_depth=False, depth_blend_mode=0, median_depth=False,
        white_background=False)


def make_gaussians(points, n, scale_factor, seed):
    """n seeded gaussians in gslidar_tpu's params layout: the scene's
    normalized point cloud resampled to n and jittered by 5 cm, SH degree
    3, opacities in (0.05, 0.9) and extents of 3-30 cm."""
    import numpy as np
    from gslidar_tpu_torch.ops.sh import rgb2sh
    rng = np.random.default_rng(seed)
    f32 = np.float32
    xyz = (points[rng.integers(0, len(points), n)]
           + rng.normal(0, 0.05 * scale_factor, (n, 3))).astype(f32)
    f_dc = np.zeros((n, 1, 4), f32)
    f_dc[:, 0, :3] = rgb2sh(rng.uniform(0, 1, (n, 3)))
    f_dc[:, 0, 3] = rgb2sh(rng.uniform(0.0, 0.2, n))
    opa = rng.uniform(0.05, 0.9, (n, 1))
    return dict(
        xyz=xyz, f_dc=f_dc,
        f_rest=(rng.normal(size=(n, 15, 4)) * 0.05).astype(f32),
        opacity=np.log(opa / (1 - opa)).astype(f32),
        scaling=np.log(rng.uniform(0.03, 0.3, (n, 3))
                       * scale_factor).astype(f32),
        rotation=rng.normal(size=(n, 4)).astype(f32),
        t=np.zeros((n, 1), f32),
        scaling_t=np.full((n, 1), np.log(np.sqrt(0.1)), f32),
        velocity=np.zeros((n, 3), f32),
        intensity=np.full((n, 1), np.log(0.01 / 0.99), f32))


def phase_main_path(device):
    import numpy as np
    import torch
    from gslidar_tpu_torch.models.gaussians import params_from_numpy
    from gslidar_tpu_torch.raster.composite_fwd import composite_forward
    from gslidar_tpu_torch.render import build_scene, render_scene

    args = scene_args()
    os.makedirs(args.model_path, exist_ok=True)
    np.random.seed(SEED)      # the Synthetic loader subsamples with np.random
    t0 = time.perf_counter()
    scene = build_scene(args)
    cams = scene.get_test_cameras(1) + scene.get_train_cameras()
    cams = cams[:2 * N_PAIRS]
    params = params_from_numpy(
        make_gaussians(scene.scene_info.point_cloud[0], NUM_GAUSSIANS,
                       float(args.scale_factor), SEED), device)
    alive = torch.ones(NUM_GAUSSIANS, dtype=torch.bool, device=device)
    rng = np.random.default_rng(SEED + 4)
    prior = torch.as_tensor(
        rng.normal(-2.0, 1.0, (1, HW[0], 2 * HW[1])).astype(np.float32),
        device=device)
    setup_s = time.perf_counter() - t0

    composite_forward.launches = 0
    t0 = time.perf_counter()
    results = render_scene(args, params, alive, prior, cams, device)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = composite_forward.launches

    h, w = HW
    sf = float(args.scale_factor)
    for r in results:
        for k in ("depth", "intensity", "raydrop"):
            if not np.isfinite(r[k]).all():
                raise RuntimeError(f"non-finite {k} for camera "
                                   f"{r['colmap_id']}")
        if r["depth"].shape != (3, h, 2 * w) or \
                r["raydrop"].shape != (1, h, 2 * w):
            raise RuntimeError(f"bad shapes {r['depth'].shape}")
    if launches != len(results):
        raise RuntimeError(f"{launches} kernel launches for "
                           f"{len(results)} 360-degree renders")
    gt = np.concatenate([r["gt_depth"][0] for r in results])
    pred = np.concatenate([r["depth"][1] for r in results])
    hit = gt > 0
    med_err_m = float(np.median(np.abs(pred[hit] - gt[hit]))) / sf
    say(4, f"serving path: {len(results)} 360-degree renders of "
           f"{NUM_GAUSSIANS} gaussians at {h}x{2 * w} | kernel launches "
           f"{launches} | instances per render "
           f"{[r['num_pairs'] for r in results]} | points "
           f"{[len(r['points']) for r in results]} | median |range - GT| "
           f"{med_err_m:.3f} m over {int(hit.sum())} GT pixels (untrained "
           f"gaussians) | set-up {setup_s:.1f} s, renders {wall_s:.2f} s")
    stitch_vs_360(args, params, alive, prior, cams[0], cams[1], results[0])
    return args, params, alive, prior, cams, launches


def tile_edge_distance(w, tile_w):
    """Per panorama column (width 2w), the distance in pixels to the
    nearest tile-column edge of the 360 grid or of either half's grid in
    the stitched layout (breaks 0, w//2, 3w//2, 2w)."""
    import numpy as np
    W2 = 2 * w
    front = np.arange(w // 2, w // 2 + w)
    back = np.concatenate([np.arange(3 * w // 2, W2), np.arange(w // 2)])
    edges = set(range(0, W2, tile_w))
    for cols in (front, back):
        edges |= {int(cols[j]) for j in range(0, w, tile_w)}
        edges.add(int(cols[-1] + 1) % W2)
    c = np.arange(W2)
    return np.min([np.minimum((c - e) % W2, (e - 1 - c) % W2)
                   for e in edges], axis=0)


def stitch_vs_360(args, params, alive, prior, front, back, r360):
    """The 360 pass against the reference's two-half stitch. The halves
    pin the 360 grid's sort-key depth bits, so both sort on the same depth
    buckets and blend ties in the same order. What remains is where the
    two layouts put their tile-column edges: a splat's tile rect comes
    from the 12-sample ring at rho = 9 + 2 ln(op) (and a 1 px low-pass
    disk), which its alpha >= 1/255 support overhangs, so a splat is
    clipped at its rect's edge tile (as in the JAX package and the CUDA
    original), and the layouts clip in other columns. So the pixels
    outside the phase-3 tolerances are counted by their distance to the
    nearest tile edge of either layout: they must lie at the edges, and
    be rare away from them."""
    import dataclasses
    import numpy as np
    import torch
    from gslidar_tpu_torch.engine.evaluate import (make_eval_render,
                                                   render_range_map)
    from gslidar_tpu_torch.render import gaussian_config, raster_settings
    half = raster_settings(args, *HW)
    bits360 = dataclasses.replace(half, width=2 * HW[1]).depth_bits
    settings = dataclasses.replace(half, sort_depth_bits=bits360)
    bg = torch.tensor([0.0, 0.0, 0.0, 1.0], device=alive.device)
    ev = make_eval_render(args, gaussian_config(args), settings, bg)
    depth, inten, raydrop, _, _ = render_range_map(
        args, front, back, ev, params, alive, prior, SH_DEGREE, list(HW))
    over = {
        "depth": (np.abs(depth - r360["depth"])
                  - (DEPTH_ATOL + DEPTH_RTOL * np.abs(depth))),
        "intensity": np.abs(inten - r360["intensity"]) - ATOL,
        # raydrop carries T_fin * bg: the two walks stop on other tile
        # grids, so their final T may differ by up to the 1e-4 floor
        "raydrop": np.abs(raydrop - r360["raydrop"]) - 2 * ATOL,
    }
    dist = tile_edge_distance(HW[1], settings.tile_w)
    interior = dist >= STITCH_EDGE_MARGIN
    bad_in = {k: float(f"{(v[..., interior] > 0).mean():.3g}")
              for k, v in over.items()}
    bad_any = np.any([(v > 0).any(axis=0) for v in over.values()], axis=0)
    by_dist = np.bincount(dist[np.nonzero(bad_any)[1]],
                          minlength=STITCH_EDGE_MARGIN + 1)
    at_edges = float(by_dist[:STITCH_EDGE_MARGIN].sum()
                     / max(by_dist.sum(), 1))
    say(4, f"360 pass vs two-half stitch on camera {front.colmap_id}: "
           f"pixels outside tolerance {float(bad_any.mean()):.3g} of all, "
           f"by px to the nearest tile edge {by_dist.tolist()}; "
           f"{at_edges:.3f} of them < {STITCH_EDGE_MARGIN} px from an edge "
           f"(bar {STITCH_MIN_AT_EDGES}); in the columns >= "
           f"{STITCH_EDGE_MARGIN} px from every edge ({interior.mean():.3f} "
           f"of columns) {bad_in} (bar {STITCH_MAX_INTERIOR})")
    if (at_edges < STITCH_MIN_AT_EDGES
            or max(bad_in.values()) > STITCH_MAX_INTERIOR):
        raise RuntimeError("the 360 pass disagrees with the stitch")


# ---------------------------------------------------------------- phase 5
def phase_full_size(args, params, alive, prior, cam, smi):
    import dataclasses
    import torch
    from gslidar_tpu_torch.engine.evaluate import (make_eval_render360,
                                                   wrap360_settings)
    from gslidar_tpu_torch.engine.train import camera_to_batch
    from gslidar_tpu_torch.microbench.bounds import composite_work
    from gslidar_tpu_torch.microbench.timing import time_ms
    from gslidar_tpu_torch.models import gaussians as G
    from gslidar_tpu_torch.raster.binning import bin_gaussians
    from gslidar_tpu_torch.raster.composite_fwd import (
        composite_forward, composite_forward_reference, make_params,
        pack_payload)
    from gslidar_tpu_torch.raster.preprocess import preprocess
    from gslidar_tpu_torch.render import gaussian_config, raster_settings

    device = alive.device
    cfg = gaussian_config(args)
    batch = camera_to_batch(cam, device)
    h, w = HW
    s = dataclasses.replace(wrap360_settings(raster_settings(args, h, w)),
                            compute_distortion=False)
    sf = float(args.scale_factor)
    with torch.no_grad():
        opacity = G.get_opacity(params)[:, 0]
        means = G.get_xyz_shm(params, batch.timestamp, cfg)
        mask = alive & (opacity > 1.0 / 255.0)
        feats = torch.cat([torch.clamp_max(G.get_scaling_t(params), 2.0),
                           G.get_inst_velocity(params, cfg)], 1)

        def pre():
            return preprocess(means, G.get_scaling(params),
                              params["rotation"], opacity,
                              G.get_features(params), mask, batch.viewmat,
                              batch.campos, SH_DEGREE, sf, s)

        def binning():
            return bin_gaussians(prep.rect_min, prep.rect_max, prep.depth,
                                 prep.tiles_touched, sf, s,
                                 payload=pack_payload(prep, opacity, feats))

        prep = pre()
        b = binning()
        rows, starts = b.data_rows.contiguous(), b.tile_starts
        params8 = make_params(sf, s)
        ok, summ, kout, _ = run_pair(rows, starts, params8, s, 4, 4)
        work = composite_work(kout, s, rows.shape[0], 4, 4,
                              tile_starts=starts)
        del kout
        say_walk(5, "the 360-degree view (the forward without "
                    "checkpoints, as serving runs it)", work, s, starts,
                 4, 4, False)
        say(5, f"kernel vs plain at full size ({b.num_pairs} instances, "
               f"{s.height}x{s.width}): {'ok' if ok else 'FAIL'} "
               f"{json.dumps(summ)}")
        if not ok:
            raise RuntimeError("kernel disagrees with its plain version at "
                               "full size")

        def kern():
            composite_forward(rows, starts, params8, s, 4, 4)

        def plain():
            composite_forward_reference(rows, starts, params8, s, 4, 4)

        ev360 = make_eval_render360(args, cfg, raster_settings(args, h, w),
                                    torch.tensor([0.0, 0.0, 0.0, 1.0],
                                                 device=device))

        def full():
            ev360(params, alive, prior, batch, SH_DEGREE)

        stages = {"plain": plain, "kernel": kern, "render": full,
                  "preprocess": pre, "binning": binning}
        for fn in stages.values():                 # warm-up
            fn()
        ms = {k: [] for k in stages}
        for _ in range(5):                         # in turns
            for k in ("plain", "kernel", "kernel", "plain", "render",
                      "preprocess", "binning"):
                ms[k].append(time_ms(stages[k], device))
        med = {k: statistics.median(v) for k, v in ms.items()}
        passes = forward_pass_ms(kern)
    say(5, f"timing on {smi}: composite kernel {med['kernel']:.3f} ms, "
           f"plain {med['plain']:.3f} ms (median of {len(ms['kernel'])}); "
           f"whole 360 render through the kernel {med['render']:.3f} ms, of "
           f"which preprocess {med['preprocess']:.3f} ms and binning "
           f"{med['binning']:.3f} ms (median of {len(ms['render'])})")
    say_passes(5, smi, passes, med["kernel"])
    return summ["raw_max_abs_err"], med, work


# ---------------------------------------------------------------- phase 6
def train_args(model_path, iterations):
    """kitti360_nvs_1908's run config on the procedural Synthetic scene."""
    from gslidar_tpu_torch.train import load_args
    return load_args(os.path.join(REPO, "configs", "kitti360_nvs_1908.yaml"),
                     os.path.join(REPO, "configs", "base.yaml"),
                     ["scene_type=Synthetic", f"seed={SEED}", "frames=8",
                      f"hw=[{HW[0]},{HW[1]}]", f"num_pts={NUM_GAUSSIANS}",
                      f"model_path={model_path}",
                      f"iterations={iterations}"])


def phase_train(device, init_params):
    """The training path: ``training`` for TRAIN_STEPS steps from the
    seeded 1M-gaussian params, the launch counts set to 0 just before it
    and read just after."""
    import math
    import random
    import numpy as np
    import torch
    from gslidar_tpu_torch.models.gaussians import PARAM_KEYS
    from gslidar_tpu_torch.models.optim import group_lrs
    from gslidar_tpu_torch.raster.composite_bwd import composite_backward
    from gslidar_tpu_torch.raster.composite_fwd import composite_forward
    from gslidar_tpu_torch.train import training

    args = train_args(os.path.join(REPO, "build", "chip_smoke_train"),
                      TRAIN_STEPS)
    random.seed(SEED)           # the loader's pair shuffle
    np.random.seed(SEED)        # and its point subsampling
    counts, grad_seen, finite = [], {}, True

    def on_step(iteration, state, loss, log, grads):
        nonlocal finite
        counts.append((composite_forward.launches,
                       composite_backward.launches, log["num_pairs"]))
        for k, g in grads.items():
            finite = finite and bool(torch.isfinite(g).all())
            grad_seen[k] = grad_seen.get(k, False) or bool(g.any())

    composite_forward.launches = 0
    composite_backward.launches = 0
    t0 = time.perf_counter()
    state, scene, losses = training(args, device, init_params=init_params,
                                    on_step=on_step)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = (composite_forward.launches, composite_backward.launches)

    per_step = [(f1 - f0, b1 - b0) for (f0, b0, _), (f1, b1, _) in
                zip([(0, 0, 0)] + counts[:-1], counts)]
    lrs = group_lrs(args, 1)
    moved = {k: not torch.equal(state.params[k], init_params[k])
             for k in PARAM_KEYS}
    expect = {k: grad_seen[k] and lrs[k] != 0 for k in PARAM_KEYS}
    prior_moved = bool((state.prior != math.log(0.1 / 0.9)).any())
    still = {k: "zero gradient" if not grad_seen[k] else "lr 0"
             for k in PARAM_KEYS if not expect[k]}
    say(6, f"training path: {len(losses)} steps of {NUM_GAUSSIANS} gaussians "
           f"at {HW[0]}x{HW[1]} | launches forward {launches[0]}, backward "
           f"{launches[1]}, per step {per_step} | instances per step "
           f"{[c[2] for c in counts]} | loss {[round(x, 5) for x in losses]}"
           f" | gradients finite {finite} | moved "
           f"{sorted(k for k in moved if moved[k])}, prior {prior_moved}; "
           f"unmoved by the config {still} | {wall_s:.2f} s with set-up")
    # SH degree 0 until sh_increase_interval: f_rest has no gradient yet
    core = ("xyz", "f_dc", "opacity", "scaling", "rotation")
    if (len(losses) != TRAIN_STEPS or any(d != (1, 1) for d in per_step)
            or not all(math.isfinite(x) for x in losses) or not finite
            or moved != expect or not prior_moved
            or not all(expect[k] for k in core)):
        raise RuntimeError("the training path failed its checks")
    return args, scene, launches


def phase_train_cli():
    """``python -m gslidar_tpu_torch.train`` as a user runs it: the scene,
    create_from_pcd and CLI_STEPS steps of configs/synthetic_smoke.yaml."""
    import sys
    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "gslidar_tpu_torch.train", "--config",
           "configs/synthetic_smoke.yaml", f"iterations={CLI_STEPS}",
           f"seed={SEED}",
           f"model_path={os.path.join(REPO, 'build', 'chip_smoke_cli')}"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    last = (r.stdout.strip().splitlines() or [""])[-1]
    say(6, f"training CLI: rc {r.returncode} in {wall_s:.1f} s | {last}")
    if r.returncode != 0 or f"trained {CLI_STEPS} steps" not in last:
        raise RuntimeError(f"the training CLI failed:\n{r.stdout[-2000:]}\n"
                           f"{r.stderr[-3000:]}")


# ---------------------------------------------------------------- phase 7
def device_idle_share(fn, n):
    """Share of the wall time of n runs of fn in which no kernel, copy or
    memset ran on the card (torch.profiler), and the device time by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:                       # union of the device spans
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                (e.time_range.end - e.time_range.start) / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return 1.0 - busy / wall_us, busy / 1e3 / n, wall_us / 1e3 / n, top


def phase_train_step(args, scene, init_params, device, smi):
    """One full-size training step at TIMED_ITERATION: the backward kernel
    vs plain on its rows, then stage timings and the idle share."""
    import statistics
    import torch
    import gslidar_tpu_torch.raster.composite_op as co
    from gslidar_tpu_torch.engine.losses import compute_losses
    from gslidar_tpu_torch.engine.render import render
    from gslidar_tpu_torch.engine.train import (_transmat_for_stats,
                                                camera_to_batch,
                                                init_train_state,
                                                make_train_step)
    from gslidar_tpu_torch.microbench.bounds import composite_work
    from gslidar_tpu_torch.microbench.timing import time_ms
    from gslidar_tpu_torch.models import gaussians as G
    from gslidar_tpu_torch.models.densify import add_densification_stats
    from gslidar_tpu_torch.models.optim import adam_step, group_lrs
    from gslidar_tpu_torch.models.raydrop_prior import (PriorAdam,
                                                        init_raydrop_prior)
    from gslidar_tpu_torch.raster.composite_bwd import (
        composite_backward, composite_backward_reference)
    from gslidar_tpu_torch.raster.composite_fwd import composite_forward
    from gslidar_tpu_torch.raster.rasterize import densify_grads_from_T_tap
    from gslidar_tpu_torch.render import gaussian_config, raster_settings

    h, w = HW
    cfg = gaussian_config(args)
    settings = raster_settings(args, h, w)
    bg = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
    n = init_params["xyz"].shape[0]
    state = init_train_state(init_params, G.GaussianAux.zeros(n, device),
                             init_raydrop_prior(h, w, device))
    batch = camera_to_batch(scene.get_train_cameras()[0], device)
    it, sf = TIMED_ITERATION, float(args.scale_factor)
    step = make_train_step(args, cfg, settings, bg)

    # one step, keeping what its backward kernel and reduction were given
    captured = {}
    bin_orig, bwd_orig = co.bin_gaussians, co.composite_backward

    def bin_keep(*a, **k):
        captured["binning"] = bin_orig(*a, **k)
        return captured["binning"]

    def bwd_keep(*a):
        captured["bwd"] = a
        return bwd_orig(*a)

    co.bin_gaussians, co.composite_backward = bin_keep, bwd_keep
    try:
        _, _, _, grads = step(state, batch, it, SH_DEGREE, 0.0, True)
    finally:
        co.bin_gaussians, co.composite_backward = bin_orig, bwd_orig
    rows, starts, fwd, _, params8, s, C, S, ckpt = captured["bwd"]
    gid = captured["binning"].gid_sorted
    works = {"forward": composite_work(fwd, s, rows.shape[0], C, S,
                                       tile_starts=starts),
             "backward": composite_work(fwd, s, rows.shape[0], C, S,
                                        backward=True)}
    say_walk(7, "the training view (the forward with checkpoints)",
             works["forward"], s, starts, C, S, True)
    ok, summ, _, _ = run_pair(rows, starts, params8, s, C, S)
    say(7, f"forward kernel vs plain at full size ({rows.shape[0]} "
           f"instances, {s.height}x{s.width}): {'ok' if ok else 'FAIL'} "
           f"{json.dumps(summ)}")
    if not ok:
        raise RuntimeError("the forward kernel or its checkpoints disagree "
                           "with the plain version on the training view")
    with torch.no_grad():
        table = composite_backward(*captured["bwd"])
        red = [rows.new_zeros(n, rows.shape[1]).index_add_(0, gid, table)
               for _ in range(2)]
    say(7, f"per-gaussian reduction (index_add_, float atomics) run twice on "
           f"one table: {int((red[0] != red[1]).sum())} of {red[0].numel()} "
           f"entries differ, max {float((red[0] - red[1]).abs().max()):.3g}")
    ok, summ = run_bwd_pair(rows, starts, fwd,
                            random_cotangents(s, C, S, SEED + 9, device),
                            params8, s, C, S, ckpt)
    say(7, f"backward kernel vs plain at full size ({rows.shape[0]} "
           f"instances, {s.height}x{s.width}): {'ok' if ok else 'FAIL'} "
           f"{json.dumps(summ)}")
    if not ok:
        raise RuntimeError("the backward kernel disagrees with its plain "
                           "version at full size")

    # the stages, each alone on the step's own inputs
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in init_params.items()}
    prior = state.prior.detach().requires_grad_(True)
    tap = torch.zeros(n, 3, 3, device=device, requires_grad=True)
    alive = state.aux.alive

    def fwd_render():
        return render(leaves, alive, batch.viewmat, batch.campos,
                      batch.timestamp, batch.towards_idx, prior, bg,
                      SH_DEGREE, sf, cfg, settings, dynamic=False,
                      T_tap=tap)

    pkg = fwd_render()

    def losses():
        return compute_losses(pkg, batch.pts_depth, batch.pts_intensity, it,
                              args, G.get_opacity(leaves)[:, 0],
                              alive.to(torch.float32))[0]

    loss = losses()
    lrs = group_lrs(args, it)
    gtap = torch.zeros(n, 3, 3, device=device)
    stages = {
        "step": lambda: step(state, batch, it, SH_DEGREE, 0.0, True),
        "render": fwd_render,
        "forward kernel": lambda: composite_forward(rows, starts, params8, s,
                                                    C, S),
        "forward kernel with checkpoints": lambda: composite_forward(
            rows, starts, params8, s, C, S, ckpt),
        "losses": losses,
        "backward": lambda: torch.autograd.grad(
            loss, [*leaves.values(), prior, tap], retain_graph=True,
            allow_unused=True),
        "backward kernel": lambda: composite_backward(*captured["bwd"]),
        "reduction": lambda: rows.new_zeros(n, rows.shape[1]).index_add_(
            0, gid, table),
        "adam": lambda: (adam_step(state.params, grads, state.opt, lrs),
                         PriorAdam.step(state.prior, grads["prior"],
                                        state.prior_opt, 0.1)),
        "stats": lambda: add_densification_stats(
            state.aux, densify_grads_from_T_tap(
                gtap, _transmat_for_stats(init_params, batch.viewmat, cfg,
                                          batch.timestamp, 0.0), settings),
            grads["t"], pkg.radii, pkg.visibility),
    }
    with torch.no_grad():
        plain_ms = [time_ms(lambda: composite_backward_reference(
            *captured["bwd"]), device) for _ in range(3)]
    for fn in stages.values():                      # warm-up
        fn()
    torch.cuda.reset_peak_memory_stats()
    ms = {k: [] for k in stages}
    for _ in range(5):
        for k, fn in stages.items():
            ms[k].append(time_ms(fn, device))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    med = {k: statistics.median(v) for k, v in ms.items()}
    med["plain backward"] = statistics.median(plain_ms)
    med["autograd rest"] = (med["backward"] - med["backward kernel"]
                            - med["reduction"])
    passes = forward_pass_ms(stages["forward kernel with checkpoints"])
    idle, busy_ms, wall_ms, top = device_idle_share(stages["step"], 3)
    say(7, f"timing on {smi}, one training step of {n} gaussians "
           f"({rows.shape[0]} instances, {h}x{w}), CUDA events, median of 5: "
           + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items())
           + f" (plain backward: median of 3) | peak memory {peak_gb:.2f} "
           f"GiB")
    say_passes(7, smi, passes, med["forward kernel with checkpoints"])
    say(7, f"torch.profiler over 3 steps: device busy {busy_ms:.3f} ms of "
           f"{wall_ms:.3f} ms per step, idle share {idle:.4f} | by device "
           f"time per step: "
           + ", ".join(f"{k[:60]} {v:.3f} ms" for k, v in top))
    return summ["raw_max_abs_err"], med, works


# ------------------------------------------------------- compositor bounds
def forward_pass_ms(fn, n=10, tries=3):
    """The forward kernel's passes in n calls of fn (one forward each),
    from ``torch.profiler``'s device events over n + 1 calls in one
    session, the first left out (the profiler can miss launches at its
    start): per pass, its device time summed over its launches in one
    forward, median of n, and its launches; and the device span of one
    forward's passes, from the first start to the last end (median of n).
    The session is taken again, up to ``tries`` times, until it holds the
    n forwards' launches whole and in order."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gslidar_tpu_torch.kernels import FWD_PASSES
    from gslidar_tpu_torch.raster.composite_fwd import WINDOW_ENDS
    # one forward's launches: the product and the scan pass once per
    # window of batches, then the blend and the merge
    order = ["product", "scan"] * (len(WINDOW_ENDS) + 1) + ["blend", "merge"]
    k = len(order)
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n + 1):
                fn()
            torch.cuda.synchronize()
        ev = sorted((e.time_range.start, e.time_range.end, p)
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    for p in FWD_PASSES if f"fwd_{p}_kernel" in e.name)
        groups = [ev[len(ev) - (i + 1) * k:len(ev) - i * k]
                  for i in range(n)]
        if len(ev) >= n * k and all([q for _, _, q in g] == order
                                    for g in groups):
            break
    else:
        raise RuntimeError(f"torch.profiler caught {len(ev)} launches of "
                           f"the forward's passes, not the last {n} "
                           f"forwards' {k} each in order")
    ms = {p: statistics.median(sum(b - a for a, b, q in g if q == p) / 1e3
                               for g in groups) for p in FWD_PASSES}
    span = statistics.median((g[-1][1] - g[0][0]) / 1e3 for g in groups)
    return ms, {p: order.count(p) for p in FWD_PASSES}, span


def say_passes(phase, smi, passes, whole_ms):
    ms, launches, span = passes
    say(phase, f"forward passes on {smi}, device time per forward "
               f"(torch.profiler, median of 10): "
               + ", ".join(f"{p} {v:.3f} ms in {launches[p]} launches"
                           for p, v in ms.items())
        + f"; their sum {sum(ms.values()):.3f} ms, their device span "
          f"{span:.3f} ms; the whole forward {whole_ms:.3f} ms by CUDA "
          f"events")


def say_walk(phase, label, work, settings, tile_starts, C, S, checkpoints):
    """The walk per tile on one view, and what each compositor (each pass
    of the forward) takes at its launch there: registers, shared memory,
    spills, resident CTAs per SM, and its grid (the forward's merge with
    the checkpoint stores when ``checkpoints``, else without)."""
    from gslidar_tpu_torch.kernels import COMPOSITORS, kernel_resources
    from gslidar_tpu_torch.raster.composite_fwd import (WINDOW_ENDS,
                                                        chunk_offsets,
                                                        max_chunks)
    res = {k: kernel_resources(k, settings.tile_h, settings.tile_w, C, S,
                               checkpoints)
           for k in COMPOSITORS}
    chunks = max_chunks(int(tile_starts[-1]), settings)
    n = settings.num_tiles
    lens = [b - a for a, b in zip((0,) + WINDOW_ENDS, WINDOW_ENDS)]
    grid = {k: (n if k.endswith(("scan", "merge")) else chunks)
            for k in COMPOSITORS}
    grid["composite_fwd.product"] = (
        f"{' + '.join(f'{n} x {w}' for w in lens)} + {chunks}")
    grid["composite_fwd.scan"] = f"{len(WINDOW_ENDS) + 1} x {n}"
    batches = int(chunk_offsets(tile_starts, settings)[-1])
    say(phase, f"walk on {label}: instances walked per tile max "
               f"{work.tile_walked_max}, mean {work.tile_walked_mean:.1f}; "
               f"the heaviest tenth of the {settings.num_tiles} tiles holds "
               f"{work.heavy_tenth_share:.3f} of the walked pairs; "
               f"{work.walked_chunks} staging batches walked (the blend "
               f"pass and the backward) of {batches} held, "
               f"{work.product_chunks} taken by the product pass | "
               + "; ".join(f"{k}: grid {grid[k]} CTAs of "
                           f"{settings.tile_pixels} threads, "
                           f"{r['registers']} registers/thread, static smem "
                           f"{r['static_smem']} B, dynamic smem "
                           f"{r['dynamic_smem']} B, local {r['local_bytes']} "
                           f"B/thread, {r['ctas_per_sm']} resident CTAs/SM"
                           for k, r in res.items()))
    return res


def say_bounds(phase, label, work, clock_hz, ms):
    b = work.bound(clock_hz)
    say(phase, f"bound of the {label}: {b.ms:.4f} ms, set by {b.by} "
               f"({', '.join(f'{k} {v:.4f}' for k, v in b.terms.items())} "
               f"ms) | kernel {ms:.3f} ms = {ms / b.ms:.1f}x the bound | "
               f"pairs needed {work.needed_pairs}, walked "
               f"{work.walked_pairs}, walked/needed "
               f"{work.walked_over_needed:.3f}"
               + (f", the forward's product pass {work.product_pairs} "
                  f"({work.product_pairs / max(work.walked_pairs, 1):.3f}"
                  f"x the walked)" if work.product_pairs else "")
               + f" | instances needed "
               f"{work.needed_instances}, pixels accepting "
               f"{work.accepting_pixels} | {work.n_bytes} bytes, "
               f"{work.fp32} fp32 ops, {work.mufu} MUFU ops")
    return b


# ---------------------------------------------------------------- phase 8
GATHER_SHAPES = {
    "a": (1_000_000, 128, 17664 * 128),     # the script's own
    "b": (1_000_000, 18, 2_662_848),        # binning's payload, phase 5
}


def phase_gather(device):
    """The gather entry point at shapes (a) and (b), its launches counted;
    then kernel vs plain, bitwise, at both."""
    import torch
    from gslidar_tpu_torch.microbench import dma_gather as dg
    runs = {}
    dg.gather_rows.launches = 0
    for name, (P, D, K) in GATHER_SHAPES.items():
        runs[name] = dg.main(["--device", "cuda", "--rows", str(P),
                              "--width", str(D), "--ids", str(K),
                              "--seed", str(SEED)])
    launches = dg.gather_rows.launches
    err = 0.0
    for name, (P, D, K) in GATHER_SHAPES.items():
        table, ids = dg.make_inputs(P, D, K, SEED, device)
        kern = dg.gather_rows(table, ids)
        plain = dg.gather_rows_reference(table, ids)
        torch.cuda.synchronize()
        equal = bool(torch.equal(kern, plain))
        err = max(err, float((kern - plain).abs().max()))
        r = runs[name]
        b = r["bound"]
        say(8, f"gather ({name}) [{P}, {D}] f32 by {K} ids: kernel vs plain "
               f"{'bitwise equal' if equal else 'DIFFER'} | median of 10: "
               + ", ".join(f"{k} {v:.3f} ms ({r['n_bytes'] / v / 1e6:.1f} "
                           f"GB/s)" for k, v in r["ms"].items())
               + f" | bound {b.ms:.3f} ms ({r['n_bytes']} bytes / 3.35 "
               f"TB/s), kernel at {b.ms / r['ms']['kernel']:.3f} of it")
        del table, ids, kern, plain
        if not (equal and r["bitwise"]):
            raise RuntimeError(f"the gather kernel disagrees at shape {name}")
    torch.cuda.empty_cache()
    say(8, f"gather path: {launches} kernel launches over both shapes")
    if launches == 0:
        raise RuntimeError("the gather path launched no kernel")
    # the plain version is torch.index_select, the library call
    lib = sum(r["ms"]["index_select"] for r in runs.values())
    return dict(launches=launches, max_abs_err=err,
                ms=sum(r["ms"]["kernel"] for r in runs.values()),
                plain_ms=lib, library_ms=lib,
                bound_ms=sum(r["bound"].ms for r in runs.values()))


# ---------------------------------------------------------------- phase 9
def phase_op_chains(device, clock_hz):
    """The op-chain entry point, its launches counted; then each of the 16
    chains against its plain version at 1 and 64 steps (``vpu_ops.check``),
    the plain versions timed, and each chain's launch and share of its op
    bound."""
    import torch
    from gslidar_tpu_torch.microbench import vpu_ops as vo
    from gslidar_tpu_torch.microbench.timing import time_ms
    vo.op_chain.launches = 0
    rows = vo.main(["--device", "cuda"])
    launches = vo.op_chain.launches
    say(9, f"op-chain path: {launches} kernel launches")
    if launches == 0:
        raise RuntimeError("the op-chain path launched no kernel")
    err, plain_ms, bad = 0.0, 0.0, []
    for r in rows:
        x = vo.base_block(device, getattr(torch, r["dtype"]))
        checks = vo.check(x, r["case"])
        torch.cuda.synchronize()
        r["plain_ms"] = time_ms(lambda: vo.op_chain_reference(x, r["case"]),
                                device)
        plain_ms += r["plain_ms"]
        err = max([err] + [c["max_abs"] for c in checks
                           if c["what"].startswith("plain")])
        bad += [(r["case"], r["dtype"], c["what"]) for c in checks
                if not c["ok"]]
        say(9, f"{r['case']:6s} {r['dtype']:8s}: kernel within the bar on "
               + "; ".join(f"{c['agree']:.6f} of elements vs {c['what']} "
                           f"(needs {c['required']}, max abs "
                           f"{c['max_abs']:.3g})" for c in checks)
               + f" | {r['ns_per_op']:.2f} ns per op by slope (bound "
               f"{r['op_bound_ns']:.2f} ns), chain of 64 steps "
               f"{r['ms']:.4f} ms (bound {r['bound'].ms:.4f} ms, plain "
               f"{r['plain_ms']:.2f} ms)")
    under = []
    for r in rows:
        res = vo.launch_info(r["case"], getattr(torch, r["dtype"]))
        share = r["op_bound_ns"] / r["ns_per_op"]
        # the launch, the host's enqueue and the block in and out
        fixed = r["ms"] - vo.STEPS * r["ops"] * r["ns_per_op"] * 1e-6
        if share < 0.5:
            under.append(f"{r['case']} {r['dtype']}")
        say(9, f"{r['case']:6s} {r['dtype']:8s}: grid {res['grid']} x "
               f"{res['cta_warps']} warps, {res['regs_per_thread']} chain "
               f"registers per thread, {res['registers']} registers, "
               f"{res['local_bytes']} B spilled, {res['ctas_per_sm']} "
               f"CTAs/SM, {res['sms']} SMs | share of the op bound "
               f"{share:.2f}" + ("  << under half" if share < 0.5 else "")
               + f" | fixed part of the 64-step chain {fixed:.4f} ms")
    say(9, f"chains under half of their op bound: "
           f"{', '.join(under) if under else 'none'}")
    f32_exp = next(r for r in rows
                   if r["case"] == "exp" and r["dtype"] == "float32")
    say(9, f"MUFU check: the bound assumes 16 per clock per SM at "
           f"{clock_hz / 1e6:.0f} MHz, {f32_exp['op_bound_ns']:.2f} ns per "
           f"float32 full-block op; measured by slope: "
           + ", ".join(f"{r['case']} {r['dtype']} {r['ns_per_op']:.2f} ns"
                       for r in rows if r["case"] in ("exp", "div", "rsqrt")))
    if bad:
        raise RuntimeError(f"op chains disagree with their plain versions: "
                           f"{bad}")
    return dict(launches=launches, max_abs_err=err,
                ms=sum(r["ms"] for r in rows), plain_ms=plain_ms,
                library_ms=None,
                bound_ms=sum(r["bound"].ms for r in rows))


def main():
    smi = phase_device()
    import torch
    from gslidar_tpu_torch.microbench.bounds import max_sm_clock_hz
    device = torch.device("cuda", 0)
    clock_hz = max_sm_clock_hz()
    phase_build()
    err3, err3b = phase_kernel_vs_plain(device)
    args, params, alive, prior, cams, _ = phase_main_path(device)
    err5, med, work5 = phase_full_size(args, params, alive, prior, cams[0],
                                       smi)
    targs, scene, launches = phase_train(device, params)
    phase_train_cli()
    err7, med7, works7 = phase_train_step(targs, scene, params, device, smi)
    bound_fwd = say_bounds(7, "forward kernel on phase 5's 360-degree view",
                           work5, clock_hz, med["kernel"])
    say_bounds(7, "forward kernel on the training view", works7["forward"],
               clock_hz, med7["forward kernel"])
    bound_bwd = say_bounds(7, "backward kernel on the training view",
                           works7["backward"], clock_hz,
                           med7["backward kernel"])
    del params, alive, prior, cams, scene
    torch.cuda.empty_cache()
    gather = phase_gather(device)
    chains = phase_op_chains(device, clock_hz)
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "composite_fwd", "route": "cuda",
        "source": "gslidar_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "gslidar_tpu/raster/pallas_fwd.py:282",
        "launches": launches[0], "max_abs_err": max(err3, err5),
        "ms": med["kernel"], "plain_ms": med["plain"],
        "bound_ms": bound_fwd.ms, "bound_by": bound_fwd.bound_by,
        "library_ms": None}, {
        "name": "composite_bwd", "route": "cuda",
        "source": "gslidar_tpu_torch/csrc/composite_bwd.cu",
        "replaces": "gslidar_tpu/raster/pallas_bwd.py:66",
        "launches": launches[1], "max_abs_err": max(err3b, err7),
        "ms": med7["backward kernel"],
        "plain_ms": med7["plain backward"],
        "bound_ms": bound_bwd.ms, "bound_by": bound_bwd.bound_by,
        "library_ms": None}, {
        "name": "gather_rows", "route": "cuda",
        "source": "gslidar_tpu_torch/csrc/gather_rows.cu",
        "replaces": "scripts/microbench_dma_gather.py:88",
        "bound_by": "bytes", **gather}, {
        "name": "op_chain", "route": "cuda",
        "source": "gslidar_tpu_torch/csrc/op_chain.cu",
        "replaces": "scripts/microbench_vpu_ops.py:43",
        "bound_by": "operations", **chains}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
