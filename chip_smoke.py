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
   agree with the plain forward's; then the preprocess kernels against
   their plain versions (``preprocess_fixtures``): the forward on every
   field and the backward with seeded cotangents, on the seam scene
   (SH degree 3, tight rects), again with square rects, SH degree 1 and
   a scale modifier, as an hfov slice with the colors given and [P, 2]
   scales with a row stride, on the degenerate fixtures (centres on the
   camera's axis, with tangents of 1e-12, exactly on the seam, zero
   quaternions, at the camera) and on the deep tile's scene;
4. serving path: a seeded 1,000,000-gaussian model of kitti360_nvs_1908's
   shape (SH degree 3, 66x515 halves rendered as one 66x1030 wrap_x
   panorama) served through ``gslidar_tpu_torch.render.render_scene`` over
   4 front/back camera pairs of the procedural Synthetic scene; the
   forward compositor's and the preprocess's launch counts must each rise
   once per 360-degree render, and
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
   grid); then the preprocess kernels against their plain versions at
   full size, and the render through them against the render through
   the plain preprocess (``render_vs_plain_preprocess``:
   ``measure_tight_rects``' bars, the two renders and their stages timed
   in turns, each render's idle share and top device ops);
6. training path (the main path): ``gslidar_tpu_torch.train.training`` for
   6 steps of the same seeded 1M-gaussian model on the Synthetic scene at
   kitti360_nvs_1908's shape (66x515 half panoramas, its lambdas and
   learning rates); each step must launch the forward and the backward
   compositor, the preprocess and the chamfer kernels exactly
   once each (``launch_counts``), give a finite loss and finite
   gradients, and every
   param group with a gradient and a learning rate, and the prior, must
   move (the loop's depth-visualization renders are counted apart); then
   ``python -m gslidar_tpu_torch.train`` on configs/synthetic_smoke.yaml
   for 110 steps in a subprocess (scene, ``create_from_pcd``, the CLI, its
   densify at 100, its checkpoint, final eval and ray-drop datasets at
   110, 60 refine epochs and refine_test), read from its log.txt, with
   eval/test_110_render/metrics.json, ckpt/refine.npz and
   eval/test_refine_render/metrics.json written;
7. one full-size training step (iteration 7001, every loss schedule on,
   densification statistics on): the forward kernel and its checkpoints
   against the plain version, and the backward kernel against its plain
   version, on that step's rows with seeded random cotangents; CUDA-event
   timings (median of 5 after warm-up) of the whole step and of its
   stages (the forward kernel with and without checkpoints, and the
   device time of each of its passes with them, as in phase 5), the
   backward kernel against the plain version (median of 3), and the
   device's idle share over 3 steps from ``torch.profiler``; the walk and the compositors' resources as in
   phase 5; the preprocess kernels on the step's own inputs against
   their plain versions, the backward also on the step's own cotangents,
   and both timed beside their plain versions (median of 3);
   with the least-time bounds (``gslidar_tpu_torch.microbench.bounds``)
   of the forward kernel on phase 5's 360-degree view and of both kernels
   on this training view, their walked / needed pair ratios, and the
   pairs the forward's product pass walks; and of the preprocess
   forward on phase 5's view and its backward on this step;
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
10. training with densification: ``training`` for 16 steps of the same
   seeded 1M-gaussian model at kitti360_nvs_1908's widths and thresholds,
   only the cadence overridden (``DENSIFY_RUN``): the events that fire
   must be exactly ``gslidar_tpu_torch.train.schedule``'s for the counts
   observed, with the densify at 8 (after the time-split flip there), the
   reset at 6 and the prior's rescale at 10 among them; each step launches
   the forward and the backward kernel once, with a finite loss and
   gradients; after each reset opacity <= init_opacity + 1e-6 and its
   moments are 0; after each densify the aux accumulators and the new
   rows' moments are 0 and the printed counts add up; the step after the
   densify at 8 holds both kernels against their plain versions at phase
   7's bars; chkpnt12 and chkpnt16 are written, and a resume from
   chkpnt12 to 14 loads every leaf bit for bit as saved and takes 2 steps;
   each run ends in its final eval (``complete_eval`` at the last
   iteration, which ``load_args`` appends to test_iterations), at 16 and
   at the resume's 14. It prints each densify's counts and time (CUDA
   events), the median step time between densifies, the checkpoints' size
   and save and load seconds, the evals' seconds and the peak memory;
11. eval and refine at full width, on phase 4's seeded 1M-gaussian model
   over the Synthetic scene's 2 test and 6 train pairs (66x1030
   panoramas): ``complete_eval(is_final=True, save_raydrop_data=True)``
   through ``make_eval_render360`` must launch the forward kernel once
   per pair, hold the first eval render's forward kernel against its
   plain version at phase 3's bars, write the 8 + 6 + 2 ray-drop arrays
   and metrics.json files whose values are finite, LPIPS null; a second
   eval of the test pairs with seeded random LPIPS weights under
   GSLIDAR_LPIPS_WEIGHTS, where LPIPS on the card must equal the same call
   on the CPU within 1e-4 relative; ``refine`` for kitti360_nvs_1908's
   refine_epochs (1000) on the 6 train renders, whose loss must be finite
   and lower at the last print than at the first and whose every epoch
   launches each BatchNorm kernel pair 18 times (the counters set to 0
   just before it), the U-Net's eval-mode
   forward on the card within 1e-4 absolute of the CPU's; ``refine_test``.
   It prints per pair the ms of the render, ``_depth3``, the host copies,
   each meter and the chamfer, the eval's seconds, ms per refine epoch
   (CUDA events), the refine and refine_test seconds and the peak memory;
12. a dynamic, multi-vehicle scene at full width: a synthetic OPV2V tree
   (``gslidar_tpu_torch.data.opv2v_tree``: 3 vehicles x 17 frames of 128
   x 2048 rays over opv2v_dynamic_2's vfov, ~7.7M points) preprocessed by
   ``data.preprocess.opv2v_to_gs``, then ``training`` on
   configs/opv2v_dynamic_2.yaml for 16 steps with only the paths and the
   cadence overridden (``OPV2V_RUN``: densify at 8 and 12, resets at 6
   and 12, checkpoints at 12 and 16, the time-split flip at 15): the
   loader keeps 3,000,000 points and ``create_from_pcd`` makes 3,000,000
   gaussians (SH degree 3, 66x515 halves, every lambda as configured);
   each step launches the forward and the backward kernel once, with a
   finite loss and gradients, and a nonzero self-supervision time shift
   on at least one step; the velocity, t and scaling_t groups move; the
   events are exactly ``schedule``'s; the step after the first densify
   holds both kernels against their plain versions at phase 7's bars;
   chkpnt12 reloads every leaf bit for bit; the final eval (3 test and
   48 train pairs) writes finite metrics. The live viewer is on: from a
   client thread started in step 5's hook, ``/pause``, a full, a preview
   and a full ``/render`` (PNGs of h x w and half of it, one forward
   launch each), ``/pause`` again and ``/stats``. It prints the tree's and the
   scene's sizes and seconds, ``create_from_pcd``'s seconds with its 3-NN
   apart, the instances per step, the median step time between
   densifies, each densify's counts and time, the checkpoints' size and
   save and load seconds, the eval's seconds, the viewer's ms per render
   and the peak memory by stage;
13. the multi-GPU path (``gslidar_tpu_torch.parallel``), on phase 4's
   seeded 1M-gaussian model at kitti360_nvs_1908's widths: (a) a
   world-size-1 NCCL group on the card (no fallback to gloo); (b)
   ``training`` with data_parallel=true and 4 cameras per step for 10
   steps (``DP_RUN``: DENSIFY_RUN's cadence, a densify at 8, the final
   eval and checkpoint at 10): each step launches the forward and the
   backward kernel 4 times each and runs 2 all-reduces, with a finite loss
   and gradients, and the param groups with a gradient and a learning
   rate move; then one DP step of 4 cameras against 4 sequential
   single-camera steps from one state (the prior frozen, statistics on):
   ``denom`` and ``max_radii2D`` equal, the accumulators and each group's
   gradient against the sequential mean within ``DP_RTOL`` by norm;
   camera 0's forward and backward kernels against their plain versions
   at phase 7's bars; the DP step and a single-camera step timed in turns
   (CUDA events, median of 10) and the DP step's peak memory; (c)
   ``python -m torch.distributed.run --nproc_per_node=1 -m
   gslidar_tpu_torch.train`` on configs/synthetic_smoke.yaml with
   data_parallel=true and 2 cameras per step for 12 steps (a densify at
   8, the checkpoint and final eval at 12), its log.txt showing the
   ``[data_parallel] ... (nccl)`` line; (d) the hfov-sliced and SH-sharded
   renders at n = 2 on the 66x1030 panorama and the gaussian-sharded
   render at n = 4 on a 66x1024 one (1030 has no 4 slices of whole
   16-pixel tile columns), each through the loopback (all n slices on
   this card) and through the NCCL group (n = 1), against the unsliced
   render of the same settings: the gaussian-sharded render at the JAX
   test's bars (mean |d| < 2e-4, its 99.9th percentile < 5e-3, both times
   1 + the reference's mean magnitude), the other two, whose 515-column
   slices leave the unsliced tile grid, at its mean bar, and at its tail
   bar and phase 4's interior bar on the columns >= 3 px from every
   tile-column edge of either layout (the seam is one); the forward
   kernel's launches rise by n per render,
   the gaussian-sharded render drops no instance and prints its records
   and instances per slice; each render's last slice's forward (by the
   seam) against its plain version; each slice's stages and the unsliced
   renders timed (CUDA events, median of 5);
14. KITTI-360 from its raw tree (``data/kitti360_tree.py`` at 120,000
   returns per sweep, ``data/preprocess/kitti360_to_gs``, ``data/
   kitti360.py``): (c) kitti360_nvs_10750 at full width (51 sweeps, 6.1M
   points, the 3,000,000 gaussians of ``create_from_pcd``) through
   ``training`` for 48 steps (``K10750_RUN``: only the cadence and two
   thresholds it forces overridden, see there), grown by densify to
   >= 9,500,000 alive gaussians toward the config's 10,000,000 cap: the
   events are exactly ``schedule``'s, each step launches the forward and
   the backward kernel once with a finite loss and gradients, both
   kernels are held against their plain versions at phase 7's bars on
   step 7 (3M gaussians, 66x515) and on the first step at the cap; the
   checkpoint at the cap reloads bit for bit, the final eval (4 test + 47
   train pairs) writes finite metrics, a 360-degree render at the cap
   launches the forward once; (a) on 2,048 of the scene's gaussians in a
   test camera's 66x515 view, the gradients for xyz, scaling, rotation,
   opacity and SH through ``rasterize`` (both CUDA compositors) against
   the dense oracle's autograd (``raster/oracle.py``) on the card, within
   ``ORACLE_RTOL`` of each tensor's largest magnitude (tests/
   test_raster.py's bar), the first check of the backward kernel that
   shares none of its tiling; (b) kitti360_nvs_1908 (64 sweeps, 7.7M
   points, num_pts 1,000,000) through ``kitti360_to_gs`` and ``python -m
   gslidar_tpu_torch.train`` in subprocesses (``K1908_RUN``: cadence and
   refine epochs cut), to its final eval's metrics.json, refine and
   refine_test; (d) ``python -m gslidar_tpu_torch.scripts.
   compare_2dgs_3dgs`` on the card, its two PNGs. It prints the seconds of
   the trees, the converter, the loader, the scene, create_from_pcd and
   the CLI, the step time at 3M and at the cap (CUDA events, median), each
   densify's counts and time, the checkpoint's bytes and its save and
   load seconds, the eval's seconds, the 360-degree render's time, the
   instances per step and the peak memory by stage;
15. the measurement entry points at full width: the forward kernel
   against its plain version on ``gslidar_tpu_torch.bench.build_scene``'s
   1,000,000 gaussians rendered as the bench's 66x1030 wrap_x panorama
   (16x16 tiles, as serving runs it), the preprocess kernels and the
   render through them against the plain versions on that scene at
   1,000,000 and at 10,000,000 gaussians as in phase 5, and both
   compositors on one step of
   ``scripts.bench_train_step``'s 1M-gaussian model at 66x515
   (``check_step_kernels``, phase 7's bars); then, the launch counts set
   to 0, ``python -m gslidar_tpu_torch.bench`` in a subprocess at
   1,000,000 and at 10,000,000 gaussians (its last line must be one JSON
   object with ``metric``, ``value`` > 0, ``unit``, ``vs_baseline`` and
   ``backend``, and it must launch the forward compositor and the
   preprocess once per render),
   and in this process ``bench_train_step`` at 1M, ``profile_render
   --tiles 16x16 8x32 16x32 32x32 --trace``, ``profile_train_step
   --trace``, ``tile_stats`` and ``measure_tight_rects`` (whose render
   with tight rects must meet tests/test_raster.py's bars against the one
   without). It prints renders/s at 1M and 10M, the step's ms and idle
   share, each stage's ms, the per-tile statistics and the bench path's
   launches;
16. the chamfer kernel pair (``ops/chamfer.py``, ``csrc/chamfer.cu``) on
   a training step's two 66x515 panorama clouds, ~10 % of each invalid
   (``chamfer_clouds``): the forward and the backward kernel, the whole
   op forward and backward (with its means) and the plain version's
   forward and backward timed in turns (CUDA events, median of 10 each),
   beside each kernel's ``chamfer_bound``; the op's distances within 4
   ulps of the plain version's on all but 0.1 % of the points (a
   near-tie's pick may differ) and never farther, its means within 1e-6,
   and its gradient rows within 1e-5 of the largest on all but 0.1 % of
   the points; one launch of each kernel per op call (``run_chamfer``);
17. the Adam kernel (``models/optim.py::adam_step``, ``csrc/adam.cu``) at
   both train cells' 1,000,000 and 10,000,000 gaussians, inputs laid out
   as the step makes them: its new parameters and moments equal to the
   plain version's bit for bit on every element of all ten groups, one
   launch a call; the kernel, the plain version and
   ``torch._fused_adam_`` (a library yardstick the port never calls) each
   timed as 10 calls back to back between CUDA events, in turns, median
   of 3, beside ``adam_bound`` (``run_adam``);
18. the refinement U-Net's BatchNorm, ReLU and dropout kernel pairs
   (``models/bn_act.py``, ``csrc/bn_act.cu``) at the shapes the U-Net
   gives them in one training forward at 66x1030 (``bn_act_shapes``: 18,
   with their ReLU and dropout), at B = 60 (the refine cell's batch) and
   B = 6 (phase 11's): the keep mask and the clip flags bit for bit
   against the plain version's, the output, the saved and running
   statistics within 2e-6 of each tensor's largest element and the
   gradients within 1e-5, one launch each way a call; at B = 60 the
   forward and the backward of kernel and plain version timed per shape
   (CUDA events, ``reps`` calls back to back, median of 3 in turns) and
   summed beside ``bn_act_bound`` (``run_bn_act``);
19. the result: the card's nvidia-smi line, one JSON line of the eleven
   kernels (the compositors, the preprocess pair, the chamfer pair, Adam
   and the BatchNorm pair with their launches on each path), and the
   last line ``{"ok": true, "device": {...}}``.

Wherever a phase counts the compositors' launches it counts the
preprocess and chamfer kernels' too (``launch_counts``) and holds them to
set numbers: one preprocess forward per render, camera, slice, eval pair
and viewer render, one backward per step and DP camera; one chamfer
forward and backward per step and DP camera (and per ``bench_train_step``
step in phase 15), a forward per eval pair's PointsMeter, none per
render. The training phases (6, 10, 12, 13, 14) and ``bench_train_step``
hold each step to one Adam launch (``launches.adam``; ``StepLaunches``),
and phase 11's ``refine`` holds each epoch to 18 launches of each
BatchNorm kernel pair (``launches.bn_act_fwd``, ``launches.bn_act_bwd``),
but a densify iteration's, which applies no update and launches none,
and to two replays of the losses' CUDA graph pair per camera
(``loss_graph.replays``: the forward and the backward), with a capture
per camera only at a step that meets a new resolution
(``loss_graph.captures``: the resolutions times the cameras a step renders;
each path starts from no capture).

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

Preprocess kernels vs plain (``compare_prep``, ``compare_prep_grads``):
the forward's float fields (T, xy, depth, normal, color) within 1e-6 of
each field's largest magnitude; its integer fields (the ceiled radius,
the rects, the tile count, valid) equal, but on at most 1e-4 of the
gaussians, each of which must have an argument of one of its integer
decisions within 1e-3 of where it flips (the plain version's ``edges``:
the kernel runs the plain version's IEEE operations in its order, but
atan2f, logf and sqrtf are its own); the backward, given the kernel
forward's clamp mask on both sides, within 1e-5 of each gradient
column's largest magnitude, and the same bits run twice. The render
through the kernels against the render through the plain preprocess at
``scripts/measure_tight_rects.py``'s bars.

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

from gslidar_tpu_torch.microbench.timing import (card, cuda_timed,
                                                 device_idle_share,
                                                 forward_pass_ms)

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
CLI_STEPS = 110           # configs/synthetic_smoke.yaml densifies at 100
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


# the counters of ``launch_counts``, in its order
LAUNCH_COUNTERS = ("launches.composite_fwd", "launches.composite_bwd",
                   "launches.preprocess_fwd", "launches.preprocess_bwd",
                   "launches.chamfer_fwd", "launches.chamfer_bwd")
# one training step's: one of each
ONE_STEP = (1,) * len(LAUNCH_COUNTERS)


def launch_counts():
    """The kernel launches counted so far: (compositor forward, compositor
    backward, preprocess forward, preprocess backward, chamfer forward,
    chamfer backward)."""
    from gslidar_tpu_torch.utils.trace import counters
    c = counters()
    return tuple(c.get(k, 0) for k in LAUNCH_COUNTERS)


def set_launch_counts(counts=(0,) * len(LAUNCH_COUNTERS)):
    """Set the six counts of ``launch_counts`` (0 by default)."""
    from gslidar_tpu_torch.utils.trace import count
    for k, want, now in zip(LAUNCH_COUNTERS, counts, launch_counts()):
        count(k, want - now)


# one render without a gradient: one forward of the compositor and one of
# the preprocess (``launch_counts``)
ONE_RENDER = [1, 0, 1, 0, 0, 0]


def launches_text(counts):
    """The six counts of ``launch_counts`` in words."""
    return (f"compositor forward {counts[0]}, backward {counts[1]}, "
            f"preprocess forward {counts[2]}, backward {counts[3]}, "
            f"chamfer forward {counts[4]}, backward {counts[5]}")


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
    smi = card(torch.device("cuda", 0))
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


def check_step_kernels(phase, label, bwd_args, seed):
    """A training step's forward (with checkpoints) and backward kernels
    against their plain versions at phase 7's bars, on the arguments
    ``bwd_args`` its backward was called with; the launches of this
    comparison are not the run's. Returns (the kinds that failed, the
    forward's and the backward's largest absolute errors)."""
    saved = launch_counts()
    rows, starts, fwd, _, params8, st, C, S, ckpt = bwd_args
    ok_f, summ_f, _, _ = run_pair(rows, starts, params8, st, C, S)
    ok_b, summ_b = run_bwd_pair(rows, starts, fwd,
                                random_cotangents(st, C, S, seed,
                                                  rows.device),
                                params8, st, C, S, ckpt)
    set_launch_counts(saved)
    failed = []
    for kind, ok, summ in (("forward", ok_f, summ_f),
                           ("backward", ok_b, summ_b)):
        say(phase, f"{kind} kernel vs plain {label} ({rows.shape[0]} "
                   f"instances): {'ok' if ok else 'FAIL'} "
                   f"{json.dumps(summ)}")
        if not ok:
            failed.append(kind)
    return failed, summ_f["raw_max_abs_err"], summ_b["raw_max_abs_err"]


# ------------------------------------------------------ preprocess checks
PREP_RTOL = 1e-6          # preprocess forward kernel vs plain: each float
                          # field, of its largest magnitude
PREP_BWD_RTOL = 1e-5      # backward: each gradient column, of its largest
PREP_MAX_DIFF = 1e-4      # the share of gaussians whose integer fields may
                          # differ, each only where one of its decisions'
PREP_EDGE = 1e-3          # arguments lies this close to where it flips
PREP_FLOATS = ("T", "xy", "depth", "normal", "color")
PREP_INTS = ("radius", "rect_min", "rect_max", "tiles_touched", "valid")


def prep_inputs(means, scales, quats, opacity, shs, mask, viewmat, campos,
                sh_degree, scale_factor, settings, scale_modifier=1.0,
                colors=None, angle_bounds=None, cull_bounds=None):
    """The preprocess pass's arguments as one dict (``run_prep_pair``)."""
    return dict(means=means, scales=scales, quats=quats, opacity=opacity,
                shs=None if colors is not None else shs, mask=mask,
                viewmat=viewmat, campos=campos, colors=colors,
                sh_degree=sh_degree, scale_factor=scale_factor,
                settings=settings, scale_modifier=scale_modifier,
                angle_bounds=angle_bounds, cull_bounds=cull_bounds)


def compare_prep(kern, k_clamped, plain, p_clamped, edges):
    """Preprocess forward kernel vs plain: each float field within
    PREP_RTOL of its largest magnitude; the integer fields (the ceiled
    radius, the rects, the tile count, valid) equal but on at most
    PREP_MAX_DIFF of the gaussians, each of which has an argument of its
    integer decisions within PREP_EDGE of where it flips (``edges``, the
    plain version's); the SH clamp masks' differing entries counted.
    Returns (ok, summary dict)."""
    import torch
    rel, raw = {}, 0.0
    for f in PREP_FLOATS:
        a, b = getattr(kern, f), getattr(plain, f)
        d = float((a - b).abs().max()) if a.numel() else 0.0
        rel[f] = d / max(float(b.abs().max()) if b.numel() else 0.0, 1e-30)
        raw = max(raw, d)
    P = kern.valid.shape[0]
    diff = torch.zeros(P, dtype=torch.bool, device=kern.valid.device)
    by_field = {}
    for f in PREP_INTS:
        d = getattr(kern, f) != getattr(plain, f)
        d = d.reshape(P, -1).any(1)
        by_field[f] = int(d.sum())
        diff |= d
    n_diff = int(diff.sum())
    edge = torch.stack(edges).amin(0)[diff]
    far = float(edge.max()) if n_diff else 0.0
    finite = all(bool(torch.isfinite(getattr(kern, f)).all())
                 for f in (*PREP_FLOATS, "radius"))
    ok = (finite and all(v <= PREP_RTOL for v in rel.values())
          and n_diff <= PREP_MAX_DIFF * P and far <= PREP_EDGE)
    return ok, dict(
        gaussians=P, max_rel_err={k: float(f"{v:.3g}")
                                  for k, v in rel.items()},
        integer_fields_differ=by_field, gaussians_differing=n_diff,
        their_distance_to_an_edge=sorted(float(f"{x:.3g}")
                                         for x in edge.tolist())[-8:],
        clamp_entries_differ=(0 if k_clamped is None
                              else int((k_clamped != p_clamped).sum())),
        valid=int(kern.valid.sum()), finite=finite, raw_max_abs_err=raw)


def run_prep_pair(pin, seed):
    """The preprocess kernels against their plain versions on the
    arguments ``pin`` (``prep_inputs``): the forward on every field
    (``compare_prep``), then the backward with seeded N(0, 1) cotangents
    of T and color, both versions given the kernel forward's clamp mask,
    each gradient column within PREP_BWD_RTOL of its largest magnitude and
    the kernel's repeating bit for bit; then the payload layout
    (``prep_layout``), every check bit for bit. Their launches are not
    counted. Returns (ok, forward summary, backward summary)."""
    import torch
    from gslidar_tpu_torch.raster import preprocess as pp
    saved = launch_counts()
    opts = pp._Options(pin["sh_degree"], pin["scale_factor"],
                       pin["settings"], pin["scale_modifier"],
                       pin["angle_bounds"], pin["cull_bounds"])
    head = (pin["means"], pin["scales"], pin["quats"], pin["opacity"],
            pin["shs"])
    view = (pin["viewmat"], pin["campos"])
    edges = []
    with torch.no_grad():
        kern, k_cl = pp._preprocess_kernel(*head, pin["colors"], None,
                                           pin["mask"], *view, opts)
        plain, p_cl = pp._preprocess_plain(
            *head, pin["mask"], *view, opts.sh_degree, opts.scale_factor,
            opts.settings, opts.scale_modifier, pin["colors"],
            opts.angle_bounds, opts.cull_bounds, edges=edges)
        torch.cuda.synchronize()
        ok_f, summ_f = compare_prep(kern, k_cl, plain, p_cl, edges)
        del plain, edges
        P, C = kern.T.shape[0], kern.color.shape[1]
        g = torch.Generator(device=kern.T.device).manual_seed(seed)
        # a payload's gradient rows (S = 4), and its T and colour columns
        gpay = torch.randn(P, 14 + C, generator=g, device=kern.T.device)
        feats = torch.rand(P, 4, generator=g, device=kern.T.device)
        dT, dc = (x.contiguous() for x in pp.payload_views(gpay, C))
        bwd = (*head[:3], pin["shs"], *view, k_cl, dT, dc, opts)
        kb = pp._preprocess_backward_kernel(*bwd)
        again = pp._preprocess_backward_kernel(*bwd)
        pb = pp.preprocess_backward_reference(
            *head[:3], pin["shs"], *view, opts.sh_degree, k_cl, dT, dc,
            opts.scale_modifier)
        layout = prep_layout(pin, opts, kern, k_cl, feats, gpay)
        torch.cuda.synchronize()
    set_launch_counts(saved)
    ok_b, summ_b = compare_prep_grads(kb, pb)
    repeats = all(a is None or torch.equal(pp.sh_rows(a), pp.sh_rows(b))
                  for a, b in zip(kb, again))
    summ_b["repeats_bitwise"] = repeats
    summ_f["payload_layout_bitwise"] = layout
    return (ok_f and ok_b and repeats and all(layout.values()), summ_f,
            summ_b)


def prep_layout(pin, opts, kern, k_clamped, feats, gpay):
    """The preprocess kernels' payload layout on ``pin``, with the SH as
    one tensor and as two blocks: the forward given ``feats`` writes
    ``pack_payload``'s rows of its own separate outputs ``kern`` and the
    same other fields and clamp mask, and the backward reads T's and the
    colour's cotangents in place in the payload gradient ``gpay`` as it
    reads their contiguous copies. Returns {check: bit for bit}."""
    import torch
    from gslidar_tpu_torch.raster import preprocess as pp
    from gslidar_tpu_torch.raster.composite_fwd import pack_payload
    shs = pp.sh_rows(pin["shs"])
    forms = {"one tensor": shs}
    if shs is not None:
        forms["two blocks"] = (shs[:, :1].contiguous(),
                               shs[:, 1:].contiguous())
    want = pack_payload(kern, pin["opacity"], feats)
    dT, dc = pp.payload_views(gpay, kern.color.shape[1])
    got = {}
    for name, sh in forms.items():
        d, d_cl = pp._preprocess_kernel(
            pin["means"], pin["scales"], pin["quats"], pin["opacity"], sh,
            pin["colors"], feats, pin["mask"], pin["viewmat"],
            pin["campos"], opts)
        got[f"forward, SH as {name}"] = bool(
            torch.equal(d.payload, want)
            and all(torch.equal(getattr(d, f), getattr(kern, f))
                    for f in (*PREP_FLOATS, *PREP_INTS))
            and (d_cl is None or torch.equal(d_cl, k_clamped)))
        del d, d_cl
        args = (pin["means"], pin["scales"], pin["quats"], sh,
                pin["viewmat"], pin["campos"], k_clamped)
        a = pp._preprocess_backward_kernel(*args, dT, dc, opts)
        b = pp._preprocess_backward_kernel(*args, dT.contiguous(),
                                           dc.contiguous(), opts)
        got[f"backward in place, SH as {name}"] = all(
            torch.equal(pp.sh_rows(x), pp.sh_rows(y)) for x, y in zip(a, b)
            if x is not None)
    del want
    return got


def compare_prep_grads(kern, plain):
    """Preprocess backward kernel vs plain, (d means, d scales, d quats,
    d SH or None) each: every gradient column within PREP_BWD_RTOL of its
    largest magnitude, and finite. Returns (ok, summary dict)."""
    import torch
    from gslidar_tpu_torch.raster import preprocess as pp
    cols, raw = {}, 0.0
    for name, a, b in zip(("means", "scales", "quats", "shs"), kern, plain):
        if b is None:
            continue
        a, b = pp.sh_rows(a), pp.sh_rows(b)       # the SH's two blocks
        a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
        cols[name] = float(((a - b).abs().amax(0)
                            / b.abs().amax(0).clamp_min(1e-30)).max())
        raw = max(raw, float((a - b).abs().max()))
    finite = all(bool(torch.isfinite(pp.sh_rows(a)).all()) for a in kern
                 if a is not None)
    ok = finite and all(v <= PREP_BWD_RTOL for v in cols.values())
    return ok, dict(max_rel_err_per_column={k: float(f"{v:.3g}")
                                            for k, v in cols.items()},
                    finite=finite, raw_max_abs_err=raw)


def say_prep_pair(phase, label, pin, seed):
    """``run_prep_pair`` on ``pin``, its two summaries printed. Returns
    (ok, the forward's and the backward's largest absolute errors)."""
    ok, summ_f, summ_b = run_prep_pair(pin, seed)
    say(phase, f"preprocess kernels vs plain on {label}: "
               f"{'ok' if ok else 'FAIL'} forward {json.dumps(summ_f)} | "
               f"backward {json.dumps(summ_b)}")
    return ok, summ_f["raw_max_abs_err"], summ_b["raw_max_abs_err"]


def render_vs_plain_preprocess(phase, label, rin, settings, smi, reps=5):
    """One 360-degree render (``rasterize`` under no_grad on ``rin``, its
    arguments before the settings) through the preprocess kernel against
    the same render through the plain preprocess, at
    ``measure_tight_rects``' bars (the rects may differ at a floor's edge,
    which only moves where a saturated tile's walk stops); then the two
    renders and their stages (the preprocess kernel and its plain
    version, the binning, the forward compositor) timed in turns by CUDA
    events (median of ``reps``), and each render's device idle share and
    its top device ops over 3 renders (``torch.profiler``). Launches are
    not counted. Returns (ok, the median ms by stage)."""
    import torch
    import gslidar_tpu_torch.raster.rasterize as rz
    from gslidar_tpu_torch.microbench.timing import time_ms
    from gslidar_tpu_torch.raster import preprocess as pp
    from gslidar_tpu_torch.raster.binning import bin_gaussians
    from gslidar_tpu_torch.raster.composite_fwd import (composite_forward,
                                                        make_params,
                                                        pack_payload)
    from gslidar_tpu_torch.scripts.measure_tight_rects import (
        MEDIAN_DEPTH_FLIP, over_bars, render_differences)
    saved = launch_counts()
    (means, scales, rots, opacity, shs, feats, mask, viewmat, campos, bg,
     deg, sf) = rin
    pargs = (means, scales, rots, opacity, shs, mask, viewmat, campos, deg,
             sf, settings)

    def render():
        with torch.no_grad():
            return rz.rasterize(*rin, settings)

    def render_plain():
        rz.preprocess = pp.preprocess_reference
        try:
            return render()
        finally:
            rz.preprocess = pp.preprocess

    diffs, flips, n_open = render_differences(render(), render_plain())
    over = over_bars(diffs)
    ok = not over and flips < MEDIAN_DEPTH_FLIP
    say(phase, f"{label}: the render through the preprocess kernel vs "
               f"through the plain preprocess ({n_open} of "
               f"{settings.height * settings.width} pixels open): "
               f"{'ok' if ok else 'FAIL'} " + ", ".join(
                   f"{k} bit-identical" if same else
                   f"{k} max |d| {o:.3g} open, {t:.3g} saturated"
                   for k, (same, o, t) in diffs.items())
               + f"; median depth > 1e-3 apart on {flips:.5f} of the "
                 f"pixels; beyond the bars {over}")
    with torch.no_grad():
        prep = pp.preprocess(*pargs)
        b = bin_gaussians(prep.rect_min, prep.rect_max, prep.depth,
                          prep.tiles_touched, sf, settings,
                          payload=pack_payload(prep, opacity, feats))
        rows, starts = b.data_rows.contiguous(), b.tile_starts
        params8 = make_params(sf, settings)
        C, S = prep.color.shape[1], feats.shape[1]
        stages = {
            "render": render, "render with the plain preprocess":
                render_plain,
            "preprocess kernel": lambda: pp.preprocess(*pargs),
            "plain preprocess": lambda: pp.preprocess_reference(*pargs),
            "binning": lambda: bin_gaussians(
                prep.rect_min, prep.rect_max, prep.depth,
                prep.tiles_touched, sf, settings,
                payload=pack_payload(prep, opacity, feats)),
            "compositor": lambda: composite_forward(rows, starts, params8,
                                                    settings, C, S)}
        order = ["render", "render with the plain preprocess",
                 "render with the plain preprocess", "render",
                 "preprocess kernel", "plain preprocess",
                 "plain preprocess", "preprocess kernel", "binning",
                 "compositor"]
        for fn in stages.values():                 # warm-up
            fn()
        ms = {k: [] for k in stages}
        for _ in range(reps):
            for k in order:
                ms[k].append(time_ms(stages[k], means.device))
        med = {k: statistics.median(v) for k, v in ms.items()}
        idle = {k: device_idle_share(stages[k], 3)
                for k in ("render", "render with the plain preprocess")}
    del prep, b, rows
    set_launch_counts(saved)
    say(phase, f"{label} on {smi}, CUDA events, median of {reps} in turns: "
               + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items()))
    for k, (share, busy, wall, top) in idle.items():
        say(phase, f"{label}, {k}: torch.profiler over 3 renders: device "
                   f"busy {busy:.3f} ms of {wall:.3f} ms per render, idle "
                   f"share {share:.4f} | by device time per render: "
                   + ", ".join(f"{n[:60]} {v:.3f} ms" for n, v in top))
        med[f"idle share, {k}"] = share
    return ok, med


class Stages:
    """Host time and peak device memory by stage: ``close(name)`` ends
    the stage since the last close (or ``start``) as ``name``, keeps the
    largest peak over its occurrences in ``peak`` and returns its
    seconds."""

    def __init__(self):
        self.peak = {}
        self.start()

    def start(self):
        import torch
        torch.cuda.reset_peak_memory_stats()
        self.t = time.perf_counter()

    def close(self, name):
        import torch
        torch.cuda.synchronize()
        gib = torch.cuda.max_memory_allocated() / 2 ** 30
        self.peak[name] = max(self.peak.get(name, 0.0), gib)
        seconds = time.perf_counter() - self.t
        self.start()
        return seconds


def states_equal(a, b):
    """Two TrainStates equal bit for bit: params, Adam moments and count,
    aux statistics, the ray-drop prior and its Adam state."""
    import torch
    return (a.opt.count == b.opt.count and a.prior_opt[2] == b.prior_opt[2]
            and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in [
                *((a.params[k], b.params[k]) for k in b.params),
                *((a.opt.mu[k], b.opt.mu[k]) for k in b.params),
                *((a.opt.nu[k], b.opt.nu[k]) for k in b.params),
                *((getattr(a.aux, f), getattr(b.aux, f)) for f in (
                    "alive", "max_radii2D", "xyz_gradient_accum",
                    "xyz_gradient_accum_abs", "t_gradient_accum", "denom")),
                (a.prior, b.prior), (a.prior_opt[0], b.prior_opt[0]),
                (a.prior_opt[1], b.prior_opt[1])]))


def floats(d):
    """Every float in a nested dict (a metrics.json)."""
    for v in d.values():
        if isinstance(v, dict):
            yield from floats(v)
        elif isinstance(v, float):
            yield v


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


def degenerate_scene(device, n=512):
    """seam_scene's splats with fixtures at the preprocess pass's guards:
    centres on the camera's y axis (x = z = 0, the atan2(0, 0) guard),
    there again with tangents of 1e-12 (every sample guarded too), exactly
    on the +-pi seam (x = +0 and -0, z < 0), zero quaternions, and centres
    at the camera itself (range 1e-12, culled)."""
    import torch
    sc = seam_scene(device, n)
    y = torch.linspace(-5.0, 5.0, 32, device=device)
    zero = torch.zeros(32, device=device)
    sc["means"][0:32] = torch.stack([zero, y, zero], 1)
    sc["means"][32:64] = torch.stack([zero, y, zero], 1)
    sc["scales"][32:64] = 1e-12
    sc["means"][64:96] = torch.stack([zero, y, zero - 10.0], 1)
    sc["means"][80:96, 0] = -0.0
    sc["quats"][96:128] = 0.0
    sc["means"][128:160] = 0.0
    return sc


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
    prep_ok, prep_f, prep_b = preprocess_fixtures(device, base)
    if not all(ok for ok, _ in [*results.values(), *bwd.values()]) or \
            not prep_ok:
        raise RuntimeError("a kernel disagrees with its plain version")
    # the edge-on splat's 1e-36 tangent makes its normal's 1/|u x v| reach
    # 1e15 and its T gradient 1e14 (finite, as in the Pallas kernel): its
    # absolute error is left out of the kernels line, its relative one not
    return (max(s["raw_max_abs_err"] for _, s in results.values()),
            max(s["raw_max_abs_err"] for k, (_, s) in bwd.items()
                if k != "edge_on"), prep_f, prep_b)


def preprocess_fixtures(device, base):
    """The preprocess kernels against their plain versions
    (``run_prep_pair``) on seeded scenes that take each option the kernels
    cover: the seam scene in ``base`` (the 66x1030 wrap_x panorama; SH
    degree 3, tight rects), again with square rects, SH degree 1 and a
    scale modifier of 0.7, as an hfov slice (pixel window and cull window
    apart, not circular) with the colors given and the scales a [P, 2]
    view with a row stride, the degenerate fixtures, and the deep tile's
    scene (a 30x130 panorama). Returns (ok, the forward's and the
    backward's largest absolute errors over the scenes, the degenerate
    fixtures' backward left out: its 1/1e-12 terms reach 1e12)."""
    import dataclasses
    import numpy as np
    import torch
    from gslidar_tpu_torch.raster import scenes
    from gslidar_tpu_torch.raster.settings import RasterSettings
    sc = seam_scene(device)
    eye, zero = torch.eye(4, device=device), torch.zeros(3, device=device)
    every = torch.ones_like(sc["opac"], dtype=torch.bool)
    head = (sc["means"], sc["scales"], sc["quats"], sc["opac"], sc["shs"],
            every, eye, zero)
    vmin, vmax, hmin, hmax = base.angle_bounds
    half = 0.5 * (hmax - hmin) / 2
    sub = dataclasses.replace(base, width=base.width // 2, wrap_x=False)
    colors = torch.as_tensor(np.random.default_rng(SEED + 41).uniform(
        0, 1, (sc["means"].shape[0], 4)).astype(np.float32), device=device)
    dg = degenerate_scene(device)
    dt = {k: torch.as_tensor(v, device=device) for k, v in
          scenes.deep_tile_scene(np.random.default_rng(7)).items()}
    cases = {
        "the seam scene": prep_inputs(*head, SH_DEGREE, 1.0, base),
        "the seam scene, square rects, SH degree 1, scale modifier 0.7":
            prep_inputs(*head, 1, 1.0, dataclasses.replace(
                base, tight_rects=False), scale_modifier=0.7),
        "an hfov slice of the seam scene, colors given, [P, 2] scales":
            prep_inputs(sc["means"], sc["scales"][:, :2], *head[2:],
                        SH_DEGREE, 1.0, sub, colors=colors,
                        angle_bounds=(vmin, vmax, -half, half),
                        cull_bounds=(vmin, vmax, hmin + half,
                                     hmax + half)),
        "the degenerate fixtures": prep_inputs(
            dg["means"], dg["scales"], dg["quats"], dg["opac"], dg["shs"],
            every[:dg["means"].shape[0]], eye, zero, SH_DEGREE, 1.0, base),
        "the deep tile's scene": prep_inputs(
            dt["means"], dt["scales"], dt["quats"], dt["opac"], dt["shs"],
            dt["mask"], dt["viewmat"], dt["campos"], SH_DEGREE, 1.0,
            RasterSettings(height=30, width=130, vfov=(-20.0, 20.0),
                           hfov=(-60.0, 60.0), num_extra_features=2)),
    }
    oks, err_f, err_b = [], 0.0, 0.0
    for i, (label, pin) in enumerate(cases.items()):
        ok, ef, eb = say_prep_pair(3, label, pin, SEED + 50 + i)
        oks.append(ok)
        err_f = max(err_f, ef)
        if label != "the degenerate fixtures":
            err_b = max(err_b, eb)
    return all(oks), err_f, err_b


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

    set_launch_counts()
    t0 = time.perf_counter()
    results = render_scene(args, params, alive, prior, cams, device)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()

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
    if launches != (len(results), 0, len(results), 0, 0, 0):
        raise RuntimeError(f"kernel launches {launches_text(launches)} for "
                           f"{len(results)} 360-degree renders")
    gt = np.concatenate([r["gt_depth"][0] for r in results])
    pred = np.concatenate([r["depth"][1] for r in results])
    hit = gt > 0
    med_err_m = float(np.median(np.abs(pred[hit] - gt[hit]))) / sf
    say(4, f"serving path: {len(results)} 360-degree renders of "
           f"{NUM_GAUSSIANS} gaussians at {h}x{2 * w} | kernel launches "
           f"{launches_text(launches)} | instances per render "
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

    # the preprocess kernels at full size, and the render through them
    # against the render through the plain preprocess
    with torch.no_grad():
        rin = (means, G.get_scaling(params), params["rotation"], opacity,
               G.get_features(params), feats, mask, batch.viewmat,
               batch.campos, torch.tensor([0.0, 0.0, 0.0, 1.0],
                                          device=device), SH_DEGREE, sf)
    ok_p, err_pf, err_pb = say_prep_pair(
        5, f"the 360-degree view ({NUM_GAUSSIANS} gaussians)",
        prep_inputs(*rin[:5], *rin[6:9], SH_DEGREE, sf, s), SEED + 60)
    ok_r, med_r = render_vs_plain_preprocess(
        5, f"the 360-degree view of {NUM_GAUSSIANS} gaussians", rin, s, smi)
    if not (ok_p and ok_r):
        raise RuntimeError("the preprocess kernels or the render through "
                           "them disagree with the plain versions at full "
                           "size")
    return summ["raw_max_abs_err"], med, work, dict(
        err_f=err_pf, err_b=err_pb, med=med_r, gaussians=NUM_GAUSSIANS)


# ---------------------------------------------------------------- phase 6
def train_args(model_path, iterations, overrides=()):
    """kitti360_nvs_1908's run config on the procedural Synthetic scene."""
    from gslidar_tpu_torch.train import load_args
    return load_args(os.path.join(REPO, "configs", "kitti360_nvs_1908.yaml"),
                     os.path.join(REPO, "configs", "base.yaml"),
                     ["scene_type=Synthetic", f"seed={SEED}", "frames=8",
                      f"hw=[{HW[0]},{HW[1]}]", f"num_pts={NUM_GAUSSIANS}",
                      f"model_path={model_path}",
                      f"iterations={iterations}", *overrides])


def adam_launches():
    """The Adam kernel's launches counted so far (``launches.adam``)."""
    from gslidar_tpu_torch.utils.trace import counters
    return counters().get("launches.adam", 0)


# the Adam kernel's launches of each training path's steps, for the
# kernels line (each path records ``StepLaunches.held``'s count)
ADAM_BY_PATH = {}
# the BatchNorm kernel pairs' launches (forward, backward) of each path
# that runs them, for the kernels line
BN_ACT_BY_PATH = {}
BN_ACT_COUNTERS = ("launches.bn_act_fwd", "launches.bn_act_bwd")


def bn_act_launches():
    """The BatchNorm kernel pairs' launches counted so far: (forward,
    backward)."""
    from gslidar_tpu_torch.utils.trace import counters
    c = counters()
    return tuple(c.get(k, 0) for k in BN_ACT_COUNTERS)


def set_bn_act_launches(counts=(0, 0)):
    """Set the two counts of ``bn_act_launches`` (0 by default)."""
    from gslidar_tpu_torch.utils.trace import count
    for k, want, now in zip(BN_ACT_COUNTERS, counts, bn_act_launches()):
        count(k, want - now)
# each training path's loss graphs (``StepLaunches.graphs_held``'s
# summary), for the kernels line
GRAPHS_BY_PATH = {}


def graph_counts():
    """The losses' CUDA graph pairs replayed and captured so far
    (``loss_graph.replays``, ``loss_graph.captures``) and the keys they
    were captured under."""
    from gslidar_tpu_torch.engine import loss_graph
    from gslidar_tpu_torch.utils.trace import counters
    c = counters()
    return (c.get("loss_graph.replays", 0), c.get("loss_graph.captures", 0),
            len(loss_graph.captures()))


class StepLaunches:
    """The kernels' launches of each training step (``launch_counts``):
    ``step()`` from the step's ``on_step`` hook, ``skip(name)`` from every
    event hook, whose launches (the loop's depth visualizations) go to
    ``other`` and not to the next step. ``per_step`` lists (compositor
    forward, backward, preprocess forward, backward, chamfer forward,
    backward) per step, ``adam`` the Adam kernel's launches per step;
    ``skip("densify")`` marks the step before it as one that applies no
    update (the loop's densify iterations). ``graphs`` lists the losses'
    graph replays, captures and new capture keys per step; it drops every
    capture first, so that the path's own are counted."""

    def __init__(self):
        from gslidar_tpu_torch.engine import loss_graph
        loss_graph.clear()
        self.last = launch_counts()
        self.last_adam = adam_launches()
        self.last_graph = graph_counts()
        self.per_step, self.adam, self.no_update = [], [], set()
        self.graphs = []
        self.other = (0,) * len(self.last)
        self.other_adam = 0
        self.other_graph = (0, 0, 0)

    def step(self):
        now = launch_counts()
        self.per_step.append(tuple(n - l for n, l in zip(now, self.last)))
        self.last = now
        now = adam_launches()
        self.adam.append(now - self.last_adam)
        self.last_adam = now
        now = graph_counts()
        self.graphs.append(tuple(n - l for n, l in
                                 zip(now, self.last_graph)))
        self.last_graph = now

    def skip(self, name=None):
        now = launch_counts()
        self.other = tuple(o + n - l for o, n, l in
                           zip(self.other, now, self.last))
        self.last = now
        now = adam_launches()
        self.other_adam += now - self.last_adam
        self.last_adam = now
        now = graph_counts()
        self.other_graph = tuple(o + n - l for o, n, l in
                                 zip(self.other_graph, now, self.last_graph))
        self.last_graph = now
        if name == "densify":
            self.no_update.add(len(self.adam) - 1)

    def held(self):
        """(whether each step launched the Adam kernel once, but a step
        that applied no update, which launched none, and no event
        launched it; the steps' Adam launches)."""
        return self.other_adam == 0 and self.adam == [
            int(i not in self.no_update) for i in range(len(self.adam))
        ], sum(self.adam)

    def graphs_held(self, cameras=1):
        """(whether each step replayed the losses' graph pair twice per
        camera and captured ``cameras`` pairs under each key it met first,
        none elsewhere, and no event replayed or captured one; a summary:
        the replays per step, the captures, the keys)."""
        from gslidar_tpu_torch.engine import loss_graph
        ok = (self.other_graph == (0, 0, 0)
              and all(r == 2 * cameras and c == k * cameras
                      for r, c, k in self.graphs)
              and all(n == cameras for n in loss_graph.captures()))
        return ok, {
            "replays_per_step": sorted({r for r, _, _ in self.graphs}),
            "captures": sum(c for _, c, _ in self.graphs),
            "resolutions": sum(k for _, _, k in self.graphs)}


def phase_train(device, init_params):
    """The training path: ``training`` for TRAIN_STEPS steps from the
    seeded 1M-gaussian params, the launch counts set to 0 just before it
    and read just after."""
    import math
    import random
    import shutil
    import numpy as np
    import torch
    from gslidar_tpu_torch.models.gaussians import PARAM_KEYS
    from gslidar_tpu_torch.models.optim import group_lrs
    from gslidar_tpu_torch.train import training

    args = train_args(os.path.join(REPO, "build", "chip_smoke_train"),
                      TRAIN_STEPS)
    random.seed(SEED)           # the loader's pair shuffle
    np.random.seed(SEED)        # and its point subsampling
    counts, grad_seen, finite = [], {}, True

    def on_step(iteration, state, loss, log, grads):
        nonlocal finite
        steps.step()
        counts.append(log["num_pairs"])
        for k, g in grads.items():
            finite = finite and bool(torch.isfinite(g).all())
            grad_seen[k] = grad_seen.get(k, False) or bool(g.any())

    set_launch_counts()
    steps = StepLaunches()
    t0 = time.perf_counter()
    state, scene, losses = training(args, device, init_params=init_params,
                                    on_step=on_step,
                                    on_event=lambda it, name, *a:
                                    steps.skip(name))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()

    per_step = steps.per_step
    lrs = group_lrs(args, 1)
    moved = {k: not torch.equal(state.params[k], init_params[k])
             for k in PARAM_KEYS}
    expect = {k: grad_seen[k] and lrs[k] != 0 for k in PARAM_KEYS}
    prior_moved = bool((state.prior != math.log(0.1 / 0.9)).any())
    still = {k: "zero gradient" if not grad_seen[k] else "lr 0"
             for k in PARAM_KEYS if not expect[k]}
    say(6, f"training path: {len(losses)} steps of {NUM_GAUSSIANS} gaussians "
           f"at {HW[0]}x{HW[1]} | launches {launches_text(launches)}, per "
           f"step {per_step} (and {steps.other[0]} compositor and "
           f"{steps.other[2]} preprocess forwards of the loop's depth "
           f"visualizations and final eval, {steps.other[4]} chamfer "
           f"forwards of its point meters), Adam per step {steps.adam} "
           f"| instances per "
           f"step {counts} | loss {[round(x, 5) for x in losses]}"
           f" | gradients finite {finite} | moved "
           f"{sorted(k for k in moved if moved[k])}, prior {prior_moved}; "
           f"unmoved by the config {still} | {wall_s:.2f} s with set-up")
    # SH degree 0 until sh_increase_interval: f_rest has no gradient yet
    core = ("xyz", "f_dc", "opacity", "scaling", "rotation")
    shutil.rmtree(args.model_path, ignore_errors=True)   # its checkpoint
    adam_ok, ADAM_BY_PATH["training (phase 6)"] = steps.held()
    graph_ok, GRAPHS_BY_PATH["training (phase 6)"] = steps.graphs_held()
    say(6, f"loss graphs: {GRAPHS_BY_PATH['training (phase 6)']}")
    if (len(losses) != TRAIN_STEPS or any(d != ONE_STEP for d in per_step)
            or not adam_ok or not graph_ok
            or not all(math.isfinite(x) for x in losses) or not finite
            or moved != expect or not prior_moved
            or not all(expect[k] for k in core)):
        raise RuntimeError("the training path failed its checks")
    return args, scene, launches


def phase_train_cli():
    """``python -m gslidar_tpu_torch.train`` as a user runs it: the scene,
    create_from_pcd and CLI_STEPS steps of configs/synthetic_smoke.yaml,
    past its densify at 100 to the checkpoint and the final eval at
    CLI_STEPS, then its refine_epochs of refinement and refine_test; the
    log is read from the run's log.txt."""
    import shutil
    import sys
    env = dict(os.environ, PYTHONPATH=REPO)
    run = os.path.join(REPO, "build", "chip_smoke_cli")
    shutil.rmtree(run, ignore_errors=True)
    cmd = [sys.executable, "-m", "gslidar_tpu_torch.train", "--config",
           "configs/synthetic_smoke.yaml", f"iterations={CLI_STEPS}",
           f"seed={SEED}", f"model_path={run}"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    log_path = os.path.join(run, "log.txt")
    lines = [""]
    if os.path.exists(log_path):
        with open(log_path) as f:
            lines = f.read().strip().splitlines() or [""]
    densify = [ln for ln in lines if "] densify:" in ln]
    trained = [ln for ln in lines if ln.startswith("trained ")] or [""]
    evals = [ln for ln in lines if ln.startswith((f"[ITER {CLI_STEPS}] "
                                                  "eval", "[refine]"))]
    refine_loss = [float(ln.split()[-1]) for ln in lines
                   if ln.startswith("refine iter")]
    ckpt = os.path.join(run, "ckpt", f"chkpnt{CLI_STEPS}.npz")
    need = [os.path.join(run, "eval", f"test_{CLI_STEPS}_render",
                         "metrics.json"),
            os.path.join(run, "ckpt", "refine.npz"),
            os.path.join(run, "eval", "test_refine_render", "metrics.json")]
    say(6, f"training CLI: rc {r.returncode} in {wall_s:.1f} s, log in "
           f"log.txt ({len(lines)} lines) | {' | '.join(densify)} | "
           f"{trained[-1]} | checkpoint "
           f"{os.path.getsize(ckpt) if os.path.exists(ckpt) else 'MISSING'}"
           f" bytes | {' | '.join(evals)} | refine loss by 50 epochs "
           f"{refine_loss} | present: "
           f"{[os.path.relpath(q, run) for q in need if os.path.exists(q)]}")
    if (r.returncode != 0 or f"trained {CLI_STEPS} steps" not in trained[-1]
            or not any(ln.startswith("[100] densify:") for ln in densify)
            or not os.path.exists(ckpt)
            or not all(os.path.exists(q) for q in need)
            or "Refine complete." not in lines):
        raise RuntimeError(f"the training CLI failed:\n"
                           f"{chr(10).join(lines[-40:])}\n{r.stdout[-2000:]}"
                           f"\n{r.stderr[-3000:]}")
    shutil.rmtree(run, ignore_errors=True)


# --------------------------------------------------------------- phase 10
# the cadence of the densification run; kitti360_nvs_1908's widths,
# thresholds and densify_until_num_points stay as configured
DENSIFY_RUN = ["densify_from_iter=4", "densification_interval=4",
               "densify_until_iter=14", "opacity_reset_interval=6",
               "scale_increase_interval=10", "checkpoint_iterations=[12]",
               "vis_step=8"]
DENSIFY_ITERATIONS, RESUME_ITERATIONS = 16, 14


def _median_ms(step_ms, its):
    v = [step_ms[i] for i in its if i in step_ms]
    return statistics.median(v) if v else float("nan")


def phase_train_densify(device, init_params, smi):
    """A training run with densification: ``training`` for 16 steps of
    the seeded 1M-gaussian model at kitti360_nvs_1908's widths with
    DENSIFY_RUN's cadence, the launch counts set to 0 just before it and
    read just after; then a resume from its checkpoint at 12 to 14."""
    import math
    import random
    import shutil
    import numpy as np
    import torch
    import gslidar_tpu_torch.raster.composite_op as co
    import gslidar_tpu_torch.train as T
    from gslidar_tpu_torch.config import Config
    from gslidar_tpu_torch.engine.checkpoint import load_train_state
    from gslidar_tpu_torch.render import gaussian_config

    run = os.path.join(REPO, "build", "chip_smoke_densify")
    shutil.rmtree(run, ignore_errors=True)
    args = train_args(run, DENSIFY_ITERATIONS, DENSIFY_RUN)
    init_opacity = gaussian_config(args).init_opacity
    random.seed(SEED)
    np.random.seed(SEED)
    rec = dict(n={}, events={}, step_ms={}, densify={}, ckpt={},
               upscale={}, eval_s={})
    bad, cuda_ms, held = [], [], {}
    capture = dict(armed=False)
    bwd_orig, make_orig = co.composite_backward, T.make_densify_fn

    def bwd_keep(*a):
        if capture["armed"]:
            capture["bwd"] = a
        return bwd_orig(*a)

    def make_timed(*a, **k):                  # the densify by CUDA events
        return cuda_timed(make_orig(*a, **k), cuda_ms)

    def mark():
        torch.cuda.synchronize()
        rec["t"] = time.perf_counter()

    def check_kernels(iteration):
        failed, _, _ = check_step_kernels(
            10, f"on step {iteration}, the first after the densify",
            capture.pop("bwd"), SEED + 19)
        bad.extend(f"{kind} kernel vs plain at {iteration}"
                   for kind in failed)
        rec["kernels_checked"] = iteration

    def on_step(iteration, state, loss, log, grads):
        torch.cuda.synchronize()
        rec["step_ms"][iteration] = (time.perf_counter() - rec["t"]) * 1e3
        steps.step()
        rec["n"][iteration] = state.params["xyz"].shape[0]
        rec["events"][iteration] = []
        if not (math.isfinite(float(loss)) and all(
                bool(torch.isfinite(g).all()) for g in grads.values())):
            bad.append(f"non-finite loss or gradient at {iteration}")
        if capture["armed"]:
            capture["armed"] = False
            check_kernels(iteration)
        mark()

    def on_event(iteration, name, state, info):
        steps.skip(name)
        rec["events"][iteration].append(name)
        if name == "densify":
            c = dict(info, cuda_ms=cuda_ms[-1])
            rec["densify"][iteration] = c
            new = slice(c["old_kept"], None)
            zero_aux = not any(bool(getattr(state.aux, f).any()) for f in (
                "max_radii2D", "xyz_gradient_accum",
                "xyz_gradient_accum_abs", "t_gradient_accum", "denom"))
            zero_new = not any(bool(m[k][new].any()) for m in (
                state.opt.mu, state.opt.nu) for k in m)
            adds = (c["before"] - c["never_visible"] - c["splits"] + c["new"]
                    - c["opacity_pruned"] - c["world_size_pruned"]
                    == c["after"] == state.params["xyz"].shape[0])
            if not (zero_aux and zero_new and adds):
                bad.append(f"densify at {iteration}: aux zero {zero_aux}, "
                           f"new moments zero {zero_new}, counts add up "
                           f"{adds}")
            capture["armed"] = iteration == 8
        elif name == "reset":
            top = float(torch.sigmoid(state.params["opacity"]).max())
            if top > init_opacity + 1e-6 or bool(
                    state.opt.mu["opacity"].any()) or bool(
                    state.opt.nu["opacity"].any()):
                bad.append(f"reset at {iteration}: max opacity {top}")
        elif name == "upscale":
            rec["upscale"][iteration] = (tuple(state.prior.shape),
                                         state.prior_opt[2])
        elif name == "checkpoint":
            rec["ckpt"][iteration] = info
            held[iteration] = state
        elif name == "eval":                  # the final eval, whole
            torch.cuda.synchronize()
            rec["eval_s"][iteration] = (time.perf_counter() - rec["t"],
                                        sorted(info))
        mark()

    torch.cuda.reset_peak_memory_stats()
    co.composite_backward, T.make_densify_fn = bwd_keep, make_timed
    try:
        set_launch_counts()
        steps = StepLaunches()
        mark()
        t0 = time.perf_counter()
        state, scene, losses = T.training(args, device,
                                          init_params=init_params,
                                          on_step=on_step, on_event=on_event)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        co.composite_backward, T.make_densify_fn = bwd_orig, make_orig
    per_step = steps.per_step
    adam_ok, ADAM_BY_PATH["training with densification (phase 10)"] = (
        steps.held())
    graph_ok, GRAPHS_BY_PATH["training with densification (phase 10)"] = (
        steps.graphs_held())
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    # the events against the schedule, on the counts observed
    nts, wrong = bool(args.no_time_split), []
    for it in range(1, DENSIFY_ITERATIONS + 1):
        want = T.schedule(args, it, rec["n"][it], nts)
        got = [e for e in rec["events"][it] if e not in ("vis", "eval")]
        if got != want:
            wrong.append((it, got, want))
        nts = nts and "flip" not in got
    fired = {it: [e for e in ev if e not in ("vis", "eval")]
             for it, ev in rec["events"].items()
             if any(e not in ("vis", "eval") for e in ev)}
    say(10, f"training with densification: {len(losses)} steps from "
            f"{NUM_GAUSSIANS} gaussians at {HW[0]}x{HW[1]} ("
            + ", ".join(DENSIFY_RUN) + f") | events {fired} | launches "
            f"{launches_text(launches)}, per step {per_step} (and "
            f"{steps.other[0]} compositor forwards of the depth "
            f"visualizations), Adam per step {steps.adam} | gaussians per "
            f"step "
            f"{[rec['n'][i] for i in sorted(rec['n'])]} | loss "
            f"{[round(x, 5) for x in losses]} | {wall_s:.2f} s")
    for it, c in rec["densify"].items():
        say(10, f"densify at {it}: {c['before']} -> {c['after']} gaussians: "
                f"never visible -{c['never_visible']}, clones "
                f"{c['clones']}, splits {c['splits']} (originals cut), new "
                f"+{c['new']}, opacity prune -{c['opacity_pruned']}, "
                f"world-size prune -{c['world_size_pruned']} (on: "
                f"{c['world_size_prune']}) | {c['cuda_ms']:.3f} ms by CUDA "
                f"events on {smi} ({c['ms']:.3f} ms host)")
    dens = sorted(rec["densify"])
    spans = [range(2, dens[0])] + [range(a + 1, b) for a, b in
                                   zip(dens, dens[1:] + [DENSIFY_ITERATIONS
                                                          + 1])]
    say(10, f"step time on {smi} (host clock around each step, synchronised;"
            f" median): " + ", ".join(
                f"steps {r.start}-{r.stop - 1} "
                f"({rec['n'][r.start]} gaussians) "
                f"{_median_ms(rec['step_ms'], r):.3f} ms" for r in spans
                if len(r)) + " | upscale " + str(rec["upscale"])
        + f" | peak memory {peak_gb:.2f} GiB")

    # the resume from the checkpoint at 12
    path12 = rec["ckpt"].get(12, {}).get("path", "")
    t0 = time.perf_counter()
    loaded, it12 = load_train_state(path12, device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    same = it12 == 12 and states_equal(loaded, held[12])
    del loaded, held
    resume = train_args(run, RESUME_ITERATIONS, DENSIFY_RUN)
    Config.update(resume, "start_checkpoint", path12)
    set_launch_counts()
    steps = StepLaunches()

    def on_resume_event(iteration, name, state, info):
        steps.skip(name)
        if name == "eval":
            torch.cuda.synchronize()
            rec["eval_s"][f"resume {iteration}"] = (
                time.perf_counter() - rec["t"], sorted(info))
        rec["t"] = time.perf_counter()

    def on_resume_step(*a):
        steps.step()
        mark()
    mark()
    r_losses = T.training(resume, device, init_params=init_params,
                          on_step=on_resume_step,
                          on_event=on_resume_event)[2]
    say(10, "checkpoints: " + ", ".join(
        f"{it}: {c['bytes']} bytes saved in {c['seconds']:.2f} s"
        for it, c in sorted(rec["ckpt"].items()))
        + f" | chkpnt12 loaded in {load_s:.2f} s, every leaf bit for bit as "
          f"saved: {same} | resume to {RESUME_ITERATIONS}: "
          f"{len(r_losses)} steps, launches per step {steps.per_step}, "
          f"Adam per step {steps.adam}, loss "
          f"{[round(x, 5) for x in r_losses]}")
    say(10, "the final evals (complete_eval at test_iterations' appended "
            "last iteration; host clock, synchronised): " + ", ".join(
                f"{it}: {sec:.2f} s ({'+'.join(splits)})"
                for it, (sec, splits) in rec["eval_s"].items()))
    resume_adam_ok, ADAM_BY_PATH["resumed training (phase 10)"] = (
        steps.held())
    resume_graph_ok, GRAPHS_BY_PATH["resumed training (phase 10)"] = (
        steps.graphs_held())
    say(10, "loss graphs: " + json.dumps(
        {k: v for k, v in GRAPHS_BY_PATH.items() if "(phase 10)" in k}))
    files = {it: os.path.exists(os.path.join(run, "ckpt",
                                             f"chkpnt{it}.npz"))
             for it in (12, DENSIFY_ITERATIONS)}
    shutil.rmtree(run, ignore_errors=True)
    if (wrong or bad or len(losses) != DENSIFY_ITERATIONS
            or any(d != ONE_STEP for d in per_step + steps.per_step)
            or not adam_ok or not resume_adam_ok
            or not graph_ok or not resume_graph_ok
            or 8 not in rec["densify"] or "reset" not in rec["events"][6]
            or "upscale" not in rec["events"][10]
            or rec.get("kernels_checked") != 9
            or not all(files.values()) or not same
            or len(r_losses) != RESUME_ITERATIONS - 12
            or not all(math.isfinite(x) for x in r_losses)
            or sorted(rec["eval_s"], key=str) != sorted(
                [DENSIFY_ITERATIONS, f"resume {RESUME_ITERATIONS}"],
                key=str)):
        raise RuntimeError(f"the densification run failed its checks: "
                           f"events off the schedule {wrong}, {bad}, "
                           f"checkpoints {files}, resume bitwise {same}")


# --------------------------------------------------------------- phase 11
def write_lpips_weights(path, seed):
    """Seeded random AlexNet-LPIPS weights in the converted-npz layout
    (``conv{i}_w/b``, ``lin{i}_w``), as tests/test_eval.py writes them."""
    import numpy as np
    rng = np.random.default_rng(seed)
    w = {}
    for i, (cin, cout, k) in enumerate([(3, 64, 11), (64, 192, 5),
                                        (192, 384, 3), (384, 256, 3),
                                        (256, 256, 3)]):
        w[f"conv{i}_w"] = (rng.normal(size=(cout, cin, k, k)) * 0.05).astype(
            np.float32)
        w[f"conv{i}_b"] = np.zeros(cout, np.float32)
        w[f"lin{i}_w"] = rng.uniform(0, 1, (1, cout, 1, 1)).astype(
            np.float32)
    np.savez(path, **w)


class EvalClock:
    """Per pair of a ``complete_eval``, the host-clock ms (the card
    synchronised at each edge) of the render, ``_depth3`` and the host
    copies, each meter's update and the chamfer, by wrapping the
    functions and meter classes that ``engine.evaluate`` and
    ``utils.metrics`` call."""

    def __init__(self):
        self.pairs = []

    def timed(self, name, fn, new_pair=False):
        import torch

        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if new_pair:
                self.pairs.append(dict(start=t0))
            out = fn(*a, **k)
            torch.cuda.synchronize()
            rec = self.pairs[-1]
            rec[name] = rec.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            rec["end"] = time.perf_counter()
            return out
        return wrapped

    def meter(self, cls):
        clock = self

        class Timed(cls):
            def update(self, *a):
                return clock.timed(cls.__name__, super().update)(*a)
        return Timed

    def summary(self):
        keys = [k for k in self.pairs[0] if k not in ("start", "end")]
        out = {k: [round(p.get(k, 0.0), 3) for p in self.pairs]
               for k in keys}
        out["pair total"] = [round((p["end"] - p["start"]) * 1e3, 3)
                             for p in self.pairs]
        return out


def phase_eval_refine(args, params, alive, prior, smi):
    """Eval and ray-drop refinement at full width on phase 4's seeded
    1M-gaussian model: ``complete_eval`` over the Synthetic scene's 2
    test and 6 train pairs (66x1030 panoramas), with LPIPS first absent
    and then from seeded random weights; ``refine`` on the 6 train renders
    for the base config's refine_epochs; ``refine_test``."""
    import math
    import random
    import shutil
    import types
    import numpy as np
    import torch
    import gslidar_tpu_torch.engine.evaluate as E
    import gslidar_tpu_torch.raster.composite_op as co
    import gslidar_tpu_torch.utils.metrics as M
    from gslidar_tpu_torch.config import load_run_config
    from gslidar_tpu_torch.engine.refine import (_load_unet, refine,
                                                 refine_test)
    from gslidar_tpu_torch.render import (build_scene, gaussian_config,
                                          raster_settings)
    from gslidar_tpu_torch.utils.lpips import load_lpips

    device = alive.device
    run = os.path.join(REPO, "build", "chip_smoke_eval")
    shutil.rmtree(run, ignore_errors=True)
    os.makedirs(run)
    epochs = int(load_run_config(os.path.join(REPO, "configs", "base.yaml"),
                                 os.path.join(REPO, "configs",
                                              "kitti360_nvs_1908.yaml"),
                                 []).refine_epochs)
    eargs = Args(args, model_path=run, refine_epochs=epochs)
    random.seed(SEED)
    np.random.seed(SEED)
    scene = build_scene(eargs)
    n_pairs = (len(scene.get_test_cameras(1)) // 2,
               len(scene.get_train_cameras()) // 2)
    h, w = HW
    cfg = gaussian_config(eargs)
    settings = raster_settings(eargs, h, w)
    bg = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
    state = types.SimpleNamespace(params=params, prior=prior,
                                  aux=types.SimpleNamespace(alive=alive))
    ev = E.make_eval_render(eargs, cfg, settings, bg)
    ev360 = E.make_eval_render360(eargs, cfg, settings, bg)
    clock = EvalClock()
    capture = {}
    fwd_orig = co.composite_forward

    def fwd_keep(*a):
        capture.setdefault("fwd", a)
        return fwd_orig(*a)

    saved = (E._depth3, E._np, M.chamfer_distance, co.composite_forward,
             E.RaydropMeter, E.IntensityMeter, E.DepthMeter, E.PointsMeter)
    E._depth3 = clock.timed("_depth3", E._depth3)
    E._np = clock.timed("host copies", E._np)
    M.chamfer_distance = clock.timed("chamfer", M.chamfer_distance)
    co.composite_forward = fwd_keep
    for name in ("RaydropMeter", "IntensityMeter", "DepthMeter",
                 "PointsMeter"):
        setattr(E, name, clock.meter(getattr(M, name)))
    os.environ.pop("GSLIDAR_LPIPS_WEIGHTS", None)
    torch.cuda.reset_peak_memory_stats()
    try:
        set_launch_counts()
        t0 = time.perf_counter()
        results = E.complete_eval(
            0, eargs, scene, state, SH_DEGREE, ev, is_final=True,
            save_raydrop_data=True,
            eval_render360=clock.timed("render", ev360, new_pair=True))
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        launches = launch_counts()
        peak = {"eval": torch.cuda.max_memory_allocated() / 2 ** 30}
    finally:
        (E._depth3, E._np, M.chamfer_distance, co.composite_forward,
         E.RaydropMeter, E.IntensityMeter, E.DepthMeter,
         E.PointsMeter) = saved

    # one eval render's forward kernel against its plain version
    rows, starts, params8, st, C, S = capture.pop("fwd")[:6]
    ok_f, summ_f, _, _ = run_pair(rows, starts, params8, st, C, S)
    set_launch_counts(launches)
    say(11, f"forward kernel vs plain on the first eval render "
            f"({rows.shape[0]} instances, {st.height}x{st.width}): "
            f"{'ok' if ok_f else 'FAIL'} {json.dumps(summ_f)}")
    del rows, starts

    def values(m):
        return [v for d in m.values() if isinstance(d, dict)
                for v in d.values()]
    parsed = {}
    for split in ("test", "train"):
        with open(os.path.join(run, "eval", f"{split}_0_render",
                               "metrics.json")) as f:
            parsed[split] = json.load(f)
    finite = all(all(v is None or math.isfinite(v) for v in values(m))
                 and m["Depth"]["LPIPS"] is None
                 and m["Intensity SH"]["LPIPS"] is None
                 and sum(v is None for v in values(m)) == 2
                 for m in parsed.values())
    saved_npy = {sub: len(os.listdir(os.path.join(run, "ray_drop_datasets",
                                                  sub)))
                 for sub in ("gt", "render_train", "render_test")}
    times = clock.summary()
    say(11, f"complete_eval on {smi}: {sum(n_pairs)} pairs ({n_pairs[0]} "
            f"test, {n_pairs[1]} train) of {NUM_GAUSSIANS} gaussians at "
            f"{h}x{2 * w}, {eval_s:.2f} s | launches {launches_text(launches)} | "
            f"ray_drop_datasets {saved_npy} | metrics finite, LPIPS null: "
            f"{finite} | test {json.dumps(parsed['test'])}")
    say(11, "per pair, ms (host clock, synchronised): " + " | ".join(
        f"{k} {v}" for k, v in times.items()))

    # LPIPS from seeded random weights: the card against the CPU
    lp_path = os.path.join(run, "lpips_random.npz")
    write_lpips_weights(lp_path, SEED + 11)
    os.environ["GSLIDAR_LPIPS_WEIGHTS"] = lp_path
    try:
        t0 = time.perf_counter()
        lp_res = E.complete_eval(1, eargs, scene, state, SH_DEGREE, ev,
                                 eval_render360=ev360)["test"]
        torch.cuda.synchronize()
        lp_eval_s = time.perf_counter() - t0
    finally:
        os.environ.pop("GSLIDAR_LPIPS_WEIGHTS")
    x = np.load(os.path.join(run, "ray_drop_datasets", "render_test",
                             sorted(os.listdir(os.path.join(
                                 run, "ray_drop_datasets",
                                 "render_test")))[0]))
    g = np.load(os.path.join(run, "ray_drop_datasets", "gt",
                             sorted(os.listdir(os.path.join(
                                 run, "ray_drop_datasets",
                                 "render_test")))[0]))
    a = np.clip(x[[2]] / float(eargs.scale_factor), 1e-6, 80.0)
    b = np.clip(g[[2]] / float(eargs.scale_factor), 1e-6, 80.0)
    lp_gpu = load_lpips(lp_path, device)(a, b)
    lp_cpu = load_lpips(lp_path, "cpu")(a, b)
    lp_rel = abs(lp_gpu - lp_cpu) / abs(lp_cpu)
    lp_ok = (lp_rel <= 1e-4 and lp_res["Depth"]["LPIPS"] is not None
             and math.isfinite(lp_res["Depth"]["LPIPS"]))
    say(11, f"LPIPS with seeded random weights: eval of the 2 test pairs "
            f"{lp_eval_s:.2f} s, Depth LPIPS {lp_res['Depth']['LPIPS']}, "
            f"Intensity LPIPS {lp_res['Intensity SH']['LPIPS']} | one "
            f"depth panorama on the card {lp_gpu!r}, on the CPU {lp_cpu!r}, "
            f"relative difference {lp_rel:.3g} (bar 1e-4)")

    # refine on the 6 train renders, then refine_test
    ev_t = []

    def on_epoch(i, loss):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        ev_t.append(e)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    set_bn_act_launches()
    t0 = time.perf_counter()
    model, printed = refine(eargs, device, on_epoch=on_epoch)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    bn_launched = bn_act_launches()
    BN_ACT_BY_PATH["refine (phase 11)"] = bn_launched
    peak["refine"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del model
    epoch_ms = ev_t[0].elapsed_time(ev_t[-1]) / max(len(ev_t) - 1, 1)
    xs = np.stack([np.load(os.path.join(run, "ray_drop_datasets",
                                        "render_test", n))
                   for n in sorted(os.listdir(os.path.join(
                       run, "ray_drop_datasets", "render_test")))])
    with torch.no_grad():
        u_gpu = _load_unet(eargs, device)(
            torch.as_tensor(xs, device=device)).cpu().numpy()
        u_cpu = _load_unet(eargs, "cpu")(torch.as_tensor(xs)).numpy()
    u_err = float(np.abs(u_gpu - u_cpu).max())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt = refine_test(eargs, device)
    torch.cuda.synchronize()
    refine_test_s = time.perf_counter() - t0
    peak["refine_test"] = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [v for _, v in printed]
    refine_ok = (len(ev_t) == epochs and all(map(math.isfinite, losses))
                 and len(losses) >= 2 and losses[-1] < losses[0])
    say(11, f"refine on {smi}: {epochs} epochs on "
            f"{n_pairs[1]} train renders [{n_pairs[1]}, 3, {h}, {2 * w}], "
            f"{epoch_ms:.3f} ms per epoch (CUDA events, epochs 2-{epochs}),"
            f" {refine_s:.2f} s in all | BatchNorm kernel launches, forward"
            f" and backward, {bn_launched} (18 a pair an epoch: "
            f"{18 * epochs}) | loss by 50 epochs "
            f"{[round(v, 5) for v in losses]} | U-Net eval forward, card vs "
            f"CPU on {len(xs)} test renders: max abs {u_err:.3g} (bar 1e-4)"
            f" | refine_test {refine_test_s:.2f} s: test "
            f"{json.dumps(rt['test'])} | peak memory (GiB) "
            f"{ {k: round(v, 2) for k, v in peak.items()} }")
    shutil.rmtree(run, ignore_errors=True)
    n = sum(n_pairs)
    # a pair's render, and a chamfer forward in each of its 3 PointsMeters
    if not (ok_f and launches == (n, 0, n, 0, 3 * n, 0) and n_pairs == (2, 6)
            and finite and lp_ok and refine_ok and u_err <= 1e-4
            and bn_launched == (18 * epochs, 18 * epochs)
            and sorted(results) == ["test", "train"]
            and saved_npy == {"gt": 8, "render_train": 6, "render_test": 2}
            and sorted(rt) == ["test", "train"]):
        raise RuntimeError("eval and refine failed their checks")
    return summ_f["raw_max_abs_err"], launches


# --------------------------------------------------------------- phase 12
# opv2v_dynamic_2 on the synthetic OPV2V tree: its widths, lambdas,
# num_pts and densify_until_num_points as configured, only the paths and
# the cadence overridden; the flip (time_split_frac 1.0) then fires at 15,
# after the last densify, as in the real config. One threshold goes with
# the cadence: the config prunes opacity under 0.1 (thresh_opa_prune),
# above the 0.05 that create_from_pcd and each reset give every gaussian,
# and 7 Adam steps at opacity_lr 0.05 cannot lift one past it (15 would),
# so a densify at 8 would prune every gaussian; base.yaml's 0.005 stands in
OPV2V_RUN = ["densify_from_iter=4", "densification_interval=4",
             "densify_until_iter=14", "opacity_reset_interval=6",
             "checkpoint_iterations=[12]", "thresh_opa_prune=0.005"]
OPV2V_ITERATIONS = 16
OPV2V_FRAMES = list(range(68, 101, 2))    # frame_start 68 to frame_end 100
VIEWER_AT = 5                             # the step whose hook starts the
                                          # viewer's client (no event there)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def viewer_client(port, steps, out, paused):
    """The viewer's client, on a thread of its own: pause the loop (it
    then waits in its next ``checkin``), a full, a preview and a second
    full ``/render``, each timed and its launches counted (the
    first waits for the rest of the loop's iteration, which holds the
    viewer's lock), resume, read ``/stats``. The launches of the renders
    are moved off the next step (``steps.skip``) while the loop is
    paused."""
    import io
    import urllib.request
    from PIL import Image

    def get(path, method="GET"):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     method=method)
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.read()
    try:
        out["paused"] = json.loads(get("/pause", "POST"))["paused"]
        paused.set()
        for name, q in (("full", ""), ("preview", "&preview=1"),
                        ("full again", "")):
            n0 = launch_counts()
            t0 = time.perf_counter()
            png = get("/render?mode=orbit&az=30&el=20&dist=25&frame=8" + q)
            out[name] = dict(ms=(time.perf_counter() - t0) * 1e3,
                             size=Image.open(io.BytesIO(png)).size,
                             launches=[n - m for n, m in
                                       zip(launch_counts(), n0)])
        steps.skip()
        out["resumed"] = not json.loads(get("/pause", "POST"))["paused"]
        out["stats"] = json.loads(get("/stats"))
    except Exception as e:                 # reported by the phase's check
        out["error"] = repr(e)
    finally:
        paused.set()


def phase_opv2v(smi, device, tree_kw=None, overrides=()):
    """The dynamic, multi-vehicle scene at full width: a synthetic OPV2V
    tree (3 vehicles x 17 frames, written by ``data/opv2v_tree.py`` and
    preprocessed by ``data/preprocess/opv2v_to_gs.py``), then ``training``
    on configs/opv2v_dynamic_2.yaml for 16 steps from the 3,000,000
    gaussians of ``create_from_pcd``, with the live viewer on and served
    from a client thread; the launch counts are set to 0 just before the
    run and read just after. ``tree_kw`` and ``overrides`` shrink the tree
    and the config for a rehearsal on the CPU. Returns the kernels'
    largest absolute errors against their plain versions on the step
    after the first densify, and the run's launches."""
    import contextlib
    import math
    import random
    import shutil
    import threading
    import numpy as np
    import torch
    import gslidar_tpu_torch.models.gaussians as G
    import gslidar_tpu_torch.raster.composite_op as co
    import gslidar_tpu_torch.train as T
    from gslidar_tpu_torch.data.opv2v_tree import write_opv2v_tree
    from gslidar_tpu_torch.data.preprocess import opv2v_to_gs
    from gslidar_tpu_torch.engine.checkpoint import load_train_state
    from gslidar_tpu_torch.ops.knn import mean_sq_dist_knn3_brute

    root = os.path.join(REPO, "build", "chip_smoke_opv2v")
    shutil.rmtree(root, ignore_errors=True)
    data, run = os.path.join(root, "data"), os.path.join(root, "run")
    t0 = time.perf_counter()
    n_written = write_opv2v_tree(data, OPV2V_FRAMES, **(tree_kw or {}))
    with contextlib.redirect_stdout(None):
        opv2v_to_gs.main(data)
    tree_s = time.perf_counter() - t0
    port = _free_port()
    args = T.load_args(os.path.join(REPO, "configs", "opv2v_dynamic_2.yaml"),
                       os.path.join(REPO, "configs", "base.yaml"),
                       [f"source_path={data}", f"model_path={run}",
                        f"iterations={OPV2V_ITERATIONS}", f"seed={SEED}",
                        *OPV2V_RUN, "viewer=true", f"viewer_port={port}",
                        *overrides])
    h, w = args.hw
    random.seed(SEED)               # the loader's pair shuffle
    np.random.seed(SEED)            # and its point colors
    rec = dict(n={}, events={}, step_ms={}, densify={}, ckpt={}, eval_s={},
               shift={}, pairs={}, moved={})
    bad, cuda_ms, held, capture = [], [], {}, dict(armed=False)
    client, paused = {}, threading.Event()
    saved_fns = (T.build_scene, T.create_from_pcd, G.mean_sq_dist_knn3,
                 T.make_train_step, T.make_densify_fn, co.composite_backward)

    def timed(name, fn):
        def run_timed(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            rec[name] = time.perf_counter() - t
            return out
        return run_timed

    def create_keep(*a, **k):
        params, aux = timed("create_s", saved_fns[1])(*a, **k)
        rec["init"] = {key: params[key].clone()
                       for key in ("velocity", "t", "scaling_t")}
        stage("create_from_pcd")
        return params, aux

    def make_step(*a, **k):
        fn = saved_fns[3](*a, **k)

        def step(state, cam, iteration, sh, time_shift, *aa, **kk):
            rec["shift"][iteration] = time_shift
            return fn(state, cam, iteration, sh, time_shift, *aa, **kk)
        return step

    def make_densify(*a, **k):                 # the densify by CUDA events
        return cuda_timed(saved_fns[4](*a, **k), cuda_ms)

    def bwd_keep(*a):
        if capture["armed"]:
            capture["bwd"] = a
        return saved_fns[5](*a)

    stages = Stages()
    stage = stages.close

    def check_kernels(iteration):
        failed, err_f, err_b = check_step_kernels(
            12, f"on dynamic step {iteration}, the first after a densify",
            capture.pop("bwd"), SEED + 23)
        bad.extend(f"{kind} kernel vs plain at {iteration}"
                   for kind in failed)
        rec["checked"] = (iteration, err_f, err_b)

    def on_step(iteration, state, loss, log, grads):
        rec["step_ms"][iteration] = stage("step") * 1e3
        steps.step()
        rec["n"][iteration] = state.params["xyz"].shape[0]
        rec["pairs"][iteration] = log["num_pairs"]
        rec["events"][iteration] = []
        if not (math.isfinite(float(loss)) and all(
                bool(torch.isfinite(g).all()) for g in grads.values())):
            bad.append(f"non-finite loss or gradient at {iteration}")
        if not rec["densify"]:                 # rows as create_from_pcd's
            for k, v in rec["init"].items():
                rec["moved"][k] = rec["moved"].get(k, False) or \
                    not torch.equal(state.params[k], v)
        if capture["armed"]:
            capture["armed"] = False
            check_kernels(iteration)
        if iteration == VIEWER_AT:
            client["thread"] = threading.Thread(
                target=viewer_client, args=(port, steps, client, paused),
                daemon=True)
            client["thread"].start()
            if not paused.wait(300):
                bad.append("the viewer's client did not pause the loop")
        stage("hook")

    def on_event(iteration, name, state, info):
        seconds = stage(name)
        steps.skip(name)
        rec["events"][iteration].append(name)
        if name == "densify":
            rec["densify"][iteration] = dict(info, cuda_ms=cuda_ms[-1])
            capture["armed"] = len(rec["densify"]) == 1
        elif name == "checkpoint":
            rec["ckpt"][iteration] = info
            held[iteration] = state
        elif name == "eval":
            rec["eval_s"][iteration] = (seconds, info)
        stage("hook")

    torch.cuda.empty_cache()
    (T.build_scene, T.create_from_pcd, G.mean_sq_dist_knn3, T.make_train_step,
     T.make_densify_fn, co.composite_backward) = (
        timed("scene_s", saved_fns[0]), create_keep,
        timed("knn_s", saved_fns[2]), make_step, make_densify, bwd_keep)
    try:
        set_launch_counts()
        steps = StepLaunches()
        stages.start()
        t0 = time.perf_counter()
        state, scene, losses = T.training(args, device, on_step=on_step,
                                          on_event=on_event)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        (T.build_scene, T.create_from_pcd, G.mean_sq_dist_knn3,
         T.make_train_step, T.make_densify_fn,
         co.composite_backward) = saved_fns
    if "thread" in client:
        client["thread"].join(60)
    per_step = steps.per_step
    n_points = len(scene.scene_info.point_cloud[0])
    n_test = len(scene.get_test_cameras(1)) // 2
    n_train = len(scene.get_train_cameras()) // 2

    # the events against the schedule, on the counts observed
    nts, wrong = bool(args.no_time_split), []
    for it in range(1, OPV2V_ITERATIONS + 1):
        want = T.schedule(args, it, rec["n"][it], nts)
        got = [e for e in rec["events"][it] if e not in ("vis", "eval")]
        if got != want:
            wrong.append((it, got, want))
        nts = nts and "flip" not in got
    fired = {it: ev for it, ev in rec["events"].items() if ev}
    shifted = {it: round(s, 6) for it, s in rec["shift"].items() if s}
    say(12, f"dynamic OPV2V scene on {smi}: {n_written} points in the tree "
            f"(3 vehicles x {len(OPV2V_FRAMES)} frames, written and "
            f"preprocessed in {tree_s:.1f} s); the loader kept {n_points} "
            f"(scene built in {rec['scene_s']:.1f} s: {n_train} train and "
            f"{n_test} test pairs at {h}x{w}); create_from_pcd "
            f"{rec['create_s']:.1f} s, of which the 3-NN {rec['knn_s']:.1f}"
            f" s")
    say(12, f"training opv2v_dynamic_2: {len(losses)} steps ("
            + ", ".join(OPV2V_RUN) + f") | events {fired} | launches "
            f"{launches_text(launches)}, per step {per_step} (and "
            f"{steps.other[0]} compositor forwards of the depth "
            f"visualizations, the viewer and the final eval), Adam per step "
            f"{steps.adam} | time shift "
            f"at {shifted} | gaussians per step "
            f"{[rec['n'][i] for i in sorted(rec['n'])]} | instances per "
            f"step {[rec['pairs'][i] for i in sorted(rec['pairs'])]} | loss "
            f"{[round(x, 5) for x in losses]} | moved before the first "
            f"densify {rec['moved']} | {wall_s:.1f} s with set-up")
    for it, c in rec["densify"].items():
        say(12, f"densify at {it}: {c['before']} -> {c['after']} gaussians: "
                f"never visible -{c['never_visible']}, clones "
                f"{c['clones']}, splits {c['splits']}, new +{c['new']}, "
                f"opacity prune -{c['opacity_pruned']}, world-size prune "
                f"-{c['world_size_pruned']} | {c['cuda_ms']:.3f} ms by CUDA "
                f"events on {smi}")
    dens = sorted(rec["densify"])
    spans = [range(2, dens[0])] + [range(a + 1, b) for a, b in zip(
        dens, dens[1:] + [OPV2V_ITERATIONS + 1])]
    # the loop waits for the viewer's two renders in the next checkin
    rec["step_ms"].pop(VIEWER_AT + 1, None)
    say(12, f"step time on {smi} (host clock around each step, "
            f"synchronised; median): " + ", ".join(
                f"steps {r.start}-{r.stop - 1} ({rec['n'][r.start]} "
                f"gaussians) {_median_ms(rec['step_ms'], r):.3f} ms"
                for r in spans if len(r)))

    # chkpnt12 reloads bit for bit
    path12 = rec["ckpt"].get(12, {}).get("path", "")
    t0 = time.perf_counter()
    loaded, it12 = load_train_state(path12, device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    same = it12 == 12 and states_equal(loaded, held.pop(12))
    del loaded, held

    # the spatial 3-NN against its brute force on a 100k subset of the cloud
    sub = torch.as_tensor(scene.scene_info.point_cloud[0][::30],
                          device=device)
    t0 = time.perf_counter()
    fast = G.mean_sq_dist_knn3(sub)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    brute = mean_sq_dist_knn3_brute(sub)
    torch.cuda.synchronize()
    knn_same = bool(torch.equal(fast, brute))
    say(12, f"3-NN on {smi}, {sub.shape[0]} points of the scene: spatial "
            f"search {t1 - t0:.2f} s, brute force "
            f"{time.perf_counter() - t1:.2f} s, equal bit for bit: "
            f"{knn_same}")

    eval_s, results = rec["eval_s"].get(OPV2V_ITERATIONS, (0.0, {}))
    finite = bool(results) and all(
        math.isfinite(x) for split in results.values()
        for x in floats(split))
    say(12, "checkpoints on " + smi + ": " + ", ".join(
        f"{it}: {c['bytes']} bytes saved in {c['seconds']:.2f} s"
        for it, c in sorted(rec["ckpt"].items()))
        + f" | chkpnt12 loaded in {load_s:.2f} s, every leaf bit for bit as "
          f"saved: {same} | the final eval ({n_test} test + {n_train} train "
          f"pairs at {h}x{2 * w}) {eval_s:.2f} s, metrics finite {finite}: "
          + json.dumps({k: {m: v[m] for m in ("Ray drop", "Depth")}
                        for k, v in results.items()}))
    say(12, f"viewer on {smi} (port {port}, served from a client thread "
            f"during step {VIEWER_AT}): "
            + json.dumps({k: client.get(k) for k in (
                "paused", "full", "preview", "full again", "resumed",
                "stats", "error")})
            + " | peak memory by stage (GiB) "
            + json.dumps({k: round(v, 2) for k, v in stages.peak.items()}))
    shutil.rmtree(root, ignore_errors=True)
    full, prev, again = (client.get(k, {}) for k in (
        "full", "preview", "full again"))
    adam_ok, ADAM_BY_PATH["OPV2V training (phase 12)"] = steps.held()
    graph_ok, GRAPHS_BY_PATH["OPV2V training (phase 12)"] = (
        steps.graphs_held())
    say(12, f"loss graphs: {GRAPHS_BY_PATH['OPV2V training (phase 12)']}")
    if (wrong or bad or len(losses) != OPV2V_ITERATIONS
            or n_points != args.num_pts or (n_train, n_test) != (48, 3)
            or any(d != ONE_STEP for d in per_step)
            or not adam_ok or not graph_ok
            or dens != [8, 12] or not shifted
            or not all(rec["moved"].get(k) for k in (
                "velocity", "t", "scaling_t"))
            or rec.get("checked", (0,))[0] != 9 or not same or not finite
            or not knn_same
            or sorted(results) != ["test", "train"]
            or "error" in client or not client.get("paused")
            or not client.get("resumed")
            or any(r.get("size") != (w, h) or r.get("launches") != ONE_RENDER
                   for r in (full, again))
            or prev.get("size") != (max(w // 2, 8), max(h // 2, 8))
            or prev.get("launches") != ONE_RENDER
            or not client.get("stats", {}).get("rays_per_sec")):
        raise RuntimeError(f"the dynamic OPV2V run failed its checks: events "
                           f"off the schedule {wrong}, {bad}, checkpoint "
                           f"bitwise {same}, eval finite {finite}, viewer "
                           f"{client}")
    return rec["checked"][1], rec["checked"][2], launches


# --------------------------------------------------------------- phase 13
# data-parallel training: B cameras per step over the group, with
# DENSIFY_RUN's cadence cut to DP_ITERATIONS steps (a densify at 8)
DP_CAMERAS = 4
DP_ITERATIONS = 10
DP_RUN = [*DENSIFY_RUN, "data_parallel=true",
          f"data_parallel_cameras={DP_CAMERAS}"]
DP_COMPARE_ITERATION = 5        # statistics on (densify_from_iter 4 < 5)
# DP statistics and gradients vs 4 sequential steps: the JAX test's CPU
# bar (tests/test_parallel_train_e2e.py:93-103), held by norm: on the
# card the per-gaussian reduction adds in atomic order, so an element
# built from cancelling terms may differ by more
DP_RTOL = 2e-4
# the sharded renders: slices n per render, and the gaussian-sharded
# render's width, the nearest 360-degree width whose 4 slices hold whole
# 16-pixel tile columns (1030 = 2 x 515 divides into no such slices)
SHARD_SLICES = {"hfov": 2, "sh": 2, "gaussian": 4}
GSHARD_WIDTH = 1024
# the JAX test's bars (tests/test_parallel_pano.py:48-60), times 1 + the
# reference's mean magnitude
PANO_MEAN_BAR, PANO_TAIL_BAR = 2e-4, 5e-3
# the hfov-sliced and SH-sharded renders' slices of 515 columns do not
# start on the unsliced render's 16-pixel tile grid, and a splat is
# clipped at its tight rect's edge tile (see ``stitch_vs_360``), which the
# two layouts put in other columns: so they are held to the JAX test's
# mean bar over every pixel and to its tail bar over the columns >=
# STITCH_EDGE_MARGIN px from every tile-column edge of either layout (the
# seam is one), where at most STITCH_MAX_INTERIOR of the pixels may lie
# outside phase 3's tolerances (the JAX test's slices of 64 columns keep
# to the grid; so do the gaussian-sharded render's, held to both bars
# over every pixel)


def phase_nccl(device):
    """(a) NCCL: a world-size-1 group on the card; no fallback to gloo."""
    import torch
    import torch.distributed as dist
    from gslidar_tpu_torch.parallel.shard import init_group
    if not dist.is_nccl_available():
        raise RuntimeError("torch.distributed has no NCCL on this machine")
    group = init_group(device)
    x = group.all_reduce([torch.arange(4.0, device=device)])[0]
    torch.cuda.synchronize()
    if (group.backend != "nccl" or group.size != 1
            or x.tolist() != [0.0, 1.0, 2.0, 3.0]):
        raise RuntimeError(f"NCCL group: backend {group.backend}, size "
                           f"{group.size}, all_reduce {x.tolist()}")
    say(13, f"NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}: a group "
            f"of {group.size} rank on {device} ({group.backend}), one "
            f"all_reduce through it")
    return group


def phase_dp_train(device, init_params, group, smi):
    """(b) ``training`` with data_parallel=true and DP_CAMERAS cameras per
    step for DP_ITERATIONS steps of the seeded 1M-gaussian model (the
    launch and collective counts set to 0 just before and read just
    after); then, from the initial state, one DP step against DP_CAMERAS
    sequential single-camera steps, one camera's kernels against their
    plain versions, and the timings. Returns the kernels' largest errors
    and the run's launches."""
    import math
    import random
    import shutil
    import statistics
    import numpy as np
    import torch
    import gslidar_tpu_torch.raster.composite_op as co
    from gslidar_tpu_torch.engine.train import (camera_to_batch,
                                                init_train_state,
                                                make_train_step)
    from gslidar_tpu_torch.microbench.timing import time_ms
    from gslidar_tpu_torch.models import gaussians as G
    from gslidar_tpu_torch.models.gaussians import PARAM_KEYS
    from gslidar_tpu_torch.models.optim import group_lrs
    from gslidar_tpu_torch.models.raydrop_prior import init_raydrop_prior
    from gslidar_tpu_torch.parallel.shard import (camera_at,
                                                  make_parallel_train_step,
                                                  stack_camera_batch)
    from gslidar_tpu_torch.render import gaussian_config, raster_settings
    from gslidar_tpu_torch.train import training

    run = os.path.join(REPO, "build", "chip_smoke_dp")
    shutil.rmtree(run, ignore_errors=True)
    args = train_args(run, DP_ITERATIONS, DP_RUN)
    random.seed(SEED)
    np.random.seed(SEED)
    rec = dict(reduces=[], step_ms={}, events={})
    bad, moved = [], {}
    lrs = group_lrs(args, 1)

    def mark():
        torch.cuda.synchronize()
        rec["t"] = time.perf_counter()

    def on_step(iteration, state, loss, log, grads):
        torch.cuda.synchronize()
        rec["step_ms"][iteration] = (time.perf_counter() - rec["t"]) * 1e3
        steps.step()
        rec["reduces"].append(group.calls["all_reduce"])
        rec["events"][iteration] = []
        if not (math.isfinite(float(loss)) and all(
                bool(torch.isfinite(g).all()) for g in grads.values())):
            bad.append(f"non-finite loss or gradient at {iteration}")
        if iteration == 1:          # before any densify reorders rows
            moved.update({k: (not torch.equal(state.params[k],
                                              init_params[k]),
                              bool(grads[k].any()) and lrs[k] != 0)
                          for k in PARAM_KEYS})
        mark()

    def on_event(iteration, name, state, info):
        steps.skip(name)
        rec["events"][iteration].append(name)
        mark()

    set_launch_counts()
    group.calls.clear()
    steps = StepLaunches()
    mark()
    t0 = time.perf_counter()
    state, scene, losses = training(args, device, init_params=init_params,
                                    on_step=on_step, on_event=on_event,
                                    group=group)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    reduces = [b - a for a, b in zip([0] + rec["reduces"], rec["reduces"])]
    fired = {it: ev for it, ev in rec["events"].items() if ev}
    say(13, f"data-parallel training through training(): {len(losses)} "
            f"steps of {DP_CAMERAS} cameras from {NUM_GAUSSIANS} gaussians "
            f"at {HW[0]}x{HW[1]} (" + ", ".join(DP_RUN) + f") | events "
            f"{fired} | launches {launches_text(launches)}, per step "
            f"{steps.per_step} (and {steps.other[0]} compositor forwards of "
            f"the depth visualizations and the eval), Adam per step "
            f"{steps.adam} | all_reduce per step {reduces} | loss "
            f"{[round(x, 5) for x in losses]} | moved by step 1 "
            f"{sorted(k for k in moved if moved[k][0])} | median step "
            f"{_median_ms(rec['step_ms'], range(2, DP_ITERATIONS + 1)):.3f} "
            f"ms (host clock, synchronised) | {wall_s:.2f} s")
    shutil.rmtree(run, ignore_errors=True)
    core = ("xyz", "f_dc", "opacity", "scaling", "rotation")
    adam_ok, ADAM_BY_PATH["data-parallel training (phase 13)"] = (
        steps.held())
    graph_ok, GRAPHS_BY_PATH["data-parallel training (phase 13)"] = (
        steps.graphs_held(DP_CAMERAS))
    say(13, "loss graphs: "
        f"{GRAPHS_BY_PATH['data-parallel training (phase 13)']}")
    if (bad or len(losses) != DP_ITERATIONS
            or any(d != (DP_CAMERAS,) * len(ONE_STEP) for d in steps.per_step)
            or not adam_ok or not graph_ok
            or any(r != 2 for r in reduces)
            or "densify" not in rec["events"].get(8, [])
            or "eval" not in rec["events"].get(DP_ITERATIONS, [])
            or not all(moved[k][0] and moved[k][1] for k in core)
            or any(m != expect for m, expect in moved.values())):
        raise RuntimeError(f"the data-parallel training run failed its "
                           f"checks: {bad}, per step {steps.per_step}, "
                           f"all_reduce per step {reduces}, events {fired}")

    # one DP step against DP_CAMERAS sequential steps from one state (the
    # prior frozen, so that the sequential steps see the DP step's inputs)
    h, w = HW
    cmp_args = train_args(run, DP_ITERATIONS, DP_RUN
                          + ["raydrop_prior_lr=0.0"])
    cfg = gaussian_config(cmp_args)
    settings = raster_settings(cmp_args, h, w)
    bg = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
    n = init_params["xyz"].shape[0]
    state0 = init_train_state(init_params, G.GaussianAux.zeros(n, device),
                              init_raydrop_prior(h, w, device))
    batch = stack_camera_batch([camera_to_batch(c, device) for c in
                                scene.get_train_cameras()[:DP_CAMERAS]])
    shifts = [0.0] * DP_CAMERAS
    it = DP_COMPARE_ITERATION
    dp_step = make_parallel_train_step(cmp_args, cfg, settings, bg, group,
                                       n_cameras=DP_CAMERAS)
    seq_step = make_train_step(cmp_args, cfg, settings, bg)
    captured = []
    bwd_orig = co.composite_backward

    def bwd_keep(*a):
        captured.append(a)
        return bwd_orig(*a)

    co.composite_backward = bwd_keep
    try:
        dp_state, _, _, dp_grads = dp_step(state0, batch, it, SH_DEGREE,
                                           shifts, True, False)
    finally:
        co.composite_backward = bwd_orig
    s, seq_grads = state0, []
    for i in range(DP_CAMERAS):
        s, _, _, g = seq_step(s, camera_at(batch, i), it, SH_DEGREE,
                              shifts[i], True, apply_update=False)
        seq_grads.append(g)
    torch.cuda.synchronize()

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))
    equal = {k: bool(torch.equal(getattr(dp_state.aux, k),
                                 getattr(s.aux, k)))
             for k in ("denom", "max_radii2D")}
    accum = {k: rel(getattr(dp_state.aux, k), getattr(s.aux, k))
             for k in ("xyz_gradient_accum", "t_gradient_accum")}
    grad_err = {k: rel(g, sum(sg[k] for sg in seq_grads) / DP_CAMERAS)
                for k, g in dp_grads.items()
                if bool(sum(sg[k] for sg in seq_grads).any())}
    say(13, f"one DP step of {DP_CAMERAS} cameras vs {DP_CAMERAS} sequential "
            f"single-camera steps from one state (iteration {it}, "
            f"statistics on): equal {equal}, denom max "
            f"{float(dp_state.aux.denom.max())} | |dp - seq| / |seq| "
            f"{json.dumps({k: float(f'{v:.3g}') for k, v in accum.items()})}"
            f" | gradient vs the sequential mean, by group "
            f"{json.dumps({k: float(f'{v:.3g}') for k, v in grad_err.items()})}"
            f" (bar {DP_RTOL})")
    if not (all(equal.values()) and float(dp_state.aux.denom.max()) > 0
            and max(accum.values()) <= DP_RTOL
            and max(grad_err.values()) <= DP_RTOL):
        raise RuntimeError("the data-parallel step disagrees with the "
                           "sequential steps")
    del dp_state, s, seq_grads

    # camera 0's kernels against their plain versions, at phase 7's bars
    saved = launch_counts()
    rows, starts, fwd, _, params8, st, C, S, ckpt = captured[0]
    ok_f, summ_f, _, _ = run_pair(rows, starts, params8, st, C, S)
    ok_b, summ_b = run_bwd_pair(rows, starts, fwd,
                                random_cotangents(st, C, S, SEED + 23,
                                                  device),
                                params8, st, C, S, ckpt)
    set_launch_counts(saved)
    del captured
    for kind, ok, summ in (("forward", ok_f, summ_f),
                           ("backward", ok_b, summ_b)):
        say(13, f"{kind} kernel vs plain on the DP step's camera 0 "
                f"({rows.shape[0]} instances): {'ok' if ok else 'FAIL'} "
                f"{json.dumps(summ)}")
    if not (ok_f and ok_b):
        raise RuntimeError("a kernel disagrees with its plain version on "
                           "the data-parallel step")

    # the DP step against one single-camera step, in turns
    def dp():
        dp_step(state0, batch, it, SH_DEGREE, shifts, True)

    def single():
        seq_step(state0, camera_at(batch, 0), it, SH_DEGREE, 0.0, True)
    dp(), single()
    torch.cuda.reset_peak_memory_stats()
    dp()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = {"dp": [], "single": []}
    for _ in range(5):
        for k, fn in (("dp", dp), ("single", single), ("single", single),
                      ("dp", dp)):
            ms[k].append(time_ms(fn, device))
    med = {k: statistics.median(v) for k, v in ms.items()}
    say(13, f"timing on {smi} (CUDA events, median of {len(ms['dp'])}): "
            f"DP step of {DP_CAMERAS} cameras {med['dp']:.3f} ms "
            f"({med['dp'] / DP_CAMERAS:.3f} ms per camera), single-camera "
            f"step {med['single']:.3f} ms | peak memory of the DP step "
            f"{peak_gb:.2f} GiB")
    return (summ_f["raw_max_abs_err"], summ_b["raw_max_abs_err"], launches,
            med, peak_gb)


def phase_dp_cli(device):
    """(c) ``python -m torch.distributed.run --nproc_per_node=1 -m
    gslidar_tpu_torch.train`` on configs/synthetic_smoke.yaml with
    data_parallel=true and 2 cameras per step: 12 steps, a densify at 8,
    the checkpoint and the final eval at 12; read from its log.txt."""
    import shutil
    import sys
    env = dict(os.environ, PYTHONPATH=REPO)
    run = os.path.join(REPO, "build", "chip_smoke_dp_cli")
    shutil.rmtree(run, ignore_errors=True)
    backend = "nccl" if device.type == "cuda" else "gloo"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=1", "-m", "gslidar_tpu_torch.train",
           "--config", "configs/synthetic_smoke.yaml", "--skip_refine",
           *(["--device", "cpu"] if device.type == "cpu" else []),
           "iterations=12", "densify_from_iter=4", "densification_interval=4",
           "densify_until_iter=10", f"seed={SEED}", f"model_path={run}",
           "data_parallel=true", "data_parallel_cameras=2"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    lines = [""]
    if os.path.exists(os.path.join(run, "log.txt")):
        with open(os.path.join(run, "log.txt")) as f:
            lines = f.read().strip().splitlines() or [""]
    dp_line = [ln for ln in lines if ln.startswith("[data_parallel]")] or [""]
    densify = [ln for ln in lines if "] densify:" in ln]
    trained = [ln for ln in lines if ln.startswith("trained ")] or [""]
    need = [os.path.join(run, "eval", "test_12_render", "metrics.json"),
            os.path.join(run, "ckpt", "chkpnt12.npz")]
    say(13, f"data-parallel CLI under torch.distributed.run: rc "
            f"{r.returncode} in {wall_s:.1f} s | {dp_line[0]} | "
            f"{' | '.join(densify)} | {trained[-1]} | present: "
            f"{[os.path.relpath(q, run) for q in need if os.path.exists(q)]}")
    if (r.returncode != 0
            or dp_line[0] != f"[data_parallel] 2 cameras/iter over 1 ranks "
                             f"({backend})"
            or not any(ln.startswith("[8] densify:") for ln in densify)
            or "trained 12 steps" not in trained[-1]
            or not all(os.path.exists(q) for q in need)):
        raise RuntimeError(f"the data-parallel CLI failed:\n"
                           f"{chr(10).join(lines[-30:])}\n{r.stdout[-2000:]}"
                           f"\n{r.stderr[-3000:]}")
    shutil.rmtree(run, ignore_errors=True)


def _pano_bars(ref, got, cols=None):
    """The JAX test's measures of got against ref, per plane: (mean |d|,
    99.9th percentile of |d|) over 1 + mean |ref|, on the columns
    ``cols`` (a [W] bool mask; all when None)."""
    import torch
    out = {}
    for name in ("color", "feature", "depth", "alpha", "final_T"):
        a, b = getattr(ref, name).float(), got[name].float()
        if cols is not None:
            a, b = a[..., cols], b[..., cols]
        d = (a - b).abs().flatten()
        scale = 1.0 + float(a.abs().mean())
        k = max(int(round(0.999 * (d.numel() - 1))), 0)
        out[name] = (float(d.mean()) / scale,
                     float(torch.kthvalue(d.cpu(), k + 1).values) / scale)
    return out


def slice_edge_distance(W, n, tile_w):
    """Per column of a W-wide 360-degree panorama, the distance in pixels
    to the nearest tile-column edge of the unsliced grid or of any of its
    n slices' grids (each slice W/n wide, its grid starting at its first
    column), around the seam."""
    import numpy as np
    Wl = W // n
    edges = set(range(0, W, tile_w))
    for d in range(n):
        edges |= set(range(d * Wl, (d + 1) * Wl, tile_w))
    c = np.arange(W)
    return np.min([np.minimum((c - e) % W, (e - 1 - c) % W)
                   for e in edges], axis=0)


def _edge_check(ref, got, dist):
    """phase 4's stitch check: the pixels outside phase 3's tolerances
    (color, features and alpha at 2 x ATOL, as T may stop on either side
    of the 1e-4 floor; mean depth at DEPTH_ATOL + DEPTH_RTOL |d|), by
    their columns' distance ``dist`` to a tile-column edge: (the share of
    them < STITCH_EDGE_MARGIN from an edge, the share of the pixels >=
    STITCH_EDGE_MARGIN from every edge that are out, the counts by
    distance)."""
    import numpy as np
    over = [np.abs(got[k].cpu().numpy() - getattr(ref, k).cpu().numpy())
            > 2 * ATOL for k in ("color", "feature", "alpha")]
    d0 = ref.depth[0].cpu().numpy()
    over.append((np.abs(got["depth"][0].cpu().numpy() - d0)
                 > DEPTH_ATOL + DEPTH_RTOL * np.abs(d0))[None])
    bad = np.any([o.any(axis=0) for o in over], axis=0)       # [H, W]
    interior = dist >= STITCH_EDGE_MARGIN
    by_dist = np.bincount(dist[np.nonzero(bad)[1]],
                          minlength=STITCH_EDGE_MARGIN + 1)
    at_edges = (float(by_dist[:STITCH_EDGE_MARGIN].sum() / by_dist.sum())
                if by_dist.sum() else 1.0)
    return at_edges, float(bad[:, interior].mean()), by_dist.tolist()


def phase_sharded_renders(args, params, alive, cam, group, smi):
    """(d) The three sharded 360-degree renders of phase 4's model from
    camera ``cam``: hfov-sliced and SH-sharded at n = 2 on 66x1030, the
    gaussian-sharded at n = 4 on 66x1024, each through the loopback (all n
    slices on this card) and through ``group`` (NCCL, n = 1), against the
    unsliced render of the same settings; the forward kernel's launches
    must rise by n per render; one slice's forward against its plain
    version; each slice's stages timed. Returns the forward's largest
    error and the launches."""
    import dataclasses
    import statistics
    import torch
    import gslidar_tpu_torch.parallel.pano_shard as ps
    import gslidar_tpu_torch.raster.composite_op as co
    from gslidar_tpu_torch.engine.evaluate import wrap360_settings
    from gslidar_tpu_torch.engine.train import camera_to_batch
    from gslidar_tpu_torch.microbench.timing import time_ms
    from gslidar_tpu_torch.models import gaussians as G
    from gslidar_tpu_torch.parallel.comm import Loopback
    from gslidar_tpu_torch.raster.rasterize import rasterize
    from gslidar_tpu_torch.render import gaussian_config, raster_settings

    device = alive.device
    cfg = gaussian_config(args)
    batch = camera_to_batch(cam, device)
    h, w = HW
    s360 = dataclasses.replace(wrap360_settings(raster_settings(args, h, w)),
                               compute_distortion=False)
    s_lin = dataclasses.replace(s360, wrap_x=False)
    s_gs = dataclasses.replace(s360, width=GSHARD_WIDTH)
    bg = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
    with torch.no_grad():
        opacity = G.get_opacity(params)[:, 0]
        inputs = (G.get_xyz_shm(params, batch.timestamp, cfg),
                  G.get_scaling(params), params["rotation"], opacity,
                  G.get_features(params),
                  torch.cat([torch.clamp_max(G.get_scaling_t(params), 2.0),
                             G.get_inst_velocity(params, cfg)], 1),
                  alive & (opacity > 1.0 / 255.0), batch.viewmat,
                  batch.campos, bg, SH_DEGREE, float(args.scale_factor))
        refs = {"hfov": rasterize(*inputs, s_lin),
                "gaussian": rasterize(*inputs, s_gs)}
    refs["sh"] = refs["hfov"]
    settings = {"hfov": s_lin, "sh": s_lin, "gaussian": s_gs}

    fns = {"hfov": ps.render_pano_sharded, "sh": ps.render_pano_sh_sharded,
           "gaussian": ps.render_pano_gaussian_sharded}

    captured = []
    fwd_orig = (co.composite_forward, ps.composite_forward)

    def fwd_keep(*a, **k):
        captured[:] = [a]
        return fwd_orig[0](*a, **k)

    results, bad, all_launches = {}, [], [0] * len(LAUNCH_COUNTERS)
    co.composite_forward = ps.composite_forward = fwd_keep
    try:
        for kind, n in SHARD_SLICES.items():
            for label, grp in (("loopback", Loopback(n)), ("nccl", group)):
                stats = {}
                kw = dict(stats=stats) if kind == "gaussian" else {}
                set_launch_counts()
                with torch.no_grad():
                    out = fns[kind](*inputs, settings[kind], grp, **kw)
                torch.cuda.synchronize()
                launched = launch_counts()
                all_launches = [a + b for a, b in zip(all_launches, launched)]
                got = dict(zip(("color", "feature", "depth", "alpha",
                                "contrib", "final_T"), out))
                bars = _pano_bars(refs[kind], got)
                dropped = out[6] if kind == "gaussian" else 0
                ok = (launched == (grp.size, 0, grp.size, 0, 0, 0)
                      and dropped == 0 and all(
                          m < PANO_MEAN_BAR for m, _ in bars.values()))
                r = dict(slices=grp.size, launches=launched,
                         mean_and_tail={k: [float(f"{x:.3g}") for x in v]
                                        for k, v in bars.items()})
                if kind == "gaussian":
                    ok = ok and all(t < PANO_TAIL_BAR
                                    for _, t in bars.values())
                else:
                    dist = slice_edge_distance(s_lin.width, grp.size,
                                               s_lin.tile_w)
                    inner = _pano_bars(refs[kind], got, torch.as_tensor(
                        dist >= STITCH_EDGE_MARGIN, device=device))
                    at_edges, interior, by_dist = _edge_check(
                        refs[kind], got, dist)
                    ok = ok and interior <= STITCH_MAX_INTERIOR and all(
                        t < PANO_TAIL_BAR for _, t in inner.values())
                    r.update(interior_mean_and_tail={
                                 k: [float(f"{x:.3g}") for x in v]
                                 for k, v in inner.items()},
                             out_of_tolerance_by_px_to_an_edge=by_dist,
                             share_at_edges=round(at_edges, 4),
                             interior_share_out=float(f"{interior:.3g}"))
                results[(kind, label)] = dict(
                    r, ok=ok, num_dropped=dropped,
                    per_slice={d: stats[d] for d in sorted(stats)})
                if not ok:
                    bad.append((kind, label))
                if label == "loopback":
                    results[(kind, "captured")] = captured[0]
    finally:
        co.composite_forward, ps.composite_forward = fwd_orig
    for (kind, label), r in results.items():
        if label != "captured":
            say(13, f"{kind} render, {label} ({r['slices']} slices of "
                    f"{settings[kind].height}x{settings[kind].width}) vs "
                    f"the unsliced render: {'ok' if r['ok'] else 'FAIL'} "
                    + json.dumps({k: v for k, v in r.items()
                                  if k not in ("ok", "slices")}))

    # the last slice's forward (the one beside the seam) vs plain
    errs = []
    saved = launch_counts()
    for kind in SHARD_SLICES:
        rows, starts, params8, st, C, S = results[(kind, "captured")][:6]
        ok, summ, _, _ = run_pair(rows, starts, params8, st, C, S)
        errs.append(summ["raw_max_abs_err"])
        say(13, f"forward kernel vs plain on the {kind} render's last slice "
                f"({rows.shape[0]} instances, {st.height}x{st.width}, "
                f"wrap_x {st.wrap_x}, wrap period {st.dxp_wrap_period}, "
                f"angle bounds {[round(x, 6) for x in params8[2:6]]}): "
                f"{'ok' if ok else 'FAIL'} {json.dumps(summ)}")
        if not ok:
            bad.append((kind, "kernel vs plain"))
        del rows, starts
    set_launch_counts(saved)
    del results
    if bad:
        raise RuntimeError(f"the sharded renders failed their checks: {bad}")

    # each slice's stages, timed alone (one of n cards' share of the
    # render, communication excluded), and the unsliced renders
    means, scales, rots, _, shs = inputs[:5]
    stages = {f"unsliced {h}x{s360.width}": lambda: rasterize(*inputs, s360),
              f"unsliced {h}x{s_gs.width}": lambda: rasterize(*inputs, s_gs)}
    n = SHARD_SLICES["hfov"]
    for d in range(n):
        stages[f"hfov slice {d}"] = (
            lambda d=d: ps.hfov_slice_stage(d, n, *inputs, s_lin))
    n = SHARD_SLICES["sh"]
    P = means.shape[0]
    with torch.no_grad():
        colors = torch.cat([ps.sh_colors_stage(
            d, n, means, batch.campos, shs[d * P // n:(d + 1) * P // n],
            SH_DEGREE) for d in range(n)])
    for d in range(n):
        stages[f"sh colors {d}"] = (
            lambda d=d: ps.sh_colors_stage(
                d, n, means, batch.campos, shs[d * P // n:(d + 1) * P // n],
                SH_DEGREE))
        stages[f"sh slice {d}"] = (
            lambda d=d: ps.hfov_slice_stage(d, n, *inputs[:4], None,
                                            *inputs[5:], s_lin,
                                            colors_precomp=colors))
    n = SHARD_SLICES["gaussian"]
    Pl = P // n

    def route(d):
        return ps.route_stage(d, n, *(x[d * Pl:(d + 1) * Pl]
                                      for x in inputs[:7]), *inputs[7:9],
                              *inputs[10:12], s_gs)
    with torch.no_grad():
        sends = [route(d)[0] for d in range(n)]
        recvs = [torch.cat([sends[s][d] for s in range(n)])
                 for d in range(n)]
    for d in range(n):
        stages[f"gaussian route {d}"] = lambda d=d: route(d)
        stages[f"gaussian slice {d}"] = (
            lambda d=d: ps.composite_slice_stage(d, n, recvs[d], inputs[9],
                                                 inputs[11], s_gs))
    ms = {k: [] for k in stages}
    with torch.no_grad():
        for fn in stages.values():             # warm-up
            fn()
        for _ in range(5):
            for k, fn in stages.items():
                ms[k].append(time_ms(fn, device))
    med = {k: statistics.median(v) for k, v in ms.items()}
    say(13, f"timing on {smi} (CUDA events, median of 5; a slice's stage is "
            f"one of n cards' share of the render, communication excluded: "
            f"this card runs the slices one after another, so their sum is "
            f"no multi-GPU latency): " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in med.items()))
    return max(errs), all_launches, med


# --------------------------------------------------------------- phase 14
# KITTI-360 from its raw tree: data/kitti360_tree.py at an HDL-64E sweep's
# density (120,000 returns), data/preprocess/kitti360_to_gs.py, then the
# loader (data/kitti360.py) of each config the repo ships for it
KITTI_POINTS = 120_000
# kitti360_nvs_10750: its widths, lambdas, num_pts (3,000,000) and
# densify_until_num_points (10,000,000) as configured; cut: the cadence
# (statistics from the first step, densify at 20 and 40 while under the
# cap, resets at 12, 24 and 36, the coarse-to-fine steps at 2 and 4, so
# that every step from 5 on is at the full 66x515, the flip at 45, the
# checkpoint and the final eval at 48) and two thresholds the cut cadence
# forces. A densify cuts the gaussians no view saw since the last one,
# and one view sees a small share of this dynamic model (its half of the
# panorama, and the gaussians whose temporal marginal, of scale
# sqrt(0.006) over the 51 frames, reaches its time): 12, 16 and 20 views
# left 16 %, 12 % and 9 % of the gaussians unseen on an H100, so the
# densifies are 20 views apart.
# thresh_opa_prune 0.1 is above the 0.05 init and reset opacity (phase
# 12's finding: a densify so early would prune every gaussian); and
# densify_grad_threshold 1e-4, above which so few steps leave too few
# gaussians to grow the model to its cap, goes to 0: every gaussian seen
# is cloned or split
K10750_ITERATIONS = 48
K10750_RUN = ["densify_from_iter=0", "densification_interval=20",
              "densify_until_iter=44", "opacity_reset_interval=12",
              "scale_increase_interval=2", "thresh_opa_prune=0.005",
              "densify_grad_threshold=0.0"]
K10750_CAP_MIN = 9_500_000        # alive gaussians the run must reach
K10750_CHECK_3M = 7               # a full-width step before the first densify
# kitti360_nvs_1908 through the CLI: num_pts 1,000,000 and every width as
# configured; cut: the cadence (a reset at 6, a densify at 8, the
# checkpoint and the final eval at 12) and the refine epochs
K1908_RUN = ["iterations=12", "densify_from_iter=4",
             "densification_interval=4", "densify_until_iter=10",
             "opacity_reset_interval=6", "test_iterations=[12]",
             "checkpoint_iterations=[12]", "refine_epochs=60"]
ORACLE_GAUSSIANS = 2048
ORACLE_RTOL = 5e-3                # tests/test_raster.py's gradient bar


def oracle_gradients(args, params, cam, device, n, seed):
    """(a) The compositors' gradients against the dense oracle's autograd
    on the card: ``n`` gaussians of ``params`` (seeded, among those the
    camera ``cam``'s 66x515 half view sees), at their own positions,
    scales, rotations and SH, with seeded opacities in [0.2, 0.95] and
    features, through ``rasterize`` (both CUDA compositors) and through
    ``raster.oracle.rasterize_dense``; the loss is tests/test_raster.py's
    against the camera's range panorama. Returns {tensor: the largest
    |a - b| / max |b|}, the instances, and the oracle's seconds and peak
    memory."""
    import numpy as np
    import torch
    import gslidar_tpu_torch.models.gaussians as G
    from gslidar_tpu_torch.engine.train import camera_to_batch
    from gslidar_tpu_torch.raster.oracle import rasterize_dense
    from gslidar_tpu_torch.raster.preprocess import preprocess
    from gslidar_tpu_torch.raster.rasterize import rasterize
    from gslidar_tpu_torch.render import raster_settings
    st = raster_settings(args, cam.height, cam.width)
    batch = camera_to_batch(cam, device)
    sf = float(args.scale_factor)
    with torch.no_grad():
        xyz, scales = params["xyz"], G.get_scaling(params)
        rot, shs = params["rotation"], G.get_features(params)
        ones = torch.ones(xyz.shape[0], device=device)
        prep = preprocess(xyz, scales, rot, ones, shs,
                          torch.ones_like(ones, dtype=torch.bool),
                          batch.viewmat, batch.campos, 3, sf, st)
        seen = torch.nonzero(prep.valid)[:, 0]
    g = torch.Generator(device="cpu").manual_seed(seed)
    pick = seen[torch.randperm(seen.shape[0], generator=g)[:n].to(device)]
    rng = np.random.default_rng(seed)
    leaves = [x[pick].detach().clone().requires_grad_()
              for x in (xyz, scales, rot)]
    leaves.append(torch.as_tensor(rng.uniform(0.2, 0.95, n).astype(
        np.float32), device=device).requires_grad_())
    leaves.append(shs[pick].detach().clone().requires_grad_())
    feats = torch.as_tensor(rng.normal(size=(n, 4)).astype(np.float32),
                            device=device)
    mask = torch.ones(n, dtype=torch.bool, device=device)
    bg = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
    target = batch.pts_depth[0]

    def loss_of(out, dense):
        get = (lambda k: out[k]) if dense else (lambda k: getattr(out, k))
        depth = get("depth")
        return ((depth[0] - target).abs().mean() + (get("color") ** 2).mean()
                + 0.1 * get("alpha").mean() + 0.01 * depth[2].mean())

    tiled = rasterize(*leaves, feats, mask, batch.viewmat, batch.campos, bg,
                      3, sf, st)
    g_tiled = torch.autograd.grad(loss_of(tiled, False), leaves)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dense = rasterize_dense(*leaves, feats, mask, batch.viewmat,
                            batch.campos, bg, 3, sf, st)
    g_dense = torch.autograd.grad(loss_of(dense, True), leaves)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    worst = {}
    for name, a, b in zip(("xyz", "scaling", "rotation", "opacity", "sh"),
                          g_tiled, g_dense):
        scale = float(b.abs().max())
        worst[name] = (float((a - b).abs().max()) / scale if scale > 0
                       else float("inf"))
    return worst, tiled.num_pairs, seconds, peak


def phase_kitti360(smi, device, points=KITTI_POINTS, overrides=(),
                   cap_min=K10750_CAP_MIN, oracle_n=ORACLE_GAUSSIANS,
                   cli_overrides=()):
    """KITTI-360 from its raw tree: (c) kitti360_nvs_10750 at full width,
    in process through ``training`` (the launch counts set to 0 just
    before it and read just after), grown by densify to >= ``cap_min``
    gaussians; (a) the compositors' gradients against the dense oracle on
    the card, on gaussians of that scene; (b) kitti360_nvs_1908 through
    the converter and the training CLI in subprocesses, to metrics.json
    and its refinement; (d) the 2DGS / 3DGS comparison script on the
    card. ``points``, ``overrides``, ``cap_min``, ``oracle_n`` and
    ``cli_overrides`` shrink it for a rehearsal on the CPU. Returns the
    kernels' largest absolute errors against their plain versions (on a
    step at 3M gaussians and one at the cap) and the run's launches."""
    import contextlib
    import math
    import random
    import shutil
    import sys
    import numpy as np
    import torch
    import gslidar_tpu_torch.data.kitti360 as K
    import gslidar_tpu_torch.raster.composite_op as co
    import gslidar_tpu_torch.train as T
    from gslidar_tpu_torch.data.kitti360_tree import write_kitti360_tree
    from gslidar_tpu_torch.data.preprocess import kitti360_to_gs
    from gslidar_tpu_torch.engine.checkpoint import load_train_state
    from gslidar_tpu_torch.engine.evaluate import make_eval_render360
    from gslidar_tpu_torch.engine.train import camera_to_batch
    from gslidar_tpu_torch.render import gaussian_config, raster_settings
    from gslidar_tpu_torch.scripts import compare_2dgs_3dgs

    root = os.path.join(REPO, "build", "chip_smoke_kitti360")
    shutil.rmtree(root, ignore_errors=True)
    phase_t0 = time.perf_counter()

    # ------------------------------------------------ (c) 10750, full width
    data, run = os.path.join(root, "data10750"), os.path.join(root, "run")
    s_frame, e_frame, _ = K.SEQ_TABLE["10750"]
    t0 = time.perf_counter()
    kitti, n_written = write_kitti360_tree(data, s_frame, e_frame, points,
                                           skip_poses=False)
    tree_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(None):
        kitti360_to_gs.main("10750", kitti, data)
    convert_s = time.perf_counter() - t0
    args = T.load_args(os.path.join(REPO, "configs",
                                    "kitti360_nvs_10750.yaml"),
                       os.path.join(REPO, "configs", "base.yaml"),
                       [f"source_path={data}", f"model_path={run}",
                        f"iterations={K10750_ITERATIONS}", f"seed={SEED}",
                        *K10750_RUN, *overrides])
    random.seed(SEED)
    np.random.seed(SEED)            # the loader's subsample and colors
    rec = dict(n={}, events={}, densify={}, ckpt={}, eval_s={}, pairs={},
               checked={})
    bad, cuda_ms, step_ms, held = [], [], [], {}
    capture = dict(armed=False)
    saved_fns = (K.read_kitti360_info, T.build_scene, T.create_from_pcd,
                 T.make_train_step, T.make_densify_fn, co.composite_backward)

    def timed(name, fn):
        def run_timed(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            rec[name] = time.perf_counter() - t
            return out
        return run_timed

    def create_keep(*a, **k):
        params, aux = timed("create_s", saved_fns[2])(*a, **k)
        rec["init"] = {key: v.clone() for key, v in params.items()}
        stage("create_from_pcd")
        return params, aux

    def make_step(*a, **k):                    # the step by CUDA events
        return cuda_timed(saved_fns[3](*a, **k), step_ms)

    def make_densify(*a, **k):                 # the densify by CUDA events
        return cuda_timed(saved_fns[4](*a, **k), cuda_ms)

    def bwd_keep(*a):
        if capture["armed"]:
            capture["bwd"] = a
        return saved_fns[5](*a)

    stages = Stages()
    stage = stages.close

    def check_kernels(iteration, n):
        st = capture["bwd"][5]
        failed, err_f, err_b = check_step_kernels(
            14, f"on kitti360_nvs_10750 step {iteration}, {n} gaussians at "
                f"{st.height}x{st.width}", capture.pop("bwd"), SEED + 29)
        bad.extend(f"{kind} kernel vs plain at {iteration}"
                   for kind in failed)
        rec["checked"][iteration] = (n, err_f, err_b)

    def on_step(iteration, state, loss, log, grads):
        stage("step")
        steps.step()
        n = state.params["xyz"].shape[0]
        rec["n"][iteration] = n
        rec["pairs"][iteration] = log["num_pairs"]
        rec["events"][iteration] = []
        if not (math.isfinite(float(loss)) and all(
                bool(torch.isfinite(g).all()) for g in grads.values())):
            bad.append(f"non-finite loss or gradient at {iteration}")
        if capture["armed"]:
            capture["armed"] = False
            check_kernels(iteration, n)
        capture["armed"] = iteration + 1 == K10750_CHECK_3M
        stage("hook")

    def on_event(iteration, name, state, info):
        seconds = stage(name)
        steps.skip(name)
        rec["events"][iteration].append(name)
        if name == "densify":
            rec["densify"][iteration] = dict(info, cuda_ms=cuda_ms[-1])
            capture["armed"] = info["after"] >= cap_min
        elif name == "checkpoint":
            rec["ckpt"][iteration] = info
            held[iteration] = state
        elif name == "eval":
            rec["eval_s"][iteration] = (seconds, info)
        stage("hook")

    torch.cuda.empty_cache()
    (K.read_kitti360_info, T.build_scene, T.create_from_pcd,
     T.make_train_step, T.make_densify_fn, co.composite_backward) = (
        timed("loader_s", saved_fns[0]), timed("scene_s", saved_fns[1]),
        create_keep, make_step, make_densify, bwd_keep)
    try:
        set_launch_counts()
        steps = StepLaunches()
        stages.start()
        t0 = time.perf_counter()
        state, scene, losses = T.training(args, device, on_step=on_step,
                                          on_event=on_event)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        (K.read_kitti360_info, T.build_scene, T.create_from_pcd,
         T.make_train_step, T.make_densify_fn,
         co.composite_backward) = saved_fns
    per_step = steps.per_step
    step_ms = dict(enumerate(step_ms, start=1))
    n_points = len(scene.scene_info.point_cloud[0])
    n_test = len(scene.scene_info.test_cameras) // 2
    n_train = len(scene.get_train_cameras()) // 2
    h, w = args.hw
    n_final = state.params["xyz"].shape[0]

    nts, wrong = bool(args.no_time_split), []
    for it in range(1, K10750_ITERATIONS + 1):
        want = T.schedule(args, it, rec["n"][it], nts)
        got = [e for e in rec["events"][it] if e not in ("vis", "eval")]
        if got != want:
            wrong.append((it, got, want))
        nts = nts and "flip" not in got
    fired = {it: ev for it, ev in rec["events"].items() if ev}
    say(14, f"(c) kitti360_nvs_10750 on {smi}: raw tree of {n_written} "
            f"points ({e_frame + 1 - s_frame} sweeps of {points}) written "
            f"in {tree_s:.1f} s, converted in {convert_s:.2f} s; the loader "
            f"kept {n_points} in {rec['loader_s']:.1f} s (scene with its GT "
            f"panoramas {rec['scene_s']:.1f} s: {n_train} train and "
            f"{n_test} test pairs, {h}x{w} and coarser); create_from_pcd "
            f"{rec['create_s']:.1f} s")
    dens = sorted(rec["densify"])
    say(14, f"training kitti360_nvs_10750: {len(losses)} steps ("
            + ", ".join(K10750_RUN) + f") | events {fired} | launches "
            f"{launches_text(launches)}, per step {per_step} (and "
            f"{steps.other[0]} compositor forwards of the depth "
            f"visualizations and the final eval), Adam per step "
            f"{steps.adam} | gaussians per step "
            f"{[rec['n'][i] for i in sorted(rec['n'])]} | instances per "
            f"step {[rec['pairs'][i] for i in sorted(rec['pairs'])]} | loss "
            f"{[round(x, 5) for x in losses]} | {wall_s:.1f} s with set-up")
    for it, c in rec["densify"].items():
        say(14, f"densify at {it}: {c['before']} -> {c['after']} gaussians: "
                f"never visible -{c['never_visible']}, clones "
                f"{c['clones']}, splits {c['splits']}, new +{c['new']}, "
                f"opacity prune -{c['opacity_pruned']}, world-size prune "
                f"-{c['world_size_pruned']} | {c['cuda_ms']:.3f} ms by CUDA "
                f"events on {smi}")
    at_3m = [i for i in step_ms if i > 4 and i < (dens or [99])[0]
             and rec["n"][i] == n_points]
    at_cap = [i for i in step_ms if rec["n"][i] >= cap_min
              and (not dens or i > dens[-1])]
    say(14, f"step time on {smi} (CUDA events, median): at {n_points} "
            f"gaussians (steps {at_3m}, {h}x{w}) "
            f"{_median_ms(step_ms, at_3m):.3f} ms; at the cap "
            f"(steps {at_cap}, {[rec['n'][i] for i in at_cap][:1]} "
            f"gaussians) {_median_ms(step_ms, at_cap):.3f} ms; every "
            f"step {[round(step_ms[i], 2) for i in sorted(step_ms)]}")

    # the checkpoint at the cap reloads bit for bit
    t0 = time.perf_counter()
    loaded, it_l = load_train_state(rec["ckpt"][K10750_ITERATIONS]["path"],
                                    device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    same = it_l == K10750_ITERATIONS and states_equal(
        loaded, held.pop(K10750_ITERATIONS))
    del loaded, held
    stage("checkpoint load")

    # a 360-degree render at the cap (the serving path), CUDA events
    cfg = gaussian_config(args, no_time_split=False)
    render360 = make_eval_render360(args, cfg, raster_settings(args, h, w),
                                    torch.tensor([0.0, 0.0, 0.0, 1.0],
                                                 device=device))
    cam = scene.get_test_cameras(1)[0]
    batch = camera_to_batch(cam, device)
    saved_l = launch_counts()
    render_ms = []
    for _ in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        pkg = render360(state.params, state.aux.alive, state.prior, batch,
                        args.sh_degree)
        ev[1].record()
        torch.cuda.synchronize()
        render_ms.append(ev[0].elapsed_time(ev[1]))
    render_launches = [n - m for n, m in zip(launch_counts(), saved_l)]
    render_pairs = pkg.num_pairs
    set_launch_counts(saved_l)
    stage("render")

    eval_s, results = rec["eval_s"].get(K10750_ITERATIONS, (0.0, {}))
    finite = bool(results) and all(
        math.isfinite(x) for split in results.values()
        for x in floats(split))
    say(14, f"at the cap ({n_final} gaussians) on {smi}: checkpoints "
            + ", ".join(f"{it}: {c['bytes']} bytes saved in "
                        f"{c['seconds']:.2f} s"
                        for it, c in sorted(rec["ckpt"].items()))
            + f", loaded in {load_s:.2f} s, every leaf bit for bit as saved: "
              f"{same} | the final eval ({n_test} test + {n_train} train "
              f"pairs at {h}x{2 * w}) {eval_s:.2f} s, metrics finite "
              f"{finite}: " + json.dumps({k: {m: v[m] for m in (
                  "Ray drop", "Depth")} for k, v in results.items()})
            + f" | 360-degree render at {h}x{2 * w}: "
              f"{statistics.median(render_ms[1:]):.3f} ms (median of 3 after "
              f"one, CUDA events), {render_pairs} instances, "
              f"launches {launches_text(render_launches)} for 4 renders | "
              f"peak "
              f"memory by stage (GiB) "
            + json.dumps({k: round(v, 2) for k, v in stages.peak.items()}))
    init = rec.pop("init")
    del state, pkg
    torch.cuda.empty_cache()

    # ---------------------------------------- (a) gradients vs the oracle
    saved_l = launch_counts()
    worst, pairs_a, oracle_s, oracle_peak = oracle_gradients(
        args, init, cam, device, oracle_n, SEED + 31)
    oracle_launches = tuple(n - m for n, m in zip(launch_counts(), saved_l))
    set_launch_counts(saved_l)
    # one preprocess picks the gaussians the view sees, then rasterize
    oracle_ok = oracle_launches == (1, 1, 2, 1, 0, 0) and all(
        v <= ORACLE_RTOL for v in worst.values())
    say(14, f"(a) CUDA compositors' gradients vs the dense oracle's "
            f"autograd on {smi}: {oracle_n} gaussians of the 10750 scene "
            f"in test camera {cam.colmap_id}'s {cam.height}x{cam.width} "
            f"view ({pairs_a} instances; launches {oracle_launches}), "
            f"|a - b| / max|b| per tensor "
            + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()})
            + f", bar {ORACLE_RTOL}: {'ok' if oracle_ok else 'FAIL'} | the "
              f"oracle's forward and backward {oracle_s:.1f} s, peak "
              f"{oracle_peak:.2f} GiB")
    del init
    torch.cuda.empty_cache()

    # ------------------------------------------- (b) 1908 through the CLI
    data8, run8 = os.path.join(root, "data1908"), os.path.join(root, "run8")
    s8, e8, _ = K.SEQ_TABLE["1908"]
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    kitti8, n8 = write_kitti360_tree(data8, s8, e8, points,
                                     skip_poses=False)
    tree8_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "gslidar_tpu_torch.data.preprocess.kitti360_to_gs",
                        "--seq", "1908", "--kitti_root", kitti8, "--out",
                        data8], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    convert8_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"kitti360_to_gs failed:\n{r.stderr[-3000:]}")
    cmd = [sys.executable, "-m", "gslidar_tpu_torch.train", "--config",
           "configs/kitti360_nvs_1908.yaml", f"source_path={data8}",
           f"model_path={run8}", f"seed={SEED}", "--device", str(device),
           *K1908_RUN, *cli_overrides]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=900)
    cli_s = time.perf_counter() - t0
    log_path = os.path.join(run8, "log.txt")
    lines = [""]
    if os.path.exists(log_path):
        with open(log_path) as f:
            lines = f.read().strip().splitlines() or [""]
    pick = [ln for ln in lines if ln.startswith(("[scene]", "[init]",
                                                 "trained "))
            or "] densify:" in ln or ln.startswith(("[ITER 12] eval",
                                                     "[refine]"))]
    iters = int(next(a for a in K1908_RUN if a.startswith(
        "iterations=")).split("=")[1])
    need = [os.path.join(run8, "eval", f"{split}_{iters}_render",
                         "metrics.json") for split in ("test", "train")]
    need += [os.path.join(run8, "ckpt", f"chkpnt{iters}.npz"),
             os.path.join(run8, "ckpt", "refine.npz"),
             os.path.join(run8, "eval", "test_refine_render",
                          "metrics.json")]
    metrics8 = {}
    if os.path.exists(need[0]):
        with open(need[0]) as f:
            metrics8 = json.load(f)
    finite8 = bool(metrics8) and all(math.isfinite(x)
                                     for x in floats(metrics8))
    say(14, f"(b) kitti360_nvs_1908 on {smi}: raw tree of {n8} points "
            f"({e8 + 1 - s8} sweeps) written in {tree8_s:.1f} s, "
            f"kitti360_to_gs {convert8_s:.1f} s; the training CLI ("
            + ", ".join(K1908_RUN) + f") rc {r.returncode} in {cli_s:.1f} s"
            f" | {' | '.join(pick)} | test metrics finite {finite8}: "
            + json.dumps({m: metrics8.get(m) for m in ("Ray drop", "Depth",
                                                       "Point Cloud mix")})
            + f" | present: "
              f"{[os.path.relpath(q, run8) for q in need if os.path.exists(q)]}")
    init8 = "[init] create_from_pcd: " + ("" if cli_overrides
                                         else "1000000 ")
    cli_ok = (r.returncode == 0 and finite8
              and all(os.path.exists(q) for q in need)
              and "Refine complete." in lines
              and any(ln.startswith(init8) for ln in lines)
              and any(ln.startswith(f"trained {iters} steps")
                      for ln in lines))

    # --------------------------------------- (d) the 2DGS / 3DGS comparison
    out = os.path.join(root, "compare_2dgs_3dgs")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(None):
        compare_2dgs_3dgs.main(["--device", str(device), "--out", out])
    torch.cuda.synchronize()
    pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    say(14, f"(d) 2DGS / 3DGS comparison on {smi}: {pngs} written in "
            f"{time.perf_counter() - t0:.2f} s | phase 14 "
            f"{time.perf_counter() - phase_t0:.1f} s")
    shutil.rmtree(root, ignore_errors=True)

    checked = sorted(rec["checked"])
    checks_ok = (checked[:1] == [K10750_CHECK_3M]
                 and rec["checked"][checked[0]][0] == n_points
                 and any(rec["checked"][i][0] >= cap_min
                         for i in checked[1:]))
    adam_ok, ADAM_BY_PATH["kitti360_nvs_10750 training (phase 14)"] = (
        steps.held())
    graph_ok, GRAPHS_BY_PATH["kitti360_nvs_10750 training (phase 14)"] = (
        steps.graphs_held())
    say(14, "loss graphs: " + json.dumps(
        GRAPHS_BY_PATH["kitti360_nvs_10750 training (phase 14)"]))
    if (wrong or bad or len(losses) != K10750_ITERATIONS
            or n_points != args.num_pts or n_test != 4
            or any(d != ONE_STEP for d in per_step)
            or not adam_ok or not graph_ok
            or n_final < cap_min or not at_cap or not at_3m
            or not checks_ok or not same or not finite
            or render_launches != [4, 0, 4, 0, 0, 0]
            or sorted(results) != ["test", "train"]
            or not oracle_ok or not cli_ok
            or pngs != ["case1.png", "case2.png"]):
        raise RuntimeError(
            f"the KITTI-360 phase failed its checks: events off the "
            f"schedule {wrong}, {bad}, final count {n_final} (need "
            f">= {cap_min}), kernel checks at {checked}, checkpoint "
            f"bitwise {same}, eval finite {finite}, oracle {worst} "
            f"{oracle_launches}, CLI rc {r.returncode}:\n"
            f"{chr(10).join(lines[-30:])}\n{r.stderr[-2000:]}")
    errs = [rec["checked"][i] for i in checked]
    return (max(e[1] for e in errs), max(e[2] for e in errs), launches,
            worst)


# ---------------------------------------------------------------- phase 7
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
    from gslidar_tpu_torch.ops.sh import active_coeffs
    from gslidar_tpu_torch.raster import preprocess as pp
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

    # and what the preprocess kernels were given
    pre_orig = (pp._preprocess_kernel, pp._preprocess_backward_kernel)

    def pre_keep(*a):
        captured["pre"] = a
        return pre_orig[0](*a)

    def pre_bwd_keep(*a):
        captured["pre_bwd"] = a
        return pre_orig[1](*a)

    co.bin_gaussians, co.composite_backward = bin_keep, bwd_keep
    pp._preprocess_kernel, pp._preprocess_backward_kernel = (pre_keep,
                                                             pre_bwd_keep)
    try:
        _, _, _, grads = step(state, batch, it, SH_DEGREE, 0.0, True)
    finally:
        co.bin_gaussians, co.composite_backward = bin_orig, bwd_orig
        pp._preprocess_kernel, pp._preprocess_backward_kernel = pre_orig
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

    # the preprocess kernels on the step's own inputs: the forward and a
    # backward of seeded cotangents, then the backward on the step's own
    # cotangents, all against the plain versions
    m, sc_, q, op, shs, colors, _, mask, vm, cam, opts = captured["pre"]
    shs = pp.sh_rows(shs)           # the render's (f_dc, f_rest) blocks
    ok_p, err_pf, _ = say_prep_pair(
        7, f"the training step's inputs ({n} gaussians)", prep_inputs(
            m, sc_, q, op, shs, mask, vm, cam, opts.sh_degree,
            opts.scale_factor, opts.settings, opts.scale_modifier, colors,
            opts.angle_bounds, opts.cull_bounds), SEED + 62)
    bwd_in = captured["pre_bwd"]
    with torch.no_grad():
        saved = launch_counts()
        kern_g = pp._preprocess_backward_kernel(*bwd_in)
        set_launch_counts(saved)
        plain_g = pp.preprocess_backward_reference(
            *bwd_in[:6], opts.sh_degree, *bwd_in[6:9], opts.scale_modifier)
    ok_g, summ_g = compare_prep_grads(kern_g, plain_g)
    say(7, f"preprocess backward kernel vs plain on the step's own "
           f"cotangents ({n} gaussians): {'ok' if ok_g else 'FAIL'} "
           f"{json.dumps(summ_g)}")
    del kern_g, plain_g
    if not (ok_p and ok_g):
        raise RuntimeError("the preprocess kernels disagree with their "
                           "plain versions on the training step")

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
        "preprocess kernel": lambda: pp._preprocess_kernel(
            *captured["pre"]),
        "preprocess backward kernel": lambda: pp._preprocess_backward_kernel(
            *bwd_in),
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
        plain_prep = {"plain preprocess": lambda: pp._preprocess_plain(
            m, sc_, q, op, shs, mask, vm, cam, opts.sh_degree,
            opts.scale_factor, opts.settings, opts.scale_modifier, colors),
            "plain preprocess backward":
                lambda: pp.preprocess_backward_reference(
                    *bwd_in[:6], opts.sh_degree, *bwd_in[6:9],
                    opts.scale_modifier)}
        plain_prep_ms = {}
        for k, fn in plain_prep.items():
            fn()                                    # warm-up
            plain_prep_ms[k] = statistics.median(time_ms(fn, device)
                                                 for _ in range(3))
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
    med.update(plain_prep_ms)
    med["autograd rest"] = (med["backward"] - med["backward kernel"]
                            - med["reduction"])
    passes = forward_pass_ms(stages["forward kernel with checkpoints"])
    idle, busy_ms, wall_ms, top = device_idle_share(stages["step"], 3)
    say(7, f"timing on {smi}, one training step of {n} gaussians "
           f"({rows.shape[0]} instances, {h}x{w}), CUDA events, median of 5: "
           + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items())
           + f" (the plain backward and the plain preprocess: median of 3) "
             f"| peak memory {peak_gb:.2f} GiB")
    say_passes(7, smi, passes, med["forward kernel with checkpoints"])
    say(7, f"torch.profiler over 3 steps: device busy {busy_ms:.3f} ms of "
           f"{wall_ms:.3f} ms per step, idle share {idle:.4f} | by device "
           f"time per step: "
           + ", ".join(f"{k[:60]} {v:.3f} ms" for k, v in top))
    works["preprocess"] = dict(gaussians=n, err_f=err_pf,
                               err_b=summ_g["raw_max_abs_err"],
                               K=shs.shape[1], C=shs.shape[2],
                               n_sh=active_coeffs(opts.sh_degree,
                                                  shs.shape[1]),
                               scale_cols=sc_.shape[1])
    return summ["raw_max_abs_err"], med, works


# ------------------------------------------------------- compositor bounds
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


def say_prep_bounds(prep5, prep7, med7, clock_hz):
    """The least times of the preprocess kernels (``bounds.
    preprocess_bound``): the forward on phase 5's 360-degree view, the
    backward on phase 7's training step, each beside its time there.
    Returns (the forward's Bound, the backward's)."""
    from gslidar_tpu_torch.microbench.bounds import preprocess_bound
    dims = (prep7["n_sh"], prep7["K"], prep7["C"], prep7["scale_cols"])
    out = []
    for label, n, ms, bwd in (
            ("preprocess forward kernel on phase 5's 360-degree view",
             prep5["gaussians"], prep5["med"]["preprocess kernel"], False),
            ("preprocess backward kernel on the training step",
             prep7["gaussians"], med7["preprocess backward kernel"], True)):
        b = preprocess_bound(n, *dims, clock_hz, backward=bwd)
        say(7, f"bound of the {label} ({n} gaussians): {b.ms:.4f} ms, set "
               f"by {b.by} ("
               + ", ".join(f"{k} {v:.4f}" for k, v in b.terms.items())
               + f" ms) | kernel {ms:.3f} ms = {ms / b.ms:.1f}x the bound")
        out.append(b)
    return out


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
    from gslidar_tpu_torch.utils.trace import counters
    runs = {}
    launched = counters().get("launches.gather_rows", 0)
    for name, (P, D, K) in GATHER_SHAPES.items():
        runs[name] = dg.main(["--device", "cuda", "--rows", str(P),
                              "--width", str(D), "--ids", str(K),
                              "--seed", str(SEED)])
    launches = counters().get("launches.gather_rows", 0) - launched
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


# --------------------------------------------------------------- phase 16
CHAMFER_INVALID = 0.1     # share of each cloud's pixels with no return


def chamfer_clouds(device, h=HW[0], w=HW[1], seed=SEED):
    """Two seeded h x w range panoramas' points and masks, as a training
    step's losses make them (ranges 2-40 over a scale factor of 7,
    ``CHAMFER_INVALID`` of the pixels dropped)."""
    import numpy as np
    import torch
    from gslidar_tpu_torch.ops.pano import pano_to_lidar
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        depth = rng.uniform(2, 40, (1, h, w)).astype(np.float32)
        depth[rng.random((1, h, w)) < CHAMFER_INVALID] = 0
        pts, mask = pano_to_lidar(torch.as_tensor(depth, device=device),
                                  VFOV, HFOV)
        out += [pts / 7.0, mask]
    return out


# a distance summed in another order: within 4 ulps (tests/test_torch_chamfer)
CHAMFER_SUM_ORDER = 2.0 ** -21


def run_chamfer(device, clock_hz, h=HW[0], w=HW[1], reps=10):
    """Phase 16's comparison and times on ``chamfer_clouds(device, h,
    w)``; returns the two kernels' rows' numbers for the kernels line."""
    import torch
    from gslidar_tpu_torch.microbench.bounds import (
        CHAMFER_PAIR_FP32, CHAMFER_PAIR_FP32_UNFUSED, chamfer_bound)
    from gslidar_tpu_torch.microbench.timing import median_ms
    from gslidar_tpu_torch.ops import chamfer as ch
    x1, m1, x2, m2 = chamfer_clouds(device, h, w)

    def op(fn):
        a = x1.clone().requires_grad_(True)
        d1, d2, s1, s2 = fn(a, x2, m1, m2)
        grad = torch.autograd.grad(s1 + s2, a)[0]
        return (d1.detach(), d2.detach()), (s1.detach(), s2.detach()), grad

    saved = launch_counts()
    kd, ks, kg = op(ch.chamfer_distance)
    if launch_counts()[4:] != (saved[4] + 1, saved[5] + 1):
        raise RuntimeError(f"the chamfer op launched {launch_counts()[4:]} "
                           f"kernels after {saved[4:]}, not one of each")
    pd, ps, pg = op(ch.chamfer_reference)
    # distances: the same pick's within 4 ulps; a near-tie's pick may
    # differ, and is then never the farther beyond them
    off = sum(int(((k - p).abs() > CHAMFER_SUM_ORDER * p).sum())
              for k, p in zip(kd, pd))
    farther = sum(int((k > p * (1 + CHAMFER_SUM_ORDER)).sum())
                  for k, p in zip(kd, pd))
    mean_err = max(abs(float(k - p)) for k, p in zip(ks, ps))
    mean_rel = max(abs(float(k - p)) / abs(float(p)) for k, p in zip(ks, ps))
    # gradient rows: within 1e-5 of the largest, but where a near-tie's
    # other pick reaches a point
    row_err = (kg - pg).abs().amax(1)
    row_ok = row_err <= 1e-5 * pg.abs().max()
    rows_off = int((~row_ok).sum())
    grad_err = float(row_err[row_ok].max())
    n1, n2 = int(m1.sum()), int(m2.sum())
    dist1, idx1, dist2, idx2 = ch.chamfer_nearest(x1, x2, m1, m2)
    g1 = torch.where(m1, 1.0 / n1, 0.0).float()
    g2 = torch.where(m2, 1.0 / n2, 0.0).float()
    ms = {}
    for _ in range(2):               # in turns: plain, kernels, kernels, plain
        for name, fn in (
                ("plain", lambda: op(ch.chamfer_reference)),
                ("forward kernel", lambda: ch.chamfer_nearest(
                    x1, x2, m1, m2)),
                ("backward kernel", lambda: ch.chamfer_nearest_backward(
                    x1, x2, idx1, idx2, g1, g2, True, False)),
                ("op", lambda: op(ch.chamfer_distance))):
            ms.setdefault(name, []).append(median_ms(fn, device, reps))
    set_launch_counts(saved)
    ms = {k: statistics.median(v) for k, v in ms.items()}
    pair_ms = ms["forward kernel"] + ms["backward kernel"]
    bf, bb = chamfer_bound(n1, n2, clock_hz)
    unfused = bf.terms["fp32"] * CHAMFER_PAIR_FP32_UNFUSED / CHAMFER_PAIR_FP32
    say(16, f"chamfer on {h}x{w} clouds, {n1} and {n2} valid points: "
            f"distances off the plain version's by over 4 ulps {off} of "
            f"{2 * x1.shape[0]}, farther {farther} | means vs plain "
            f"{mean_err:.3g} ({mean_rel:.2e} of them) | gradient rows off "
            f"{rows_off} of {x1.shape[0]}, the others within {grad_err:.3g} "
            f"| median of {reps}: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
            + f" | bounds: forward {bf.ms:.3f} ms ({bf.by}; {unfused:.3f} "
            f"as built, unfused), backward {bb.ms:.4f} ms ({bb.by}); the "
            f"bound at {(bf.ms + bb.ms) / pair_ms:.3f} of the pair's time")
    if (mean_rel > 1e-6 or rows_off > 0.001 * x1.shape[0]
            or off > 0.001 * 2 * x1.shape[0] or farther):
        raise RuntimeError("the chamfer kernels disagree with the plain "
                           "version")
    return dict(ms=ms, bounds=(bf, bb), unfused_ms=unfused,
                errs=(mean_err, grad_err), rows_off=rows_off, dists_off=off)


# --------------------------------------------------------------- phase 17
# both train cells' gaussians: kitti360_nvs_1908's and kitti360_nvs_10750's
# cap (benchmark/configs)
ADAM_POINTS = (1_000_000, 10_000_000)
# an element's moments after 20,000 steps of gradients of this scale
ADAM_COUNT = 20000


def adam_inputs(P, device, seed=SEED):
    """Seeded Adam inputs of P gaussians laid out as the step makes them:
    params, their gradients (f_dc's and f_rest's the column ranges of one
    [P, 16, 4] gradient), moments after ADAM_COUNT steps, and each group's
    rate at kitti360_nvs_10750's iteration 20,001."""
    import torch
    from gslidar_tpu_torch.models.optim import AdamState, group_lrs
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = {"xyz": (3,), "f_dc": (1, 4), "f_rest": (15, 4),
              "opacity": (1,), "scaling": (3,), "rotation": (4,), "t": (1,),
              "scaling_t": (1,), "velocity": (3,), "intensity": (1,)}

    def draw(scale, shape):
        return scale * torch.randn(shape, generator=gen, device=device)

    def groups(scale):
        return {k: draw(scale, (P,) + s) for k, s in shapes.items()}
    grads = groups(1e-3)
    sh = draw(1e-3, (P, 16, 4))
    grads["f_dc"], grads["f_rest"] = sh[:, :1], sh[:, 1:]
    nu = {k: v.abs_() for k, v in groups(1e-7).items()}
    from gslidar_tpu_torch.train import load_args
    args = load_args(os.path.join(REPO, "configs", "kitti360_nvs_10750.yaml"),
                     os.path.join(REPO, "configs", "base.yaml"))
    return (groups(1.0), grads, AdamState(mu=groups(1e-4), nu=nu,
                                          count=ADAM_COUNT),
            group_lrs(args, ADAM_COUNT + 1))


def run_adam(device, clock_hz, reps=10):
    """Phase 17: the Adam kernel (``models/optim.py::adam_step``,
    ``csrc/adam.cu``) at both train cells' gaussians: its new parameters
    and moments against the plain version's bit for bit on every element
    of all ten groups, one launch a call; then the kernel, the plain
    version and ``torch._fused_adam_`` (the library's yardstick, which the
    port never calls: one rate for all groups, over contiguous copies)
    timed in turns, each as ``reps`` calls back to back between two CUDA
    events (the host enqueues ahead of the card, so a call's host time is
    left out where it is the shorter), beside ``adam_bound``. Returns the
    numbers per P for the kernels line."""
    import torch
    from gslidar_tpu_torch.microbench.bounds import adam_bound
    from gslidar_tpu_torch.models import optim

    def loop_ms(fn):
        fn()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(reps):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / reps
    out = {}
    for P in ADAM_POINTS:
        params, grads, state, lrs = adam_inputs(P, device)
        n0 = adam_launches()
        got = optim.adam_step(params, grads, state, lrs)
        launched = adam_launches() - n0
        want = optim.adam_step_reference(params, grads, state, lrs)
        off = {}
        for k in params:
            for a, b in ((got[0][k], want[0][k]),
                         (got[1].mu[k], want[1].mu[k]),
                         (got[1].nu[k], want[1].nu[k])):
                n = int((a.view(torch.int32) != b.view(torch.int32)).sum())
                off[k] = off.get(k, 0) + n
        del got, want
        lib = [[t.clone() for t in d.values()] for d in (
            params, grads, state.mu, state.nu)]
        steps = [torch.tensor(float(ADAM_COUNT), device=device)
                 for _ in params]

        def library():
            torch._fused_adam_(*lib, [], steps, lr=1e-3, beta1=optim.B1,
                               beta2=optim.B2, weight_decay=0.0,
                               eps=optim.EPS, amsgrad=False, maximize=False)
        ms = {}
        for _ in range(3):           # in turns: plain, kernel, library
            for name, fn in (
                    ("plain", lambda: optim.adam_step_reference(
                        params, grads, state, lrs)),
                    ("kernel", lambda: optim.adam_step(params, grads, state,
                                                       lrs)),
                    ("library", library)):
                ms.setdefault(name, []).append(loop_ms(fn))
        ms = {k: statistics.median(v) for k, v in ms.items()}
        elements = sum(v.numel() for v in params.values())
        b = adam_bound(elements, clock_hz)
        out[P] = dict(ms=ms, bound=b, off=sum(off.values()),
                      launches=launched, elements=elements)
        say(17, f"Adam over all ten groups at {P} gaussians ({elements} "
                f"elements): elements off the plain version's bits "
                f"{off} | launches a call {launched} | a call of {reps} "
                f"back to back, median of 3: "
                + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
                + f" | bound {b.ms:.3f} ms ({b.by}): the kernel at "
                f"{b.ms / ms['kernel']:.3f} of it, "
                f"{elements * 28 / ms['kernel'] / 1e9:.3f} TB/s")
        del params, grads, state, lib
        torch.cuda.empty_cache()
    if any(r["off"] or r["launches"] != 1 for r in out.values()):
        raise RuntimeError("the Adam kernel disagrees with the plain "
                           "version or launched other than once")
    return out


# --------------------------------------------------------------- phase 18
BN_ACT_BATCHES = (60, 6)      # the refine cell's batch, phase 11's
BN_ACT_FWD_RTOL, BN_ACT_BWD_RTOL = 2e-6, 1e-5


def bn_act_shapes(device):
    """(C, H, W, relu, p) of each call of the BatchNorm op
    (``models/bn_act.py::BnActFn``) in one training forward of the U-Net
    on an HW panorama (h x 2w), in order: what the refine path gives the
    kernels."""
    import torch
    from gslidar_tpu_torch.models import bn_act
    from gslidar_tpu_torch.models.unet import UNet, init_unet
    seen = []
    apply = bn_act.BnActFn.apply

    def record(x, *args):
        seen.append((*x.shape[1:], args[-2], args[-1]))
        return apply(x, *args)
    model = init_unet(UNet(), torch.Generator().manual_seed(SEED)).to(
        device).train()
    saved = bn_act_launches()
    bn_act.BnActFn.apply = record
    try:
        with torch.no_grad():
            model(torch.rand(1, 3, HW[0], 2 * HW[1], device=device),
                  torch.Generator(device=device).manual_seed(SEED))
    finally:
        del bn_act.BnActFn.apply
        set_bn_act_launches(saved)
    return seen


def bn_act_inputs(shape, device, seed):
    """Seeded float32 x (a mean and a spread of its own per channel),
    weight, bias, running statistics and dy of ``shape`` on the card."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    C = shape[1]

    def randn(*s):
        return torch.randn(s, generator=gen, device=device)

    def rand(*s):
        return torch.rand(s, generator=gen, device=device)
    x = 3.0 * randn(C, 1, 1) + (0.5 + rand(C, 1, 1)) * randn(*shape)
    return (x, 1.0 + 0.3 * randn(C), 0.2 * randn(C), 0.1 * randn(C),
            1.0 + rand(C), randn(*shape))


def run_bn_act(device, reps=5):
    """Phase 18: the BatchNorm kernel pairs (``models/bn_act.py``,
    ``csrc/bn_act.cu``) against their plain version at ``bn_act_shapes``
    for each of BN_ACT_BATCHES: the keep mask and the clip flags bit for
    bit, the output, the saved and the running statistics within
    BN_ACT_FWD_RTOL of each tensor's largest element and the gradients
    within BN_ACT_BWD_RTOL, one launch each way a call; at the first
    batch each shape's forward and backward, kernel and plain, timed in
    turns as ``reps`` calls back to back between CUDA events (median of
    3), summed over the shapes beside ``bn_act_bound``. Returns the
    numbers for the kernels line."""
    import torch
    from gslidar_tpu_torch.microbench.bounds import bn_act_bound
    from gslidar_tpu_torch.models.bn_act import (
        bn_act_backward_kernel, bn_act_backward_reference, bn_act_kernel,
        bn_act_reference)

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    def loop_ms(fn):
        fn()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(reps):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / reps
    shapes = bn_act_shapes(device)
    say(18, f"the U-Net's BatchNorm ops in one training forward at "
            f"{HW[0]}x{2 * HW[1]}, (C, H, W, relu, p): {shapes}")
    t0 = time.perf_counter()
    errs, bad, calls = {"fwd": 0.0, "bwd": 0.0}, [], 0
    ms = {k: 0.0 for k in ("kernel fwd", "kernel bwd", "plain fwd",
                           "plain bwd")}
    bound = [0.0, 0.0]
    launched = bn_act_launches()
    for B in BN_ACT_BATCHES:
        for i, (C, H, W, relu, p) in enumerate(shapes):
            shape = (B, C, H, W)
            x, w, b, rm, rv, dy = bn_act_inputs(shape, device,
                                                SEED + 181 + B * 100 + i)
            u = torch.rand(shape, device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(SEED + i)) if p > 0 else None
            rmk, rvk = rm.clone(), rv.clone()
            yk, keepk, savedk = bn_act_kernel(x, w, b, rmk, rvk, u, relu, p)
            dk = bn_act_backward_kernel(dy, x, w, b, savedk, keepk, relu, p)
            calls += 1
            yp, keepp, savedp = bn_act_reference(x, w, b, rm, rv, u, relu,
                                                 p)
            dp = bn_act_backward_reference(dy, x, w, b, savedp, keepp,
                                           relu, p)
            f_err = max(rel(yk, yp), rel(savedk[:2], savedp[:2]),
                        rel(rmk, rm), rel(rvk, rv))
            b_err = max(rel(k, q) for k, q in zip(dk, dp))
            same = (torch.equal(savedk[2], savedp[2])
                    and (keepk is None if p == 0 else
                         torch.equal(keepk, keepp)))
            errs["fwd"] = max(errs["fwd"], f_err)
            errs["bwd"] = max(errs["bwd"], b_err)
            if not (same and f_err <= BN_ACT_FWD_RTOL
                    and b_err <= BN_ACT_BWD_RTOL):
                bad.append((shape, relu, p, same, f_err, b_err))
            del yp, keepp, savedp, dp, yk, dk
            row = ""
            if B == BN_ACT_BATCHES[0]:
                got = {}
                for _ in range(3):           # in turns: plain, kernel
                    for name, fn in (
                            ("plain fwd", lambda: bn_act_reference(
                                x, w, b, rm, rv, u, relu, p)),
                            ("kernel fwd", lambda: bn_act_kernel(
                                x, w, b, rm, rv, u, relu, p)),
                            ("plain bwd", lambda: bn_act_backward_reference(
                                dy, x, w, b, savedk, keepk, relu, p)),
                            ("kernel bwd", lambda: bn_act_backward_kernel(
                                dy, x, w, b, savedk, keepk, relu, p))):
                        got.setdefault(name, []).append(loop_ms(fn))
                got = {k: statistics.median(v) for k, v in got.items()}
                bf, bb = bn_act_bound(x.numel(), p > 0)
                bound[0] += bf.ms
                bound[1] += bb.ms
                for k, v in got.items():
                    ms[k] += v
                row = (" | " + ", ".join(f"{k} {v:.3f} ms"
                                         for k, v in got.items())
                       + f" | bound {bf.ms:.3f}, {bb.ms:.3f} ms")
            say(18, f"B={B} C={C} {H}x{W} relu={relu} p={p}: kernels vs "
                    f"plain, keep mask and clip flags equal {same}, "
                    f"forward {f_err:.3g} (bar {BN_ACT_FWD_RTOL}), "
                    f"gradients {b_err:.3g} (bar {BN_ACT_BWD_RTOL})" + row)
            del x, w, b, rm, rv, dy, u, rmk, rvk, keepk, savedk
            torch.cuda.empty_cache()
    # the checked calls' launches; the timed ones are counted apart
    timed = len(shapes) * 3 * (reps + 1)
    n = tuple(a - b - timed for a, b in zip(bn_act_launches(), launched))
    BN_ACT_BY_PATH["checks (phase 18)"] = (calls, calls)
    say(18, f"BatchNorm kernel pairs at the {len(shapes)} shapes, B = "
            f"{BN_ACT_BATCHES[0]}, summed (CUDA events, {reps} calls back "
            f"to back, median of 3): " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in ms.items())
            + f" | bound forward {bound[0]:.3f} ms, backward "
            f"{bound[1]:.3f} ms (bytes): the kernels at "
            f"{bound[0] / ms['kernel fwd']:.3f} and "
            f"{bound[1] / ms['kernel bwd']:.3f} of it | largest errors "
            f"{errs} | launches of the checked calls {n} for {calls} "
            f"calls | {time.perf_counter() - t0:.1f} s")
    if bad or n != (calls, calls):
        raise RuntimeError(f"the BatchNorm kernels disagree with the plain "
                           f"version or launched other than once a call: "
                           f"{bad}, {n} launches for {calls} calls")
    return dict(ms=ms, bound=bound, errs=errs)


# ---------------------------------------------------------------- phase 9
def phase_op_chains(device, clock_hz):
    """The op-chain entry point, its launches counted; then each of the 16
    chains against its plain version at 1 and 64 steps (``vpu_ops.check``),
    the plain versions timed, and each chain's launch and share of its op
    bound."""
    import torch
    from gslidar_tpu_torch.microbench import vpu_ops as vo
    from gslidar_tpu_torch.microbench.timing import time_ms
    from gslidar_tpu_torch.utils.trace import counters
    launched = counters().get("launches.op_chain", 0)
    rows = vo.main(["--device", "cuda"])
    launches = counters().get("launches.op_chain", 0) - launched
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


# --------------------------------------------------------------- phase 15
BENCH_POINTS = (1_000_000, 10_000_000)   # 10M: kitti360_nvs_10750's
                                         # densify_until_num_points
BENCH_RENDERS = 50
BENCH_TILES = ("16x16", "8x32", "16x32", "32x32")
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "backend"}


def run_entry(phase, main, argv):
    """An entry point's ``main(argv)`` in this process, each line it
    prints prefixed by the phase (also when it raises); returns them."""
    import contextlib
    import io
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            main(argv)
    finally:
        lines = buf.getvalue().strip().splitlines()
        for ln in lines:
            say(phase, ln)
    return lines


def run_bench(phase, P, device):
    """``python -m gslidar_tpu_torch.bench --points P`` in a subprocess:
    its last line's keys and value checked, and its launches of the
    forward compositor and of the preprocess, each of which must be one
    per render it made. Returns (the JSON, the six ``launch_counts``)."""
    import sys
    cmd = [sys.executable, "-m", "gslidar_tpu_torch.bench", "--points",
           str(P), "--renders", str(BENCH_RENDERS), "--device", device.type]
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=900)
    lines = r.stdout.strip().splitlines()
    for ln in lines[:-1]:
        say(phase, f"bench --points {P}: {ln}")
    if r.returncode:
        raise RuntimeError(f"{' '.join(cmd[1:])} exited {r.returncode}: "
                           f"{r.stderr[-3000:]}")
    res = json.loads(lines[-1])
    say(phase, f"bench --points {P}, its last line: {lines[-1]}")
    from gslidar_tpu_torch.bench import points_label
    metric = f"pano_360_renders_per_sec_66x1030_{points_label(P)}_gaussians"
    if set(res) != BENCH_KEYS or res["metric"] != metric or \
            not res["value"] > 0 or res["backend"] != device.type:
        raise RuntimeError(f"the bench's last line is not its result: {res}")
    fwd, pre = (int(next(ln for ln in lines if ln.startswith(
        f"{k} kernel launches:")).split(":")[1])
        for k in ("forward", "preprocess"))
    # the first render, the median's warm-up and renders, the rate's
    want = 2 + 2 * BENCH_RENDERS if device.type == "cuda" else 0
    if (fwd, pre) != (want, want):
        raise RuntimeError(f"the bench launched the forward compositor "
                           f"{fwd} and the preprocess {pre} times, not once "
                           f"per render ({want})")
    return res, [fwd, 0, pre, 0, 0, 0]


def phase_bench(device, smi, points=BENCH_POINTS,
                step_points=NUM_GAUSSIANS):
    """The measurement entry points on their own scenes: the forward kernel
    against its plain version on ``bench.build_scene``'s 360-degree render,
    the preprocess kernels against theirs and the render through them
    against the render through the plain preprocess at each of
    ``points`` (``render_vs_plain_preprocess``), and the compositors on a
    ``bench_train_step`` step (their launches not counted); then, with the
    counts set to 0, ``python -m gslidar_tpu_torch.bench`` at each of
    ``points`` in a subprocess, and ``bench_train_step``, ``profile_render
    --tiles BENCH_TILES --trace``, ``profile_train_step --trace``,
    ``tile_stats`` and ``measure_tight_rects`` in this process; each
    ``bench_train_step`` step must launch the chamfer pair once. Returns
    (the forward's and the backward's largest errors, the bench path's
    ``launch_counts``, the renders per second at each of ``points``, the
    preprocess checks by size: their errors and stage times)."""
    import torch
    import gslidar_tpu_torch.raster.composite_op as co
    from gslidar_tpu_torch import bench
    from gslidar_tpu_torch.raster.binning import bin_gaussians
    from gslidar_tpu_torch.raster.composite_fwd import (make_params,
                                                        pack_payload)
    from gslidar_tpu_torch.raster.preprocess import preprocess
    from gslidar_tpu_torch.scripts import bench_train_step as bts
    from gslidar_tpu_torch.scripts import (measure_tight_rects,
                                           profile_render,
                                           profile_train_step, tile_stats)
    from gslidar_tpu_torch.utils.trace import counters
    t0 = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sf, P = bench.SCALE_FACTOR, points[0]
    s = bench.bench_settings()
    scene = bench.build_scene(P, 0, device)
    saved = launch_counts()
    with torch.no_grad():
        prep = preprocess(scene["means3D"], scene["scales"],
                          scene["rotations"], scene["opacity"], scene["shs"],
                          scene["mask"], torch.eye(4, device=device),
                          torch.zeros(3, device=device), bench.SH_DEGREE, sf,
                          s)
        b = bin_gaussians(prep.rect_min, prep.rect_max, prep.depth,
                          prep.tiles_touched, sf, s,
                          payload=pack_payload(prep, scene["opacity"],
                                               scene["features"]))
        ok, summ, _, _ = run_pair(b.data_rows.contiguous(), b.tile_starts,
                                  make_params(sf, s), s, 4, 4)
    set_launch_counts(saved)
    say(15, f"forward kernel vs plain on bench.build_scene({P})'s "
            f"360-degree render ({b.num_pairs} instances, {s.height}x"
            f"{s.width}, {s.tile_h}x{s.tile_w} tiles): "
            f"{'ok' if ok else 'FAIL'} {json.dumps(summ)}")
    if not ok:
        raise RuntimeError("the forward kernel disagrees with its plain "
                           "version on the bench scene")
    err_f = summ["raw_max_abs_err"]
    del prep, b

    # the preprocess kernels and the render through them at each size
    prep_checks = {}
    for n in points:
        if n != P:
            del scene
            scene = bench.build_scene(n, 0, device)
        ok_p, ef, eb = say_prep_pair(
            15, f"bench.build_scene({n})'s 360-degree view", prep_inputs(
                scene["means3D"], scene["scales"], scene["rotations"],
                scene["opacity"], scene["shs"], scene["mask"],
                torch.eye(4, device=device), torch.zeros(3, device=device),
                bench.SH_DEGREE, sf, s), SEED + 63)
        ok_r, med_r = render_vs_plain_preprocess(
            15, f"bench.build_scene({n})'s 360-degree render", (
                scene["means3D"], scene["scales"], scene["rotations"],
                scene["opacity"], scene["shs"], scene["features"],
                scene["mask"], torch.eye(4, device=device),
                torch.zeros(3, device=device),
                torch.tensor([0.0, 0.0, 0.0, 1.0], device=device),
                bench.SH_DEGREE, sf), s, smi)
        if not (ok_p and ok_r):
            raise RuntimeError(f"the preprocess kernels or the render "
                               f"through them disagree with the plain "
                               f"versions on the bench scene at {n}")
        prep_checks[n] = dict(err_f=ef, err_b=eb, med=med_r)
    del scene
    if device.type == "cuda":
        torch.cuda.empty_cache()

    tb = bts.setup(step_points, 16, 16, device)
    captured = {}
    bwd_orig = co.composite_backward

    def bwd_keep(*a):
        captured["bwd"] = a
        return bwd_orig(*a)

    co.composite_backward = bwd_keep
    try:
        tb.step(tb.state, tb.cams[0], bts.ITERATION, bts.SH_DEGREE, 0.0,
                True)
    finally:
        co.composite_backward = bwd_orig
    set_launch_counts(saved)
    failed, err_sf, err_b = check_step_kernels(
        15, f"on a bench_train_step step ({step_points} gaussians)",
        captured.pop("bwd"), SEED + 23)
    if failed:
        raise RuntimeError(f"{failed} kernel vs plain on the bench step")
    del tb
    say(15, f"kernels vs plain: {time.perf_counter() - t0:.1f} s")

    trace = ["--trace"] if device.type == "cuda" else []
    dev = ["--device", device.type]
    set_launch_counts()
    rates, sub_launches = {}, [0] * len(LAUNCH_COUNTERS)
    for n in points:
        res, k = run_bench(15, n, device)
        rates[n] = res["value"]
        sub_launches = [a + b for a, b in zip(sub_launches, k)]
    steps0, cham0 = counters().get("train_steps", 0), launch_counts()[4:]
    adam0 = adam_launches()
    run_entry(15, bts.main, ["--points", str(step_points), *dev])
    bts_steps = counters().get("train_steps", 0) - steps0
    bts_cham = tuple(n - m for n, m in zip(launch_counts()[4:], cham0))
    bts_adam = adam_launches() - adam0
    ADAM_BY_PATH["bench_train_step (phase 15)"] = bts_adam
    run_entry(15, profile_render.main, ["--points", str(P), "--tiles",
                                        *BENCH_TILES, *trace, *dev])
    run_entry(15, profile_train_step.main, ["--points", str(step_points),
                                            *trace, *dev])
    run_entry(15, tile_stats.main, ["--points", str(P), *dev])
    run_entry(15, measure_tight_rects.main, ["--points", str(P), *dev])
    launches = [a + b for a, b in zip(launch_counts(), sub_launches)]
    say(15, f"bench path: renders/s {rates} | launches "
            f"{launches_text(launches)} ({launches_text(sub_launches)} in "
            f"the bench's subprocesses) | {time.perf_counter() - t0:.1f} s")
    say(15, f"bench_train_step: {bts_steps} steps, chamfer forward and "
            f"backward launches {bts_cham}, Adam launches {bts_adam}")
    if device.type == "cuda" and (min(launches) == 0
                                  or bts_cham != (bts_steps, bts_steps)
                                  or bts_adam != bts_steps):
        raise RuntimeError(f"the bench path launched {launches} kernels, "
                           f"the chamfer's {bts_cham} and Adam's "
                           f"{bts_adam} in {bts_steps} bench_train_step "
                           f"steps")
    return max(err_f, err_sf), err_b, launches, rates, prep_checks


def main():
    smi = phase_device()
    import torch
    from gslidar_tpu_torch.microbench.bounds import max_sm_clock_hz
    device = torch.device("cuda", 0)
    clock_hz = max_sm_clock_hz()
    phase_build()
    err3, err3b, err3p, err3pb = phase_kernel_vs_plain(device)
    args, params, alive, prior, cams, _ = phase_main_path(device)
    err5, med, work5, prep5 = phase_full_size(args, params, alive, prior,
                                              cams[0], smi)
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
    bound_pf, bound_pb = say_prep_bounds(prep5, works7["preprocess"], med7,
                                         clock_hz)
    phase_train_densify(device, params, smi)
    err11, eval_launches = phase_eval_refine(args, params, alive, prior, smi)
    group = phase_nccl(device)
    err13f, err13b, dp_launches, _, _ = phase_dp_train(device, params, group,
                                                       smi)
    phase_dp_cli(device)
    err13r, shard_launches, _ = phase_sharded_renders(args, params, alive,
                                                      cams[0], group, smi)
    import torch.distributed as dist
    dist.destroy_process_group()
    del params, alive, prior, cams, scene
    torch.cuda.empty_cache()
    err12, err12b, _ = phase_opv2v(smi, device)
    err14, err14b, kitti_launches, _ = phase_kitti360(smi, device)
    err15, err15b, bench_launches, _, prep15 = phase_bench(device, smi)
    gather = phase_gather(device)
    chains = phase_op_chains(device, clock_hz)
    cham = run_chamfer(device, clock_hz)
    adam = run_adam(device, clock_hz)
    bn = run_bn_act(device)
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "composite_fwd", "route": "cuda",
        "source": "gslidar_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "gslidar_tpu/raster/pallas_fwd.py:282",
        "launches": launches[0],
        "launches_by_path": {"training (phase 6)": launches[0],
                             "data-parallel training (phase 13)":
                                 dp_launches[0],
                             "sharded 360-degree renders (phase 13)":
                                 shard_launches[0],
                             "kitti360_nvs_10750 training (phase 14)":
                                 kitti_launches[0],
                             "bench (phase 15)": bench_launches[0]},
        "max_abs_err": max(err3, err5, err11, err12, err13f, err13r, err14,
                           err15),
        "ms": med["kernel"], "plain_ms": med["plain"],
        "bound_ms": bound_fwd.ms, "bound_by": bound_fwd.bound_by,
        "library_ms": None}, {
        "name": "composite_bwd", "route": "cuda",
        "source": "gslidar_tpu_torch/csrc/composite_bwd.cu",
        "replaces": "gslidar_tpu/raster/pallas_bwd.py:66",
        "launches": launches[1],
        "launches_by_path": {"training (phase 6)": launches[1],
                             "data-parallel training (phase 13)":
                                 dp_launches[1],
                             "sharded 360-degree renders (phase 13)": 0,
                             "kitti360_nvs_10750 training (phase 14)":
                                 kitti_launches[1],
                             "bench (phase 15)": bench_launches[1]},
        "max_abs_err": max(err3b, err7, err12b, err13b, err14b, err15b),
        "ms": med7["backward kernel"],
        "plain_ms": med7["plain backward"],
        "bound_ms": bound_bwd.ms, "bound_by": bound_bwd.bound_by,
        "library_ms": None}, {
        "name": "preprocess_fwd", "route": "cuda",
        "source": "gslidar_tpu_torch/csrc/preprocess.cu",
        "replaces": "gslidar_tpu/raster/preprocess.py:191 (XLA, with "
                    "gslidar_tpu/ops/sh.py:56)",
        "launches": launches[2],
        "launches_by_path": {"training (phase 6)": launches[2],
                             "data-parallel training (phase 13)":
                                 dp_launches[2],
                             "sharded 360-degree renders (phase 13)":
                                 shard_launches[2],
                             "kitti360_nvs_10750 training (phase 14)":
                                 kitti_launches[2],
                             "bench (phase 15)": bench_launches[2]},
        "max_abs_err": max(err3p, prep5["err_f"], works7["preprocess"][
            "err_f"], *(c["err_f"] for c in prep15.values())),
        "ms": prep5["med"]["preprocess kernel"],
        "plain_ms": prep5["med"]["plain preprocess"],
        "ms_10M": prep15[BENCH_POINTS[1]]["med"]["preprocess kernel"],
        "plain_ms_10M": prep15[BENCH_POINTS[1]]["med"]["plain preprocess"],
        "bound_ms": bound_pf.ms, "bound_by": bound_pf.bound_by,
        "library_ms": None}, {
        "name": "preprocess_bwd", "route": "cuda",
        "source": "gslidar_tpu_torch/csrc/preprocess.cu",
        "replaces": "the autodiff of gslidar_tpu/raster/preprocess.py:191 "
                    "(XLA)",
        "launches": launches[3],
        "launches_by_path": {"training (phase 6)": launches[3],
                             "data-parallel training (phase 13)":
                                 dp_launches[3],
                             "kitti360_nvs_10750 training (phase 14)":
                                 kitti_launches[3],
                             "bench (phase 15)": bench_launches[3]},
        "max_abs_err": max(err3pb, prep5["err_b"],
                           works7["preprocess"]["err_b"],
                           *(c["err_b"] for c in prep15.values())),
        "ms": med7["preprocess backward kernel"],
        "plain_ms": med7["plain preprocess backward"],
        "bound_ms": bound_pb.ms, "bound_by": bound_pb.bound_by,
        "library_ms": None}, {
        "name": "gather_rows", "route": "cuda",
        "source": "gslidar_tpu_torch/csrc/gather_rows.cu",
        "replaces": "scripts/microbench_dma_gather.py:88",
        "bound_by": "bytes", **gather}, {
        "name": "op_chain", "route": "cuda",
        "source": "gslidar_tpu_torch/csrc/op_chain.cu",
        "replaces": "scripts/microbench_vpu_ops.py:43",
        "bound_by": "operations", **chains}, *({
        "name": f"chamfer_{part}", "route": "cuda",
        "source": "gslidar_tpu_torch/csrc/chamfer.cu",
        "replaces": "the XLA chamfer of gslidar_tpu/ops/chamfer.py",
        "launches": launches[k],
        "launches_by_path": {"training (phase 6)": launches[k],
                             "eval (phase 11)": eval_launches[k],
                             "data-parallel training (phase 13)":
                                 dp_launches[k],
                             "kitti360_nvs_10750 training (phase 14)":
                                 kitti_launches[k],
                             "bench (phase 15)": bench_launches[k]},
        "max_abs_err": cham["errs"][i],
        "ms": cham["ms"][f"{name} kernel"],
        "op_ms": cham["ms"]["op"], "plain_ms": cham["ms"]["plain"],
        "bound_ms": cham["bounds"][i].ms,
        "bound_by": cham["bounds"][i].bound_by, "library_ms": None,
        **extra}
        for i, (k, part, name, extra) in enumerate((
            (4, "fwd", "forward", {"bound_ms_unfused": cham["unfused_ms"],
                                   "dists_off": cham["dists_off"]}),
            (5, "bwd", "backward", {"rows_off": cham["rows_off"]})))), {
        "name": "adam", "route": "cuda",
        "source": "gslidar_tpu_torch/csrc/adam.cu",
        "replaces": "the XLA Adam of gslidar_tpu/models/optim.py",
        "launches": sum(ADAM_BY_PATH.values()),
        "launches_by_path": ADAM_BY_PATH,
        "elements_off": sum(r["off"] for r in adam.values()),
        "ms": adam[ADAM_POINTS[0]]["ms"]["kernel"],
        "plain_ms": adam[ADAM_POINTS[0]]["ms"]["plain"],
        "library_ms": adam[ADAM_POINTS[0]]["ms"]["library"],
        "bound_ms": adam[ADAM_POINTS[0]]["bound"].ms,
        "ms_10M": adam[ADAM_POINTS[1]]["ms"]["kernel"],
        "plain_ms_10M": adam[ADAM_POINTS[1]]["ms"]["plain"],
        "library_ms_10M": adam[ADAM_POINTS[1]]["ms"]["library"],
        "bound_ms_10M": adam[ADAM_POINTS[1]]["bound"].ms,
        "bound_by": adam[ADAM_POINTS[0]]["bound"].bound_by}, *({
        "name": f"bn_act_{part}", "route": "cuda",
        "source": "gslidar_tpu_torch/csrc/bn_act.cu",
        "replaces": replaces,
        "launches": sum(v[i] for v in BN_ACT_BY_PATH.values()),
        "launches_by_path": {k: v[i] for k, v in BN_ACT_BY_PATH.items()},
        "max_rel_err": bn["errs"][part],
        "ms": bn["ms"][f"kernel {part}"],
        "plain_ms": bn["ms"][f"plain {part}"],
        "bound_ms": bn["bound"][i], "bound_by": "bytes", "library_ms": None,
        "at": f"the U-Net's 18 BatchNorms at B = {BN_ACT_BATCHES[0]} and "
              f"{HW[0]}x{2 * HW[1]}, summed"}
        for i, (part, replaces) in enumerate((
            ("fwd", "flax nn.BatchNorm in training, nn.relu and nn.Dropout "
                    "of gslidar_tpu/models/unet.py (XLA)"),
            ("bwd", "their autodiff (XLA)"))))],
        "loss_graphs_by_path": GRAPHS_BY_PATH}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
