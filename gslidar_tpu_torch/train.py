"""Train a scene on the GPU, evaluate it and refine its ray drop.

    python -m gslidar_tpu_torch.train --config configs/<scene>.yaml \
        [--base_config configs/base.yaml] [--device cuda|cpu] \
        [--start_checkpoint <model_path>/ckpt/chkpnt<it>.npz] \
        [--test_only] [--median_depth] [--skip_refine] [--show_log] \
        [--debug_cuda] [key=val ...]

The port's counterpart of the root ``train.py`` (``training``, train.py:
95-469, and its entry, :472-560). It builds the scene, initializes the
gaussians from its point cloud (``create_from_pcd``) and the ray-drop
prior, and trains from iteration 1 (or the checkpoint's) to
``iterations``, in the JAX loop's order within an iteration:

* the SH degree and the camera pick, with the same numpy random stream
  and self-supervision time shift (train.py:285-299);
* the step, with the densification statistics on inside the window and
  the gaussians' Adam skipped on a densify iteration (:304-326);
* the time-split flip (:329-332), densify and prune with the world-size
  prune once past the first opacity reset (:334-344), and the opacity
  reset (:356-359) under the JAX loop's own conditions;
* the log every 10 steps, to stdout and, when ``tensorboardX`` imports,
  to TensorBoard (:361-429); ``complete_eval`` at ``test_iterations``,
  the last one also writing ``ray_drop_datasets/`` (:431-436); the depth
  visualization every ``vis_step`` (:438-449); the coarse-to-fine step
  (:451-459) and the checkpoints (:461-464), which gslidar_tpu's
  ``load_checkpoint`` reads;
* with ``viewer`` on, the live viewer (:249-279, 466; ``engine/viewer.py``
  on ``viewer_port``): each iteration runs between its ``checkin`` and
  ``checkout``, so its renders (``viewer_render``) come between steps,
  and its server stops when the loop ends;
* with ``data_parallel`` on and B = ``data_parallel_cameras`` (default:
  the world size) above 1, camera-data-parallel training (:141-153,
  :211-216, :300-318; ``parallel/shard.py``): every rank draws the same
  B picks from the same stream, first pick first, and takes its B/W of
  them; densify runs on every rank from the same seeded generator, so
  the state stays identical across ranks. Rank 0 alone writes the
  checkpoints, the depth PNGs and the logs, evaluates, refines and
  serves the viewer; the other ranks meet it at a barrier.

Then, unless ``--skip_refine``, the ray-drop U-Net trains on the final
eval's renders (``refine``, skipped under ``--test_only``) and is scored
(``refine_test``). ``--test_only`` evaluates the newest checkpoint of
``checkpoint_iterations`` at the resolution it was trained at.
``--median_depth`` renders the median depth as the mean. Unless
``--show_log``, stdout and stderr go to ``<model_path>/log.txt``.

``--debug_cuda``, ``exhaust_test`` and the removal of a stale
``model_path`` are the root entry's (``parse_cli``, ``prepare_run``).
The tensors are sized exactly, so the JAX loop's capacity growth and
instance caps have no counterpart.

Data-parallel training on W GPUs of one machine:

    python -m torch.distributed.run --nproc_per_node=W \
        -m gslidar_tpu_torch.train --config ... data_parallel=true

Each rank runs on ``cuda:LOCAL_RANK`` over NCCL (gloo with ``--device
cpu``); without ``torch.distributed.run``, ``data_parallel=true`` makes a
group of one rank.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import sys
import time

import numpy as np
import torch

from gslidar_tpu_torch.engine.checkpoint import (checkpoint_path,
                                                 load_train_state,
                                                 save_checkpoint)
from gslidar_tpu_torch.engine.evaluate import (complete_eval,
                                               make_eval_render,
                                               make_eval_render360)
from gslidar_tpu_torch.engine.train import (CameraBatch, camera_to_batch,
                                            init_train_state,
                                            make_densify_fn, make_train_step,
                                            reset_opacity_state)
from gslidar_tpu_torch.engine.viewer import VisManager
from gslidar_tpu_torch.models.gaussians import GaussianAux, create_from_pcd
from gslidar_tpu_torch.models.raydrop_prior import (PriorAdam,
                                                    init_raydrop_prior,
                                                    raydrop_prior_upscale)
from gslidar_tpu_torch.parallel.shard import (init_group,
                                              make_parallel_train_step,
                                              stack_camera_batch)
from gslidar_tpu_torch.render import (build_scene, gaussian_config,
                                      raster_settings)
from gslidar_tpu_torch.utils.general import (make_image_grid, save_image,
                                             visualize_depth)


def in_densify_window(args, iteration, n_gaussians):
    """(in_window, is_densify) of an iteration, the JAX loop's conditions
    (train.py:304-309), on the count of gaussians before its step."""
    in_window = (args.densify_from_iter < iteration < args.densify_until_iter
                 and (args.densify_until_num_points < 0
                      or n_gaussians < args.densify_until_num_points))
    return in_window, in_window and \
        iteration % args.densification_interval == 0


def schedule(args, iteration, n_gaussians, no_time_split):
    """The events the loop fires after the step of ``iteration`` with
    ``n_gaussians`` before it and the time-split mode ``no_time_split``
    before it, in the loop's order, of "flip", "densify", "reset",
    "upscale" and "checkpoint" (train.py:304-309,329,334,356-358,451,
    461). The reset needs ``in_window``, hence ``densify_from_iter <
    iteration``, so its white-background clause (``iteration ==
    densify_from_iter``) never fires in the JAX loop, nor here."""
    in_window, is_densify = in_densify_window(args, iteration, n_gaussians)
    events = []
    if no_time_split and \
            iteration > args.densify_until_iter * args.time_split_frac:
        events.append("flip")
    if is_densify:
        events.append("densify")
    if in_window and (iteration % args.opacity_reset_interval == 0
                      or (args.white_background
                          and iteration == args.densify_from_iter)):
        events.append("reset")
    if iteration % args.scale_increase_interval == 0:
        events.append("upscale")
    if iteration in args.checkpoint_iterations:
        events.append("checkpoint")
    return events


def viewer_render(args, device, render_fn, params, alive, prior, c2w,
                  frame):
    """The live viewer's depth image [3, H, W] of the model (``params``,
    ``alive``, ray-drop ``prior``) from pose ``c2w`` (camera to world, 4x4)
    at frame ``frame`` of ``args.frames`` (root train.py:254-268), through
    ``render_fn``, the loop's ``make_eval_render`` or its half-resolution
    twin, at the config's SH degree. The viewer calls it on its server's
    thread, where grad mode is on (it is thread-local), so it turns it off
    itself; the kernels launch on that thread's current stream."""
    with torch.no_grad():
        w2c = np.linalg.inv(c2w).astype(np.float32)
        empty = torch.zeros((1, 1, 1), device=device)
        cam = CameraBatch(
            viewmat=torch.as_tensor(w2c, device=device),
            campos=torch.as_tensor(c2w[:3, 3], dtype=torch.float32,
                                   device=device),
            timestamp=-0.5 + frame / max(args.frames - 1, 1),
            towards_idx=0, pts_depth=empty, pts_intensity=empty)
        pkg = render_fn(params, alive, prior, cam, args.sh_degree)
        return visualize_depth(pkg.depth.cpu().numpy(),
                               scale_factor=args.scale_factor)


class _TensorBoard:
    """TensorBoard scalars through tensorboardX when it imports; else one
    printed notice and nothing more (a machine without it still trains)."""

    def __init__(self, logdir):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            print("tensorboardX is not installed: no TensorBoard log, the "
                  "log is stdout", flush=True)
            self.writer = None
        else:
            self.writer = SummaryWriter(logdir)

    def scalars(self, iteration, log, n_gaussians):
        if self.writer is None:
            return
        for k, v in log.items():
            self.writer.add_scalar(f"TrainLoss/{k}", float(v), iteration)
        self.writer.add_scalar("total_points", n_gaussians, iteration)

    def close(self):
        if self.writer is not None:
            self.writer.close()


def training(args, device, init_params=None, on_step=None, on_event=None,
             group=None):
    """Train from iteration 1, or from ``args.start_checkpoint``'s, to
    ``args.iterations``.

    With ``args.data_parallel``, the steps train B cameras over ``group``
    (``parallel.shard.init_group(device)`` when None), B =
    ``args.data_parallel_cameras`` or the group's size.

    ``init_params`` (a params dict on ``device``) replaces the gaussians
    ``create_from_pcd`` would make. ``on_step(iteration, state, loss, log,
    grads)`` is called after each step; ``on_event(iteration, name,
    state, info)`` after each event of the loop: "flip", "densify" (info:
    the counts and ``ms``, the densify's time), "reset", "vis",
    "upscale", "checkpoint" (info: ``path``, ``seconds``, ``bytes``) and
    "eval" (info: ``complete_eval``'s metrics by split). Under
    ``args.test_only``, or at a checkpoint of the last iteration, it takes
    no step and runs the final eval. Returns (state, scene, losses): the
    final TrainState and the loss of every step taken.
    """
    # camera-data-parallel training (root train.py:141-153)
    n_par = 1
    if args.get("data_parallel", False):
        group = group if group is not None else init_group(device)
        n_par = int(args.get("data_parallel_cameras", 0)) or group.size
        if n_par % group.size:
            raise ValueError(f"data_parallel_cameras={n_par} does not "
                             f"divide over {group.size} ranks")
    data_parallel = n_par > 1
    lead = group is None or group.rank == 0

    def sync():
        # the other ranks meet rank 0 after its work alone
        if group is not None:
            group.barrier()

    vis_path = os.path.join(args.model_path, "visualization")
    os.makedirs(vis_path, exist_ok=True)
    os.makedirs(os.path.join(args.model_path, "ckpt"), exist_ok=True)
    t0 = time.perf_counter()
    scene = build_scene(args, shuffle=bool(args.shuffle))
    if lead:
        with open(os.path.join(args.model_path, "scale_factor.txt"),
                  "w") as f:
            f.write(str(args.scale_factor))
        w, h = scene.get_wh()
        print(f"[scene] {args.scene_type}: "
              f"{len(scene.scene_info.point_cloud[0])} points, "
              f"{len(scene.get_train_cameras())} train and "
              f"{len(scene.scene_info.test_cameras)} test cameras at "
              f"{h}x{w}, built in {time.perf_counter() - t0:.1f} s",
              flush=True)
    if data_parallel:
        print(f"[data_parallel] {n_par} cameras/iter over {group.size} "
              f"ranks ({group.backend})", flush=True)

    if init_params is None:
        pts, colors, _normals, times = scene.scene_info.point_cloud
        t0 = time.perf_counter()
        params, aux = create_from_pcd(pts, colors, times,
                                      gaussian_config(args),
                                      seed=args.seed, device=device)
        if lead:
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            print(f"[init] create_from_pcd: {params['xyz'].shape[0]} "
                  f"gaussians in {time.perf_counter() - t0:.1f} s",
                  flush=True)
    else:
        params = init_params
        aux = GaussianAux.zeros(params["xyz"].shape[0], device)
    w, h = scene.get_wh()
    state = init_train_state(params, aux, init_raydrop_prior(h, w, device))
    bg = torch.tensor([1.0, 1.0, 1.0, 1.0] if args.white_background
                      else [0.0, 0.0, 0.0, 1.0], device=device)

    first_iter = 0
    if args.get("start_checkpoint"):
        state, first_iter = load_train_state(args.start_checkpoint, device)
        for _ in range(first_iter // args.scale_increase_interval):
            scene.up_scale()

    def build_fns(no_time_split):
        w, h = scene.get_wh()
        settings = raster_settings(args, h, w)
        cfg = gaussian_config(args, no_time_split=no_time_split)
        # the viewer's half-resolution twin while its camera moves
        # (root train.py:222-229)
        half = raster_settings(args, max(h // 2, 8), max(w // 2, 8))
        step = (make_parallel_train_step(args, cfg, settings, bg, group,
                                         n_cameras=n_par)
                if data_parallel else make_train_step(args, cfg, settings,
                                                      bg))
        return (step,
                make_densify_fn(args, cfg),
                make_eval_render(args, cfg, settings, bg),
                (make_eval_render360(args, cfg, settings, bg)
                 if bool(args.get("eval_full360", True)) else None),
                make_eval_render(args, cfg, half, bg), cfg)

    def event(iteration, name, info=None):
        if on_event is not None:
            on_event(iteration, name, state, info)

    no_time_split = bool(args.no_time_split)
    (train_step, densify_fn, eval_render, eval_render360, eval_render_half,
     cfg_now) = build_fns(no_time_split)

    if args.get("test_only") or first_iter == args.iterations:
        if lead:
            sh_degree = min(first_iter // args.sh_increase_interval,
                            args.sh_degree)
            results = complete_eval(first_iter, args, scene, state,
                                    sh_degree, eval_render, is_final=True,
                                    save_raydrop_data=True,
                                    eval_render360=eval_render360)
            event(first_iter, "eval", results)
        sync()
        return state, scene, []

    rng = np.random.default_rng(args.seed)
    generator = torch.Generator(device=device).manual_seed(int(args.seed))
    tb = _TensorBoard(os.path.join(args.model_path, "tb")) if lead else None
    viewpoint_stack = []
    losses = []

    def pick_camera():
        # a camera and its self-supervision time shift (train.py:285-299)
        nonlocal viewpoint_stack
        cams = scene.get_train_cameras()
        if not viewpoint_stack:
            viewpoint_stack = list(range(len(cams)))
        c = cams[viewpoint_stack.pop(rng.integers(len(viewpoint_stack)))]
        if rng.random() < args.lambda_self_supervision:
            return c, 3 * (rng.random() - 0.5) * scene.time_interval
        return c, 0.0

    ema = 0.0
    t_start = time.time()
    profile_at = int(args.get("profile_iter", 0)) if lead else 0
    prof = None

    def on_viewer(c2w, frame, preview=False):
        # the twin gets no ray-drop prior: the prior is sized for the full
        # resolution, and the depth does not read it
        return viewer_render(args, device,
                             eval_render_half if preview else eval_render,
                             state.params, state.aux.alive,
                             None if preview else state.prior, c2w, frame)

    # the live viewer (root train.py:249-274): off unless ``viewer``
    vis_mgr = VisManager({"port": int(args.get("viewer_port", 8080)),
                          "enabled": lead and bool(args.get("viewer",
                                                            False)),
                          "max_frame": args.frames,
                          "pixels_per_step": h * w}, on_viewer)
    try:
        for iteration in range(first_iter + 1, args.iterations + 1):
            vis_mgr.checkin()
            if profile_at and iteration == profile_at:
                from torch.profiler import ProfilerActivity, profile
                prof = profile(activities=[ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA]
                    if torch.device(device).type == "cuda" else []))
                prof.start()
            if prof is not None and iteration == profile_at + 5:
                prof.stop()
                out = os.path.join(args.model_path, "profile")
                os.makedirs(out, exist_ok=True)
                prof.export_chrome_trace(os.path.join(out, "trace.json"))
                prof = None
                print(f"[profiler] trace written to {out}", flush=True)
            sh_degree = min(iteration // args.sh_increase_interval,
                            args.sh_degree)
            # the first pick, then B - 1 more, each with its own shift
            picks = [pick_camera() for _ in range(n_par)]
            cam = picks[0][0]

            n_before = state.params["xyz"].shape[0]
            in_window = in_densify_window(args, iteration, n_before)[0]
            events = schedule(args, iteration, n_before, no_time_split)
            if data_parallel:
                batch = stack_camera_batch([camera_to_batch(c, device)
                                            for c, _ in picks])
                shifts = [t for _, t in picks]
            else:
                batch, shifts = camera_to_batch(cam, device), float(
                    picks[0][1])
            state, loss, log, grads = train_step(
                state, batch, iteration, sh_degree, shifts,
                stats_on=in_window, apply_update="densify" not in events)
            losses.append(loss)
            if on_step is not None:
                on_step(iteration, state, loss, log, grads)

            # flip time-split mode (reference train.py:356-357)
            if "flip" in events:
                no_time_split = False
                (train_step, densify_fn, eval_render, eval_render360,
                 eval_render_half, cfg_now) = build_fns(no_time_split)
                event(iteration, "flip")

            if "densify" in events:
                size_on = (iteration > args.opacity_reset_interval
                           and args.prune_big_point > 0)
                size_threshold = (args.size_threshold
                                  // scene.resolution_scales[0]
                                  if size_on else None)
                t0 = time.perf_counter()
                state, counts = densify_fn(state, generator,
                                           float(scene.cameras_extent),
                                           size_threshold)
                counts["ms"] = (time.perf_counter() - t0) * 1e3
                counts["world_size_prune"] = size_on
                print(f"[{iteration}] densify: {counts['before']} -> "
                      f"{counts['after']} gaussians (never visible "
                      f"-{counts['never_visible']}, clones "
                      f"{counts['clones']}, splits {counts['splits']}, new "
                      f"+{counts['new']}, "
                      f"opacity -{counts['opacity_pruned']}, world size "
                      f"-{counts['world_size_pruned']}) in "
                      f"{counts['ms']:.1f} ms", flush=True)
                event(iteration, "densify", counts)

            if "reset" in events:
                state = reset_opacity_state(state, cfg_now)
                event(iteration, "reset")

            if lead and (iteration % 10 == 0 or iteration == 1):
                ema = 0.4 * float(loss) + 0.6 * ema
                n_now = state.params["xyz"].shape[0]
                rate = (iteration - first_iter) / max(time.time() - t_start,
                                                      1e-9)
                print(f"[{iteration}/{args.iterations}] loss={ema:.5f} "
                      f"pts={n_now} instances={log['num_pairs']} "
                      f"it/s={rate:.2f}", flush=True)
                tb.scalars(iteration, log, n_now)

            if iteration in args.test_iterations:
                if lead:
                    final = iteration == args.iterations
                    results = complete_eval(iteration, args, scene, state,
                                            sh_degree, eval_render,
                                            is_final=final,
                                            save_raydrop_data=final,
                                            eval_render360=eval_render360)
                    event(iteration, "eval", results)
                sync()

            if lead and (iteration % args.vis_step == 0 or iteration == 1):
                pkg = eval_render(state.params, state.aux.alive, state.prior,
                                  camera_to_batch(cam, device), sh_degree)
                imgs = [visualize_depth(pkg.depth.cpu().numpy(),
                                        scale_factor=args.scale_factor)]
                if cam.pts_depth is not None:
                    imgs.append(visualize_depth(
                        cam.pts_depth, scale_factor=args.scale_factor))
                save_image(make_image_grid(imgs, nrow=2),
                           os.path.join(vis_path, f"{iteration:05d}_"
                                                  f"{cam.colmap_id:03d}.png"))
                event(iteration, "vis")

            if "upscale" in events:
                scene.up_scale()
                next_w, next_h = scene.get_wh()
                prior = raydrop_prior_upscale(state.prior, next_h, next_w)
                state = state._replace(prior=prior,
                                       prior_opt=PriorAdam.init(prior))
                (train_step, densify_fn, eval_render, eval_render360,
                 eval_render_half, cfg_now) = build_fns(no_time_split)
                event(iteration, "upscale")

            if "checkpoint" in events:
                if lead:
                    print(f"\n[ITER {iteration}] Saving Checkpoint",
                          flush=True)
                    path = checkpoint_path(args.model_path, iteration)
                    t0 = time.perf_counter()
                    save_checkpoint(path, state, iteration)
                    event(iteration, "checkpoint", dict(
                        path=path, seconds=time.perf_counter() - t0,
                        bytes=os.path.getsize(path)))
                sync()

            vis_mgr.checkout(iteration)
    finally:
        vis_mgr.close()

    if prof is not None:
        prof.stop()
    if tb is not None:
        tb.close()
    return state, scene, [float(x) for x in losses]


def load_args(config, base_config="configs/base.yaml", overrides=()):
    """The run's config: base_config <- config <- ``key=val`` overrides,
    merged as the root train.py merges them (:503-509): t_grad off for a
    static scene, ``iterations`` appended to the save, checkpoint and test
    iterations."""
    from gslidar_tpu_torch.config import Config, load_run_config
    args = load_run_config(base_config, config, list(overrides))
    if not args.dynamic:
        Config.update(args, "t_grad", False)
    for k in ("save_iterations", "checkpoint_iterations", "test_iterations"):
        Config.update(args, k, list(args[k]) + [args.iterations])
    return args


def test_only_args(args):
    """``--test_only``'s settings (root train.py:511-523): no shuffle, the
    newest checkpoint of ``checkpoint_iterations`` as the start, the
    resolution it was trained at and the run's saved scale factor."""
    from gslidar_tpu_torch.config import Config
    Config.update(args, "shuffle", False)
    scales = list(args.resolution_scales)
    idx = len(scales) - 1
    for iteration in args.checkpoint_iterations:
        path = os.path.join(args.model_path, "ckpt", f"chkpnt{iteration}.npz")
        if os.path.exists(path):
            Config.update(args, "start_checkpoint", path)
            idx = max(0, len(scales) - 1
                      - iteration // args.scale_increase_interval)
    Config.update(args, "resolution_scales", [scales[idx]])
    with open(os.path.join(args.model_path, "scale_factor.txt")) as f:
        Config.update(args, "scale_factor", float(f.read()))


@contextlib.contextmanager
def log_to(path):
    """stdout and stderr into ``path`` inside the block (root train.py:
    495-501), restored and the file closed after it."""
    saved = sys.stdout, sys.stderr
    with open(path, "w", buffering=1) as f:
        sys.stdout = sys.stderr = f
        try:
            yield
        finally:
            sys.stdout, sys.stderr = saved


def parse_cli(argv=None):
    """The command line -> (its flags, the run's config), read as the root
    train.py reads it (:472-488)."""
    from gslidar_tpu_torch.config import Config
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--base_config", default="configs/base.yaml")
    parser.add_argument("--start_checkpoint", default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--debug_cuda", action="store_true")
    parser.add_argument("--test_only", action="store_true")
    parser.add_argument("--median_depth", action="store_true")
    parser.add_argument("--skip_refine", action="store_true")
    parser.add_argument("--show_log", action="store_true")
    known, rest = parser.parse_known_args(argv)
    args = load_args(known.config, known.base_config, rest)
    for k in ("start_checkpoint", "debug_cuda", "test_only", "median_depth"):
        Config.update(args, k, getattr(known, k))
    return known, args


def prepare_run(args, clean=True):
    """The run directory and the settings the root train.py derives
    before training (:489-531): unless ``clean`` is False (the ranks of
    a data-parallel run but rank 0), an existing ``model_path`` is
    removed unless under ``--test_only`` or ``--start_checkpoint``;
    ``--test_only``'s settings; ``--debug_cuda`` keeps the last of
    ``resolution_scales`` (the loaders also stop after 16 frames);
    ``exhaust_test`` adds an eval every ``test_interval``."""
    from gslidar_tpu_torch.config import Config
    if (clean and os.path.exists(args.model_path) and not args.test_only
            and args.start_checkpoint is None):
        shutil.rmtree(args.model_path)
    os.makedirs(args.model_path, exist_ok=True)
    if args.test_only:
        test_only_args(args)
    if args.debug_cuda:
        Config.update(args, "resolution_scales",
                      list(args.resolution_scales)[-1:])
    if args.exhaust_test:
        Config.update(args, "test_iterations",
                      list(args.test_iterations)
                      + list(range(0, args.iterations, args.test_interval)))


def main(argv=None):
    from gslidar_tpu_torch.engine.refine import refine, refine_test
    from gslidar_tpu_torch.utils.general import seed_everything

    known, args = parse_cli(argv)
    device = torch.device(known.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train with "
                         "the plain PyTorch compositors")
    torch.backends.cuda.matmul.allow_tf32 = False
    group = None
    if args.get("data_parallel", False):
        from gslidar_tpu_torch.parallel.shard import rank_device
        device = rank_device(device)
        group = init_group(device)
    lead = group is None or group.rank == 0

    if lead:
        prepare_run(args)
    if group is not None:
        group.barrier()
        if not lead:
            prepare_run(args, clean=False)
    with (log_to(os.path.join(args.model_path, "log.txt"))
          if lead and not known.show_log else contextlib.nullcontext()):
        print("Optimizing " + args.model_path)
        if lead:
            with open(os.path.join(args.model_path, "setting.txt"),
                      "w") as f:
                f.write("------------------ start ------------------\n")
                for k, v in args.items():
                    f.write(f"{k} : {v}\n")
                f.write("------------------- end -------------------")
            rd = os.path.join(args.model_path, "ray_drop_datasets")
            if os.path.exists(rd) and not args.test_only:
                shutil.rmtree(rd)
        if group is not None:
            group.barrier()
        seed_everything(args.seed)
        state, _, losses = training(args, device, group=group)
        if losses:
            print(f"trained {len(losses)} steps to "
                  f"{state.params['xyz'].shape[0]} gaussians: loss "
                  f"{losses[0]:.5f} -> {losses[-1]:.5f}")
        print("\nTraining complete.", flush=True)
        if lead and not known.skip_refine:
            if not args.test_only:
                refine(args, device)
            refine_test(args, device)
            print("\nRefine complete.", flush=True)
    if group is not None:
        import torch.distributed as dist
        group.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
