"""Camera-data-parallel training over a process group (port of
gslidar_tpu/parallel/shard.py).

One iteration trains B cameras: rank r of W renders and differentiates
cameras [r·B/W, (r+1)·B/W) of the iteration's global batch. Parameters
and optimizer state are replicated. The math is the JAX step's
(``shard.py:87-156`` there):

* camera i renders with its own zero T tap [P, 3, 3] and a zero t tap
  [P, 1] added to the ``t`` parameter, so ONE ``torch.autograd.grad``
  of the rank's loss, the sum of its cameras' losses over the global B,
  yields the parameter, prior and per-camera tap gradients;
* the parameter and prior gradients and the loss terms are all-reduced
  (sum) in one flat bucket, the instance count by a maximum;
* each camera's densification statistics (its viewspace gradient from
  its T tap's, its t-gradient from its t tap's, both times B, its radii
  and visibility) are all-gathered and applied by
  ``add_densification_stats`` in global camera order 0..B-1 on every
  rank, as B sequential single-camera steps would apply them, so the
  statistics stay identical across ranks;
* per-group Adam and the prior's Adam run replicated on the reduced
  gradients.

The collectives run at every world size, one rank included.
"""

from __future__ import annotations

import os
import socket
from typing import NamedTuple, Sequence

import numpy as np
import torch

from gslidar_tpu_torch.engine.losses import compute_losses
from gslidar_tpu_torch.engine.render import render
from gslidar_tpu_torch.engine.train import (CameraBatch, TrainState,
                                            _transmat_for_stats)
from gslidar_tpu_torch.models import gaussians as G
from gslidar_tpu_torch.models.densify import add_densification_stats
from gslidar_tpu_torch.models.optim import adam_step, group_lrs
from gslidar_tpu_torch.models.raydrop_prior import PriorAdam
from gslidar_tpu_torch.parallel.comm import Loopback, ProcessGroup
from gslidar_tpu_torch.raster.rasterize import densify_grads_from_T_tap
from gslidar_tpu_torch.raster.settings import RasterSettings


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device) -> torch.device:
    """The device of this process's rank: ``cuda:LOCAL_RANK`` for an
    unnumbered CUDA device (``LOCAL_RANK`` as ``torch.distributed.run``
    sets it, else 0), the device itself otherwise."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def init_group(device) -> ProcessGroup:
    """This process's rank of the default ``torch.distributed`` group,
    set up on first call: NCCL for a CUDA ``device``, gloo for the CPU.
    Under ``torch.distributed.run`` the rank and world size come from its
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``); without it the group has one rank, on a free
    localhost port. A CUDA device becomes the current device. NCCL that is
    missing or fails to start raises: there is no fallback to gloo."""
    import torch.distributed as dist
    device = rank_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this torch build has no NCCL")
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                rank=0, world_size=1)
    if str(dist.get_backend()) != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, "
                           f"{device} needs {backend}")
    return ProcessGroup()


def make_mesh(n_devices: int | None = None, device="cuda") -> ProcessGroup:
    """``init_group(device)``, whose world size must be ``n_devices`` when
    that is given. (All n ranks in this process: ``comm.Loopback(n)``.)"""
    group = init_group(device)
    if n_devices is not None and n_devices != group.size:
        raise ValueError(f"{n_devices} devices asked, the group has "
                         f"{group.size} ranks")
    return group


def stack_camera_batch(cams: Sequence[CameraBatch]) -> CameraBatch:
    """B single cameras -> one CameraBatch with a leading batch axis of B
    (tensors stacked; timestamps and halves as tuples)."""
    return CameraBatch(
        viewmat=torch.stack([c.viewmat for c in cams]),
        campos=torch.stack([c.campos for c in cams]),
        timestamp=tuple(float(c.timestamp) for c in cams),
        towards_idx=tuple(int(c.towards_idx) for c in cams),
        pts_depth=torch.stack([c.pts_depth for c in cams]),
        pts_intensity=torch.stack([c.pts_intensity for c in cams]))


def camera_at(cams: CameraBatch, i: int) -> CameraBatch:
    """Camera i of a stacked CameraBatch."""
    return CameraBatch(viewmat=cams.viewmat[i], campos=cams.campos[i],
                       timestamp=cams.timestamp[i],
                       towards_idx=cams.towards_idx[i],
                       pts_depth=cams.pts_depth[i],
                       pts_intensity=cams.pts_intensity[i])


class RankGrads(NamedTuple):
    """One rank's share of a data-parallel step."""
    flat: torch.Tensor      # parameter and prior gradients, then the loss
                            # terms' sums over its cameras
    stats: torch.Tensor     # [b, P, 5]: viewspace gradient (2), t
                            # gradient, radius, visibility, per camera
    pairs: torch.Tensor     # [1] int64: its largest instance count
    log_keys: list          # the loss terms' names, in ``flat``'s order


def make_parallel_train_step(args, cfg: G.GaussianConfig,
                             settings: RasterSettings, bg, group, *,
                             n_cameras: int | None = None):
    """Data-parallel twin of ``engine.train.make_train_step``:
    ``train_step(state, cams, iteration, sh_degree, time_shift, stats_on,
    apply_update=True)`` -> (new state, loss, log, grads), where ``cams``
    is the iteration's global batch of B = ``n_cameras`` (default the
    group's size) cameras (``stack_camera_batch``), ``time_shift`` its B
    shifts, loss and the log's loss terms means over B, ``log
    ["num_pairs"]`` the largest instance count and grads the reduced mean
    gradients (with the prior's as ``"prior"``). B must divide by the
    group's size."""
    B = n_cameras or group.size
    if B % group.size:
        raise ValueError(f"{B} cameras per step do not divide over "
                         f"{group.size} ranks")
    per_rank = B // group.size
    dynamic = bool(args.dynamic)
    median_depth = bool(args.get("median_depth", False))
    sf = float(args.scale_factor)

    def rank_grads(state, cams, r, iteration, sh_degree, time_shift,
                   keys):
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        prior = state.prior.detach().requires_grad_(True)
        P = state.aux.alive.shape[0]
        dev = prior.device
        alive_f = state.aux.alive.to(torch.float32)
        mine = range(r * per_rank, (r + 1) * per_rank)
        taps, pkgs, logs, loss = [], [], [], 0.0
        for i in mine:
            cam = camera_at(cams, i)
            T_tap = torch.zeros(P, 3, 3, device=dev, requires_grad=True)
            t_tap = torch.zeros(P, 1, device=dev, requires_grad=True)
            pi = {**params, "t": params["t"] + t_tap}
            pkg = render(pi, state.aux.alive, cam.viewmat, cam.campos,
                         cam.timestamp, cam.towards_idx, prior, bg,
                         sh_degree, sf, cfg, settings, dynamic=dynamic,
                         median_depth=median_depth,
                         time_shift=time_shift[i], T_tap=T_tap)
            l_i, log_i = compute_losses(pkg, cam.pts_depth,
                                        cam.pts_intensity, iteration, args,
                                        G.get_opacity(pi)[:, 0], alive_f)
            loss = loss + l_i
            taps += [T_tap, t_tap]
            pkgs.append(pkg)
            logs.append(log_i)
        grads = torch.autograd.grad(loss / B, [params[k] for k in keys]
                                    + [prior] + taps, allow_unused=True)
        n = len(keys) + 1
        flat = [torch.zeros_like(params[k]) if g is None else g
                for k, g in zip(keys, grads[:len(keys)])]
        flat.append(grads[len(keys)])
        log_keys = sorted(logs[0])
        with torch.no_grad():
            sums = torch.stack([
                torch.stack([torch.as_tensor(lg[k], dtype=torch.float32,
                                             device=dev) for lg in logs]
                            ).sum() for k in log_keys])
            stats = []
            for j, i in enumerate(mine):
                cam = camera_at(cams, i)
                gT, gt = grads[n + 2 * j], grads[n + 2 * j + 1]
                gT = torch.zeros(P, 3, 3, device=dev) if gT is None else gT
                gt = torch.zeros(P, 1, device=dev) if gt is None else gt
                vs = densify_grads_from_T_tap(gT * B, _transmat_for_stats(
                    state.params, cam.viewmat, cfg, cam.timestamp,
                    time_shift[i]), settings)
                stats.append(torch.cat(
                    [vs, gt * B, pkgs[j].radii[:, None],
                     pkgs[j].visibility[:, None].to(torch.float32)], 1))
            pairs = torch.tensor([max(p.num_pairs for p in pkgs)],
                                 dtype=torch.int64, device=dev)
            return RankGrads(
                flat=torch.cat([g.reshape(-1) for g in flat] + [sums]),
                stats=torch.stack(stats), pairs=pairs, log_keys=log_keys)

    def train_step(state: TrainState, cams: CameraBatch, iteration,
                   sh_degree, time_shift, stats_on, apply_update=True):
        if len(cams.timestamp) != B or len(time_shift) != B:
            raise ValueError(f"the step takes {B} cameras and shifts, got "
                             f"{len(cams.timestamp)} and {len(time_shift)}")
        keys = list(state.params)
        mine = [rank_grads(state, cams, r, iteration, sh_degree,
                           [float(t) for t in time_shift], keys)
                for r in group.ranks]
        flat = group.all_reduce([m.flat for m in mine], "sum")[0]
        pairs = group.all_reduce([m.pairs for m in mine], "max")[0]
        with torch.no_grad():
            gp, off = {}, 0
            for k in keys:
                v = state.params[k]
                gp[k] = flat[off:off + v.numel()].view_as(v)
                off += v.numel()
            gprior = flat[off:off + state.prior.numel()].view_as(state.prior)
            off += state.prior.numel()
            terms = flat[off:] / B
            aux = state.aux
            if stats_on:
                every = group.all_gather([m.stats for m in mine], 0)[0]
                for i in range(B):
                    s = every[i]
                    aux = add_densification_stats(aux, s[:, :2], s[:, 2:3],
                                                  s[:, 3], s[:, 4] > 0)
            if apply_update:
                new_params, new_opt = adam_step(
                    state.params, gp, state.opt, group_lrs(args, iteration))
            else:
                new_params, new_opt = state.params, state.opt
            new_prior, new_prior_opt = PriorAdam.step(
                state.prior, gprior, state.prior_opt, args.raydrop_prior_lr)
        log = dict(zip(mine[0].log_keys, terms.unbind()))
        log["num_pairs"] = int(pairs[0])
        return (TrainState(new_params, aux, new_opt, new_prior,
                           new_prior_opt), log["loss"], log,
                {**gp, "prior": gprior})

    return train_step


def _toy_camera_batch(n, H, W, seed=0, device="cpu") -> CameraBatch:
    """n seeded cameras at the origin looking down +z (the JAX package's
    ``_toy_camera_batch`` draws, in its order)."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    return CameraBatch(
        viewmat=t(np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))),
        campos=t(np.zeros((n, 3))),
        timestamp=tuple(float(x) for x in
                        np.linspace(-0.5, 0.5, n).astype(np.float32)),
        towards_idx=tuple(int(x) for x in np.arange(n) % 2),
        pts_depth=t(rng.uniform(0, 30, (n, 1, H, W))),
        pts_intensity=t(rng.uniform(0, 1, (n, 1, H, W))))


def dryrun_multichip(n_devices: int, device="cuda", *,
                     loopback: bool = False) -> None:
    """One full data-parallel step (render, the 13 losses, backward,
    per-group Adam, densification statistics, the prior's Adam) of B =
    ``n_devices`` cameras at tiny shapes, then a gaussian-sharded 360°
    render of the result, on ``make_mesh(n_devices, device)``, or with
    ``loopback`` on ``Loopback(n_devices)``."""
    from gslidar_tpu_torch.config import Config
    from gslidar_tpu_torch.engine.train import init_train_state
    from gslidar_tpu_torch.models.raydrop_prior import init_raydrop_prior
    from gslidar_tpu_torch.parallel.pano_shard import (
        render_pano_gaussian_sharded)

    group = Loopback(n_devices) if loopback else make_mesh(n_devices,
                                                            device)
    device = rank_device(device)
    H, W = 32, 64
    settings = RasterSettings(height=H, width=W, vfov=(-24.9, 2.0),
                              hfov=(-90, 90), num_extra_features=4)
    cfg = G.GaussianConfig(random_init_point=0)
    args = Config({
        "dynamic": True, "scale_factor": 1.0, "sky_depth": False,
        "median_depth": False, "vfov": (-24.9, 2.0), "hfov": (-90, 90),
        "lambda_distortion": 0.1, "lambda_lidar": 10.0,
        "lambda_lidar_median": 10.0, "lambda_t_reg": 0.0,
        "lambda_v_reg": 0.01, "lambda_intensity_sh": 0.05,
        "lambda_raydrop": 0.05, "lambda_chamfer": 0.1, "lambda_smooth": 1e-3,
        "lambda_tv": 0.0, "lambda_gs_opa": 0.0,
        "lambda_normal_consistency": 0.1, "lambda_opacity_entropy": 0.05,
        "lambda_depth_var": 0.0, "lidar_decay": 0.0,
        "raydrop_prior_lr": 0.1,
        "iterations": 1000, "position_lr_init": 1.6e-4,
        "position_lr_final": 1.6e-6, "position_lr_delay_mult": 0.01,
        "t_lr_init": 8e-4, "feature_lr": 2.5e-3, "opacity_lr": 5e-3,
        "scaling_lr": 5e-3, "scaling_t_lr": 2e-3, "rotation_lr": 1e-3,
        "velocity_lr": 1e-3, "intensity_lr": 0.1,
    })
    rng = np.random.default_rng(0)
    P = 2048
    pts = rng.uniform(-1, 1, (P, 3)).astype(np.float32) * [5, 5, 20]
    pts[:, 2] += 25
    colors = rng.uniform(0, 1, (P, 3)).astype(np.float32)
    params, aux = G.create_from_pcd(pts.astype(np.float32), colors, None,
                                    cfg, device=device)
    state = init_train_state(params, aux, init_raydrop_prior(H, W, device))
    bg = torch.tensor([0, 0, 0, 1.0], device=device)
    step = make_parallel_train_step(args, cfg, settings, bg, group,
                                    n_cameras=n_devices)
    new_state, loss, _, _ = step(state, _toy_camera_batch(n_devices, H, W,
                                                          device=device),
                                 100, 3, [0.0] * n_devices, True)
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    if not bool((new_state.params["xyz"] != state.params["xyz"]).any()):
        raise RuntimeError("parameters did not update")
    if not float(new_state.aux.denom.max()) > 0:
        raise RuntimeError("no densification statistics")

    import dataclasses
    p = new_state.params
    Pn = p["xyz"].shape[0] // n_devices * n_devices
    ws = dataclasses.replace(settings, width=32 * n_devices,
                             hfov=(-180.0, 180.0), wrap_x=True, tile_h=8,
                             tile_w=32)
    with torch.no_grad():
        out = render_pano_gaussian_sharded(
            G.get_xyz_shm(p, 0.0, cfg)[:Pn], G.get_scaling(p)[:Pn],
            p["rotation"][:Pn], G.get_opacity(p)[:Pn, 0],
            G.get_features(p)[:Pn], torch.zeros(Pn, 4, device=device),
            new_state.aux.alive[:Pn], torch.eye(4, device=device),
            torch.zeros(3, device=device), bg, 3, 1.0, ws, group)
    if not bool(torch.isfinite(out[0]).all()) or out[6] != 0:
        raise RuntimeError(f"gaussian-sharded render: finite "
                           f"{bool(torch.isfinite(out[0]).all())}, "
                           f"dropped {out[6]}")
    print(f"dryrun_multichip({n_devices}): loss={loss:.5f} "
          f"gshard_dropped={out[6]} ok ({group.backend})")
