"""The multi-rank path on W ranks, held against the loopback.

    python -m torch.distributed.run --standalone --nproc_per_node=W \
        -m gslidar_tpu_torch.parallel.check [--device cpu] \
        [--gaussians N] [--height H] [--slice-width S]

Each rank of a group of W (NCCL on ``cuda:LOCAL_RANK``, gloo with
``--device cpu``) builds the same seeded model of N gaussians all around
the camera, then:

* one data-parallel step of B = W cameras (one per rank, a half
  panorama of H x 515): the result of the group against the same step
  over ``Loopback(W)`` on this rank (loss and logged terms at 1e-5
  relative, ``denom`` and ``max_radii2D`` equal, the accumulators and
  the gradients at 2e-4 relative by norm: the group sums its ranks'
  gradients in its own order, and the card's per-gaussian reduction
  adds in atomic order), and every rank's new state bit for bit the
  same;
* the hfov-sliced, SH-sharded and gaussian-sharded renders of an H x
  (W * S) 360-degree panorama with one slice per rank: bit for bit the
  loopback's (each rank runs its slice's stages exactly as the loopback
  does, and the collectives only move data), no instance dropped;
* timings (the host clock around synchronised calls, median of 5, on
  rank 0): the step over the group and over the loopback, one
  single-camera step, the flat all-reduce alone, each sharded render
  over the group and the unsliced render.

Rank 0 prints one JSON line of the checks and timings, with the cards'
names and power limits (nvidia-smi); any failed check raises on the
rank that saw it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import numpy as np
import torch

from gslidar_tpu_torch.parallel.comm import Loopback


def seeded_params(n, seed, device):
    """n gaussians all around the origin at ranges 3-30 (log-uniform),
    extents 5-30 cm, opacities 0.05-0.9, SH degree 3, static."""
    from gslidar_tpu_torch.models.gaussians import params_from_numpy
    from gslidar_tpu_torch.ops.sh import rgb2sh
    rng = np.random.default_rng(seed)
    f32 = np.float32
    theta = rng.uniform(np.pi / 2 - 0.45, np.pi / 2 + 0.1, n)
    phi = rng.uniform(-np.pi, np.pi, n)
    r = np.exp(rng.uniform(np.log(3.0), np.log(30.0), n))
    xyz = np.stack([r * np.sin(theta) * np.sin(phi), -r * np.cos(theta),
                    r * np.sin(theta) * np.cos(phi)], 1)
    f_dc = np.zeros((n, 1, 4), f32)
    f_dc[:, 0, :3] = rgb2sh(rng.uniform(0, 1, (n, 3)))
    f_dc[:, 0, 3] = rgb2sh(rng.uniform(0.0, 0.2, n))
    opa = rng.uniform(0.05, 0.9, (n, 1))
    return params_from_numpy(dict(
        xyz=xyz.astype(f32), f_dc=f_dc,
        f_rest=(rng.normal(size=(n, 15, 4)) * 0.05).astype(f32),
        opacity=np.log(opa / (1 - opa)).astype(f32),
        scaling=np.log(rng.uniform(0.05, 0.3, (n, 3))).astype(f32),
        rotation=rng.normal(size=(n, 4)).astype(f32),
        t=np.zeros((n, 1), f32),
        scaling_t=np.full((n, 1), np.log(np.sqrt(0.1)), f32),
        velocity=np.zeros((n, 3), f32),
        intensity=np.full((n, 1), np.log(0.01 / 0.99), f32)), device)


def step_args():
    """kitti360_nvs_1908's lambdas and learning rates, static."""
    from gslidar_tpu_torch.config import Config
    return Config({
        "dynamic": False, "scale_factor": 1.0, "sky_depth": False,
        "median_depth": False, "vfov": (-24.9, 2.0), "hfov": (-90, 90),
        "lambda_distortion": 0.1, "lambda_lidar": 10.0,
        "lambda_lidar_median": 10.0, "lambda_t_reg": 0.0,
        "lambda_v_reg": 0.01, "lambda_intensity_sh": 0.05,
        "lambda_raydrop": 0.05, "lambda_chamfer": 0.1, "lambda_smooth": 1e-3,
        "lambda_tv": 0.0, "lambda_gs_opa": 0.0,
        "lambda_normal_consistency": 0.1, "lambda_opacity_entropy": 0.05,
        "lambda_depth_var": 0.0, "lidar_decay": 0.0,
        "raydrop_prior_lr": 0.1, "iterations": 30000,
        "position_lr_init": 1.6e-4, "position_lr_final": 1.6e-6,
        "position_lr_delay_mult": 0.01, "t_lr_init": 8e-4,
        "feature_lr": 2.5e-3, "opacity_lr": 5e-3, "scaling_lr": 5e-3,
        "scaling_t_lr": 2e-3, "rotation_lr": 1e-3, "velocity_lr": 1e-3,
        "intensity_lr": 0.1})


def _ms(fn, device, n=5):
    def once():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) * 1e3
    once()
    return statistics.median(once() for _ in range(n))


def _rel(a, b):
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-30))


def check_step(group, device, params, H, out):
    from gslidar_tpu_torch.engine.train import (init_train_state,
                                                make_train_step)
    from gslidar_tpu_torch.models import gaussians as G
    from gslidar_tpu_torch.models.raydrop_prior import init_raydrop_prior
    from gslidar_tpu_torch.parallel.shard import (_toy_camera_batch,
                                                  camera_at,
                                                  make_parallel_train_step)
    from gslidar_tpu_torch.raster.settings import RasterSettings
    W, B = 515, group.size
    args = step_args()
    cfg = G.GaussianConfig(random_init_point=0)
    st = RasterSettings(height=H, width=W, vfov=args.vfov, hfov=args.hfov,
                        num_extra_features=4)
    bg = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
    n = params["xyz"].shape[0]
    state0 = init_train_state(params, G.GaussianAux.zeros(n, device),
                              init_raydrop_prior(H, W, device))
    cams = _toy_camera_batch(B, H, W, device=device)
    shifts, it = [0.0] * B, 5
    steps = {name: make_parallel_train_step(args, cfg, st, bg, g,
                                            n_cameras=B)
             for name, g in (("group", group), ("loopback", Loopback(B)))}
    got = {k: s(state0, cams, it, 3, shifts, True) for k, s in steps.items()}
    (sg, lg, logg, gg), (sl, ll, logl, gl) = got["group"], got["loopback"]
    terms = max(abs(float(logg[k]) - float(logl[k]))
                / max(abs(float(logl[k])), 1e-30)
                for k in logl if k.startswith("loss"))
    equal = {k: bool(torch.equal(getattr(sg.aux, k), getattr(sl.aux, k)))
             for k in ("denom", "max_radii2D")}
    rel = {**{k: _rel(getattr(sg.aux, k), getattr(sl.aux, k))
              for k in ("xyz_gradient_accum", "t_gradient_accum")
              if bool(getattr(sl.aux, k).any())},
           **{f"grad {k}": _rel(gg[k], gl[k]) for k in gl
              if bool(gl[k].any())}}
    # every rank's new state: a float64 checksum per leaf, gathered
    sums = torch.stack([v.double().sum() for v in
                        [*sg.params.values(), sg.prior,
                         *(getattr(sg.aux, k) for k in (
                             "xyz_gradient_accum", "t_gradient_accum",
                             "denom", "max_radii2D"))]])
    every = group.all_gather([sums[None]], 0)[0]
    same = bool((every == every[0]).all())
    ok = (terms <= 1e-5 and all(equal.values()) and max(rel.values()) <= 2e-4
          and same and float(sg.aux.denom.max()) > 0)
    single = make_train_step(args, cfg, st, bg)
    flat = torch.cat([g.reshape(-1) for g in gg.values()])
    out["step"] = dict(
        ok=ok, loss=[float(lg), float(ll)], loss_terms_max_rel=terms,
        equal=equal, max_rel=max(rel.values()), ranks_bitwise=same,
        ms={"group": _ms(lambda: steps["group"](state0, cams, it, 3, shifts,
                                                True), device),
            "loopback": _ms(lambda: steps["loopback"](
                state0, cams, it, 3, shifts, True), device),
            "single camera": _ms(lambda: single(state0, camera_at(cams, 0),
                                                it, 3, 0.0, True), device),
            f"all_reduce of {flat.numel() * 4} bytes": _ms(
                lambda: group.all_reduce([flat]), device)})
    if not ok:
        raise RuntimeError(f"the step over the group disagrees with the "
                           f"loopback: {out['step']}")


def check_renders(group, device, params, H, slice_w, out):
    import gslidar_tpu_torch.parallel.pano_shard as ps
    from gslidar_tpu_torch.models import gaussians as G
    from gslidar_tpu_torch.raster.rasterize import rasterize
    from gslidar_tpu_torch.raster.settings import RasterSettings
    n = group.size
    st = RasterSettings(height=H, width=n * slice_w, vfov=(-24.9, 2.0),
                        hfov=(-180.0, 180.0), num_extra_features=4,
                        compute_distortion=False)
    circ = dataclasses.replace(st, wrap_x=True)
    cfg = G.GaussianConfig(random_init_point=0)
    with torch.no_grad():
        opacity = G.get_opacity(params)[:, 0]
        inputs = (G.get_xyz_shm(params, 0.0, cfg), G.get_scaling(params),
                  params["rotation"], opacity, G.get_features(params),
                  torch.cat([torch.clamp_max(G.get_scaling_t(params), 2.0),
                             G.get_inst_velocity(params, cfg)], 1),
                  opacity > 1.0 / 255.0, torch.eye(4, device=device),
                  torch.zeros(3, device=device),
                  torch.tensor([0.0, 0.0, 0.0, 1.0], device=device), 3, 1.0)
    renders = {"hfov": (ps.render_pano_sharded, st),
               "sh": (ps.render_pano_sh_sharded, st),
               "gaussian": (ps.render_pano_gaussian_sharded, circ)}
    out["renders"], bad = {}, []
    with torch.no_grad():
        for kind, (fn, s) in renders.items():
            a, b = fn(*inputs, s, group), fn(*inputs, s, Loopback(n))
            same = all(torch.equal(x, y) for x, y in zip(a[:6], b[:6]))
            dropped = a[6] if kind == "gaussian" else 0
            out["renders"][kind] = dict(
                bitwise_vs_loopback=same, num_dropped=dropped,
                ms=_ms(lambda fn=fn, s=s: fn(*inputs, s, group), device))
            if not same or dropped:
                bad.append(kind)
        out["renders"]["unsliced ms"] = _ms(lambda: rasterize(*inputs, circ),
                                            device)
    if bad:
        raise RuntimeError(f"sharded renders over the group disagree with "
                           f"the loopback: {bad}")


def main(argv=None):
    from gslidar_tpu_torch.parallel.shard import init_group, rank_device
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--gaussians", type=int, default=1_000_000)
    p.add_argument("--height", type=int, default=66)
    p.add_argument("--slice-width", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    device = rank_device(a.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    group = init_group(device)
    params = seeded_params(a.gaussians, a.seed, device)
    out = {"world_size": group.size, "backend": group.backend,
           "device": "cpu", "gaussians": a.gaussians}
    if device.type == "cuda":
        import subprocess
        out["device"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
    check_step(group, device, params, a.height, out)
    check_renders(group, device, params, a.height, a.slice_width, out)
    out["collectives"] = dict(group.calls)
    group.barrier()
    if group.rank == 0:
        print(json.dumps(out), flush=True)
    import torch.distributed as dist
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
