"""Seeded inputs shared by the tests/test_torch_*.py parity tests, and
the train-step comparison several of them make.

Every scene is numpy, made from a seed, and handed to both packages: the
JAX reference (``gslidar_tpu``) and the PyTorch port
(``gslidar_tpu_torch``). The JAX side runs its plain XLA path
(``backend="xla"``) with caps large enough that nothing is dropped. The
scenes themselves are the port's (``gslidar_tpu_torch.raster.scenes``),
which its smoke test on the card uses too.
"""

import numpy as np

from gslidar_tpu_torch.raster.scenes import (  # noqa: F401
    deep_tile_scene, long_tile_scene, opaque_front_tile_scene, port_rows,
    splat_scene)


def settings_pair(height=30, width=130, hfov=(-60.0, 60.0), S=2,
                  wrap=False, tile_h=16, tile_w=16, **kw):
    """(JAX RasterSettings, port RasterSettings) of one panorama."""
    from gslidar_tpu.raster.settings import RasterSettings as JS
    from gslidar_tpu_torch.raster.settings import RasterSettings as TS
    common = dict(height=height, width=width, vfov=(-20.0, 20.0), hfov=hfov,
                  num_extra_features=S, tile_h=tile_h, tile_w=tile_w,
                  wrap_x=wrap, **kw)
    js = JS(pair_cap=1 << 16, tile_chunk=32, tile_list_cap=1 << 12,
            backend="xla", **common)
    return js, TS(**common)


def to_torch(sc):
    import torch
    return {k: torch.as_tensor(v) for k, v in sc.items()}


def to_jax(sc):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in sc.items()}


# ------------------------------------------------- one train step, both
STEP_H, STEP_W = 32, 64
STEP_VFOV, STEP_HFOV = (-24.9, 2.0), (-90.0, 90.0)


def step_args():
    """kitti360_nvs_1908's lambdas and learning rates
    (configs/kitti360_nvs_1908.yaml with configs/base.yaml), dynamic so
    that every param group has a gradient."""
    from gslidar_tpu.config import Config
    return Config({
        "dynamic": True, "scale_factor": 1.0, "sky_depth": False,
        "median_depth": False, "vfov": STEP_VFOV, "hfov": STEP_HFOV,
        "lambda_distortion": 0.1, "lambda_lidar": 10.0,
        "lambda_lidar_median": 10.0, "lambda_t_reg": 0.0,
        "lambda_v_reg": 0.01, "lambda_intensity_sh": 0.05,
        "lambda_raydrop": 0.05, "lambda_chamfer": 0.1, "lambda_smooth": 1e-3,
        "lambda_tv": 0.0, "lambda_gs_opa": 0.0,
        "lambda_normal_consistency": 0.1, "lambda_opacity_entropy": 0.05,
        "lambda_depth_var": 0.0, "lidar_decay": 0.0,
        "raydrop_prior_lr": 0.1,
        "iterations": 30000, "position_lr_init": 1.6e-4,
        "position_lr_final": 1.6e-6, "position_lr_delay_mult": 0.01,
        "t_lr_init": 8e-4, "feature_lr": 2.5e-3, "opacity_lr": 5e-3,
        "scaling_lr": 5e-3, "scaling_t_lr": 2e-3, "rotation_lr": 1e-3,
        "velocity_lr": 1e-3, "intensity_lr": 0.1,
    })


def step_pcd(rng, n=2048):
    """A seeded point cloud in front of the step camera, and its colors."""
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32) * [5, 5, 20]
    pts[:, 2] += 25
    return (pts.astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32))


def step_camera(rng):
    """The step's camera: identity pose, backward half, seeded GT."""
    cam = dict(viewmat=np.eye(4, dtype=np.float32),
               campos=np.zeros(3, np.float32), timestamp=0.1, towards_idx=1,
               pts_depth=rng.uniform(0, 30, (1, STEP_H, STEP_W)).astype(
                   np.float32),
               pts_intensity=rng.uniform(0, 1, (1, STEP_H, STEP_W)).astype(
                   np.float32))
    cam["pts_depth"][rng.random((1, STEP_H, STEP_W)) < 0.3] = 0.0
    return cam


def to_jax_state(s):
    """The port's TrainState of numpy leaves (``state_to_numpy``) ->
    gslidar_tpu's TrainState of jnp arrays."""
    import jax
    import jax.numpy as jnp
    from gslidar_tpu.engine.train import TrainState
    from gslidar_tpu.models.gaussians import GaussianAux
    from gslidar_tpu.models.optim import AdamState
    return jax.tree.map(jnp.asarray, TrainState(
        params=s.params, aux=GaussianAux(**vars(s.aux)),
        opt=AdamState(*s.opt), prior=s.prior, prior_opt=tuple(s.prior_opt)))


def _rel_close(a, b, rtol, name=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-30)
    assert np.abs(a - b).max() <= rtol * scale, (name, np.abs(a - b).max(),
                                                 scale)


def assert_step_matches(jstate, tstate, cam, iteration=7001, sh=3,
                        stats_on=True, args=None, cfg_kw=None,
                        time_shift=0.0, no_grad_keys=("intensity",)):
    """One step of gslidar_tpu's make_train_step from ``jstate`` (its
    TrainState) and one of the port's from ``tstate`` (the same gaussians,
    ``jstate``'s alive slots in order) on ``cam`` (``step_camera``, or any
    dict of its keys: the panorama's size is its GT's), both with ``args``
    (default ``step_args``), the GaussianConfig of ``cfg_kw`` (default
    ``random_init_point=0``), the self-supervision ``time_shift``, 16x16
    tiles and JAX's XLA compositor at caps that drop no instance: the loss
    and
    each logged term at rtol 1e-3; per param group ||g_port - g_jax|| <=
    1e-3 ||g_jax||, and the prior's; the densification statistics; and the
    post-Adam params where |g| >= 1e-3 max|g| of their group (the first
    Adam step moves a param by about lr * sign(g), so sign noise on
    gradients near zero is no fault). The groups of ``no_grad_keys`` (the
    ones the render does not reach: intensity, and a static model's t,
    scaling_t and velocity) must have a zero gradient on both sides. JAX's
    gradient is read off its first moment, (mu' - 0.9 mu) / 0.1. Returns
    the port's new state."""
    import jax
    import jax.numpy as jnp
    import torch
    from gslidar_tpu.engine import train as JT
    from gslidar_tpu.models import gaussians as JG
    from gslidar_tpu.raster.settings import RasterSettings as JS
    from gslidar_tpu_torch.engine import train as TT
    from gslidar_tpu_torch.models import gaussians as TG
    from gslidar_tpu_torch.raster.settings import RasterSettings as TS

    args = step_args() if args is None else args
    cfg_kw = dict(random_init_point=0) if cfg_kw is None else cfg_kw
    h, w = cam["pts_depth"].shape[-2:]
    fov = dict(height=h, width=w, vfov=tuple(args.vfov),
               hfov=tuple(args.hfov), num_extra_features=4)
    jstep = JT.make_train_step(
        args, JG.GaussianConfig(**cfg_kw),
        JS(pair_cap=1 << 14, tile_chunk=16, tile_list_cap=4096,
           backend="xla", **fov), jnp.asarray([0, 0, 0, 1.0]))
    jcam = JT.CameraBatch(
        **{k: jnp.asarray(v, jnp.int32 if k == "towards_idx" else None)
           for k, v in cam.items()})
    js, jloss, jlog = jstep(jstate, jcam, jnp.asarray(float(iteration)),
                            jnp.asarray(sh, jnp.int32),
                            jnp.asarray(time_shift, jnp.float32),
                            jnp.asarray(stats_on))
    assert int(jlog["num_dropped"]) == 0      # the caps clipped nothing
    js = jax.tree.map(np.asarray, js)
    j0 = jax.tree.map(np.asarray, jstate)
    keep = j0.aux.alive

    tstep = TT.make_train_step(args, TG.GaussianConfig(**cfg_kw), TS(**fov),
                               torch.tensor([0, 0, 0, 1.0]))
    tcam = TT.CameraBatch(
        viewmat=torch.as_tensor(cam["viewmat"]),
        campos=torch.as_tensor(cam["campos"]), timestamp=cam["timestamp"],
        towards_idx=cam["towards_idx"],
        pts_depth=torch.as_tensor(cam["pts_depth"]),
        pts_intensity=torch.as_tensor(cam["pts_intensity"]))
    ts, tloss, tlog, tgrads = tstep(tstate, tcam, iteration, sh,
                                    float(time_shift), stats_on)

    _rel_close(float(tloss), float(jloss), 1e-3, "loss")
    for k, v in jlog.items():
        if k.startswith("loss"):
            _rel_close(float(tlog[k]), float(v), 1e-3, k)
    f01, f09 = np.float32(0.1), np.float32(0.9)
    for k in TG.PARAM_KEYS:
        g_jax = ((js.opt.mu[k] - f09 * j0.opt.mu[k]) / f01)[keep]
        g = tgrads[k].numpy()
        assert np.isfinite(g).all(), k
        ref = np.linalg.norm(g_jax)
        if k in no_grad_keys:            # not rendered: no gradient
            assert ref == 0 and not g.any(), k
            continue
        assert ref > 0, k
        assert np.linalg.norm(g - g_jax) <= 1e-3 * ref, k
        # post-Adam params where the gradient is not near zero
        big = np.abs(g_jax) >= 1e-3 * np.abs(g_jax).max()
        np.testing.assert_allclose(ts.params[k].numpy()[big],
                                   js.params[k][keep][big],
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    g_jax = (js.prior_opt[0] - f09 * j0.prior_opt[0]) / f01
    assert np.linalg.norm(tgrads["prior"].numpy() - g_jax) <= \
        1e-3 * np.linalg.norm(g_jax)
    _rel_close(ts.prior.numpy(), js.prior, 1e-5, "prior")
    # densification statistics
    for k in ("max_radii2D", "denom"):
        np.testing.assert_array_equal(getattr(ts.aux, k).numpy(),
                                      getattr(js.aux, k)[keep], err_msg=k)
    if stats_on:
        assert float(ts.aux.denom.max()) > float(tstate.aux.denom.max())
    for k in ("xyz_gradient_accum", "t_gradient_accum"):
        a = getattr(js.aux, k)[keep]
        assert np.linalg.norm(getattr(ts.aux, k).numpy() - a) <= \
            1e-3 * np.linalg.norm(a), k
    return ts
