"""Port parity of the training slice (gslidar_tpu_torch: ops.losses,
ops.pano.depth_to_normal, ops.chamfer, ops.knn, models.gaussians.
create_from_pcd, engine.losses and engine.train.make_train_step) against
gslidar_tpu on the CPU, on seeded numpy inputs.

* each loss primitive: value and gradient at rtol 1e-5 (chamfer and the
  3-NN distance: the same neighbours, exact distances);
* ``create_from_pcd`` against JAX's alive rows from the same seed: the
  same numpy draws, so equal but for the scales, which come from the 3-NN
  distances (JAX shortlists the neighbours by a matmul; the port's search
  is exact): rtol 1e-5 on the log-scales;
* one train step against gslidar_tpu's make_train_step, built as
  tests/test_parallel_train_e2e.py builds it (XLA compositor, 16x16 tiles,
  32x64 pixels, 2048 gaussians, kitti360_nvs_1908's lambdas, dynamic,
  iteration 7001 so every schedule is on): the loss and each logged term
  at rtol 1e-3; per param group ||g_port - g_jax|| <= 1e-3 ||g_jax||, and
  the prior's; the densification statistics; and the post-Adam params
  where |g| >= 1e-3 max|g| of their group (the first Adam step moves a
  param by about lr * sign(g), so sign noise on gradients near zero is no
  fault).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

H, W = 32, 64
VFOV, HFOV = (-24.9, 2.0), (-90.0, 90.0)


def _close(a, b, rtol, name=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-30)
    assert np.abs(a - b).max() <= rtol * scale, (name, np.abs(a - b).max(),
                                                 scale)


def _loss_case(name, rng):
    """(jax function, port function, numpy inputs) of one primitive; each
    function maps its inputs to a scalar."""
    import jax.numpy as jnp
    from gslidar_tpu.ops import chamfer as jc
    from gslidar_tpu.ops import knn as jk
    from gslidar_tpu.ops import losses as jl
    from gslidar_tpu.ops import pano as jp
    from gslidar_tpu_torch.ops import chamfer as tc
    from gslidar_tpu_torch.ops import knn as tk
    from gslidar_tpu_torch.ops import losses as tl
    from gslidar_tpu_torch.ops import pano as tp
    depth = rng.uniform(2, 30, (1, 16, 32)).astype(np.float32)
    gt = np.where(rng.random((1, 16, 32)) < 0.3, 0.0,
                  depth + rng.normal(0, 0.5, depth.shape)).astype(np.float32)
    wgt = rng.normal(size=(3, 16, 32)).astype(np.float32)
    if name == "masked_l1":
        return (lambda d: jl.masked_l1(d, gt, gt > 0),
                lambda d: tl.masked_l1(d, torch.as_tensor(gt),
                                       torch.as_tensor(gt > 0)), [depth])
    if name == "binary_cross_entropy":
        p = rng.uniform(0, 1, depth.shape).astype(np.float32)
        t = (gt == 0).astype(np.float32)
        return (lambda x: jl.binary_cross_entropy(x, t),
                lambda x: tl.binary_cross_entropy(x, torch.as_tensor(t)), [p])
    if name == "tv_loss":
        return jl.tv_loss, tl.tv_loss, [depth]
    if name == "grad_smooth_loss":
        return (lambda d: jl.grad_smooth_loss(d, gt, 0.5),
                lambda d: tl.grad_smooth_loss(d, torch.as_tensor(gt), 0.5),
                [depth])
    if name == "depth_to_normal":
        return (lambda d: jnp.sum(jp.depth_to_normal(d, VFOV, HFOV) * wgt),
                lambda d: torch.sum(tp.depth_to_normal(d, VFOV, HFOV)
                                    * torch.as_tensor(wgt)), [depth])
    if name == "chamfer_distance":
        a = rng.normal(size=(700, 3)).astype(np.float32) * 5
        b = rng.normal(size=(500, 3)).astype(np.float32) * 5
        m1, m2 = rng.random(700) < 0.8, rng.random(500) < 0.7

        def jf(x, y):
            d1, d2, s1, s2 = jc.chamfer_distance(x, y, jnp.asarray(m1),
                                                 jnp.asarray(m2), chunk=256)
            return s1 + s2 + 0.1 * jnp.sum(d1 * d1) + 0.1 * jnp.sum(d2)

        def tf(x, y):
            d1, d2, s1, s2 = tc.chamfer_distance(x, y, torch.as_tensor(m1),
                                                 torch.as_tensor(m2),
                                                 chunk=256)
            return s1 + s2 + 0.1 * torch.sum(d1 * d1) + 0.1 * torch.sum(d2)
        return jf, tf, [a, b]
    if name == "mean_sq_dist_knn3":
        pts = rng.normal(size=(1500, 3)).astype(np.float32) * [3, 3, 10]
        pts = pts.astype(np.float32)
        return (lambda p: jnp.sum(jk.mean_sq_dist_knn3(p, chunk=512) ** 0.5),
                lambda p: torch.sum(tk.mean_sq_dist_knn3(p, chunk=512)
                                    ** 0.5), [pts])
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "masked_l1", "binary_cross_entropy", "tv_loss", "grad_smooth_loss",
    "depth_to_normal", "chamfer_distance", "mean_sq_dist_knn3"])
def test_loss_primitive_matches_jax(name):
    import jax
    import jax.numpy as jnp
    jf, tf, inputs = _loss_case(name, np.random.default_rng(5))
    jv = jf(*[jnp.asarray(x) for x in inputs])
    targs = [torch.tensor(x, requires_grad=name != "mean_sq_dist_knn3")
             for x in inputs]
    tv = tf(*targs)
    _close(float(tv), float(jv), 1e-5, name)
    if name == "mean_sq_dist_knn3":
        return                           # no gradient: an init-time op
    jg = jax.grad(jf, argnums=tuple(range(len(inputs))))(
        *[jnp.asarray(x) for x in inputs])
    tg = torch.autograd.grad(tv, targs)
    for a, b in zip(tg, jg):
        _close(a.numpy(), b, 1e-5, name)


def _pcd(rng, n=2048):
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32) * [5, 5, 20]
    pts[:, 2] += 25
    return (pts.astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32))


@pytest.mark.parametrize("random_init_point", [0, 300])
def test_create_from_pcd_matches_jax(random_init_point):
    from gslidar_tpu.models import gaussians as JG
    from gslidar_tpu_torch.models import gaussians as TG
    pts, colors = _pcd(np.random.default_rng(1), 1000)
    kw = dict(random_init_point=random_init_point, t_init=0.1)
    jp, jaux = JG.create_from_pcd(pts, colors, None, JG.GaussianConfig(**kw),
                                  seed=3)
    tp, taux = TG.create_from_pcd(pts, colors, None, TG.GaussianConfig(**kw),
                                  seed=3)
    alive = np.asarray(jaux.alive)
    n = 1000 + 2 * random_init_point
    assert int(alive.sum()) == n and tp["xyz"].shape == (n, 3)
    assert bool(taux.alive.all()) and float(taux.denom.abs().sum()) == 0
    for k in TG.PARAM_KEYS:
        a = np.asarray(jp[k])[alive]
        b = tp[k].numpy()
        assert a.shape == b.shape, k
        if k == "scaling":
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


def _args():
    from gslidar_tpu.config import Config
    # kitti360_nvs_1908's lambdas (configs/kitti360_nvs_1908.yaml with
    # configs/base.yaml), dynamic so that every param group has a gradient
    return Config({
        "dynamic": True, "scale_factor": 1.0, "sky_depth": False,
        "median_depth": False, "vfov": VFOV, "hfov": HFOV,
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


def test_train_step_matches_jax():
    import jax
    import jax.numpy as jnp
    from gslidar_tpu.engine import train as JT
    from gslidar_tpu.models import gaussians as JG
    from gslidar_tpu.models.raydrop_prior import init_raydrop_prior
    from gslidar_tpu.raster.settings import RasterSettings as JS
    from gslidar_tpu_torch.engine import train as TT
    from gslidar_tpu_torch.models import gaussians as TG
    from gslidar_tpu_torch.raster.settings import RasterSettings as TS

    args = _args()
    rng = np.random.default_rng(0)
    pts, colors = _pcd(rng)
    params, aux = JG.create_from_pcd(pts, colors, None,
                                     JG.GaussianConfig(random_init_point=0),
                                     capacity=4096)
    state0 = JT.init_train_state(params, aux, init_raydrop_prior(H, W))
    cam = dict(viewmat=np.eye(4, dtype=np.float32),
               campos=np.zeros(3, np.float32), timestamp=0.1, towards_idx=1,
               pts_depth=rng.uniform(0, 30, (1, H, W)).astype(np.float32),
               pts_intensity=rng.uniform(0, 1, (1, H, W)).astype(np.float32))
    cam["pts_depth"][rng.random((1, H, W)) < 0.3] = 0.0
    iteration, sh, stats_on = 7001, 3, True

    jstep = JT.make_train_step(
        args, JG.GaussianConfig(random_init_point=0),
        JS(height=H, width=W, vfov=VFOV, hfov=HFOV, num_extra_features=4,
           pair_cap=1 << 14, tile_chunk=16, tile_list_cap=1024,
           backend="xla"), jnp.asarray([0, 0, 0, 1.0]))
    jcam = JT.CameraBatch(
        **{k: jnp.asarray(v, jnp.int32 if k == "towards_idx" else None)
           for k, v in cam.items()})
    js, jloss, jlog = jstep(state0, jcam, jnp.asarray(float(iteration)),
                            jnp.asarray(sh, jnp.int32), jnp.asarray(0.0),
                            jnp.asarray(stats_on))
    js = jax.tree.map(np.asarray, js)
    keep = np.asarray(state0.aux.alive)

    tstate = TT.state_from_numpy(jax.tree.map(np.asarray, state0), "cpu")
    tstep = TT.make_train_step(
        args, TG.GaussianConfig(random_init_point=0),
        TS(height=H, width=W, vfov=VFOV, hfov=HFOV, num_extra_features=4),
        torch.tensor([0, 0, 0, 1.0]))
    tcam = TT.CameraBatch(
        viewmat=torch.as_tensor(cam["viewmat"]),
        campos=torch.as_tensor(cam["campos"]), timestamp=cam["timestamp"],
        towards_idx=cam["towards_idx"],
        pts_depth=torch.as_tensor(cam["pts_depth"]),
        pts_intensity=torch.as_tensor(cam["pts_intensity"]))
    ts, tloss, tlog, tgrads = tstep(tstate, tcam, iteration, sh, 0.0,
                                    stats_on)

    _close(float(tloss), float(jloss), 1e-3, "loss")
    for k, v in jlog.items():
        if k.startswith("loss"):
            _close(float(tlog[k]), float(v), 1e-3, k)
    # gradients: JAX's first Adam moment is (1 - 0.9) * g
    for k in TG.PARAM_KEYS:
        g_jax = np.asarray(js.opt.mu[k])[keep] / np.float32(0.1)
        g = tgrads[k].numpy()
        assert np.isfinite(g).all(), k
        ref = np.linalg.norm(g_jax)
        if k == "intensity":             # not rendered: no gradient
            assert ref == 0 and not g.any()
            continue
        assert ref > 0, k
        assert np.linalg.norm(g - g_jax) <= 1e-3 * ref, k
        # post-Adam params where the gradient is not near zero
        big = np.abs(g_jax) >= 1e-3 * np.abs(g_jax).max()
        np.testing.assert_allclose(ts.params[k].numpy()[big],
                                   np.asarray(js.params[k])[keep][big],
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    g_jax = np.asarray(js.prior_opt[0]) / np.float32(0.1)
    assert np.linalg.norm(tgrads["prior"].numpy() - g_jax) <= \
        1e-3 * np.linalg.norm(g_jax)
    _close(ts.prior.numpy(), np.asarray(js.prior), 1e-5, "prior")
    # densification statistics
    for k in ("max_radii2D", "denom"):
        np.testing.assert_array_equal(getattr(ts.aux, k).numpy(),
                                      np.asarray(getattr(js.aux, k))[keep],
                                      err_msg=k)
    assert float(ts.aux.denom.max()) > 0
    for k in ("xyz_gradient_accum", "t_gradient_accum"):
        a = np.asarray(getattr(js.aux, k))[keep]
        assert np.linalg.norm(getattr(ts.aux, k).numpy() - a) <= \
            1e-3 * np.linalg.norm(a), k


def test_trainer_refuses_the_densification_window(tmp_path):
    """Densification is not ported: a run that would reach it raises
    instead of silently training without it."""
    import os
    from gslidar_tpu.config import load_run_config
    from gslidar_tpu_torch.train import training
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = load_run_config(
        os.path.join(repo, "configs", "base.yaml"),
        os.path.join(repo, "configs", "synthetic_smoke.yaml"),
        ["iterations=50", f"model_path={tmp_path}"])
    assert args.densify_from_iter == 50
    with pytest.raises(NotImplementedError, match="densif"):
        training(args, "cpu")
