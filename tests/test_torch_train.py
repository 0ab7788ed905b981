"""Port parity of the training slice (gslidar_tpu_torch: ops.losses,
ops.pano.depth_to_normal, ops.chamfer, ops.knn, models.gaussians.
create_from_pcd, engine.losses and engine.train.make_train_step) against
gslidar_tpu on the CPU, on seeded numpy inputs.

* each loss primitive: value and gradient at rtol 1e-5 (chamfer and the
  3-NN distance: the same neighbours, exact distances);
* the 3-NN's spatial search against its brute-force plain version,
  exactly, on uniform, clustered, duplicated, flat and tiny clouds;
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
from torch_scenes import (STEP_H, STEP_W, assert_step_matches, step_camera,
                          step_pcd)

torch.set_num_threads(2)

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


def _knn_cloud(name, rng):
    if name == "uniform":
        return rng.uniform(-5, 5, (3000, 3))
    if name == "clustered":             # a dense blob, a wide one, outliers
        return np.concatenate([rng.normal(0, 0.01, (1500, 3)),
                               rng.normal(3, 1, (1500, 3)),
                               rng.uniform(-50, 50, (100, 3))])
    if name == "duplicates":
        return np.repeat(rng.uniform(-1, 1, (1000, 3)), 2, axis=0)
    if name == "plane":                 # flat: a lidar ground
        return np.c_[rng.uniform(-10, 10, (3000, 2)), np.zeros(3000)]
    return rng.normal(size=(int(name[-1]), 3))          # "tiny4", "tiny9"


@pytest.mark.parametrize("name", ["uniform", "clustered", "duplicates",
                                  "plane", "tiny4", "tiny9", "few_columns"])
def test_knn3_spatial_search_matches_brute_force(name, monkeypatch):
    """``mean_sq_dist_knn3`` (Morton blocks, a grid, brute force for the
    outliers) equals its plain version, the chunked brute force, exactly:
    the same 3 neighbours, the same recomputed distances. ``few_columns``
    caps a box at 4 columns of cells, so most blocks take the brute-force
    path."""
    from gslidar_tpu_torch.ops import knn as tk
    if name == "few_columns":
        monkeypatch.setattr(tk, "_MAX_COLUMNS", 4)
    pts = torch.as_tensor(_knn_cloud(name if name != "few_columns"
                                     else "uniform",
                                     np.random.default_rng(2)).astype(
        np.float32))
    got = tk.mean_sq_dist_knn3(pts, chunk=256)
    want = tk.mean_sq_dist_knn3_brute(pts, chunk=256)
    assert torch.equal(got, want)
    assert name == "duplicates" or bool((got > 0).all())


@pytest.mark.parametrize("random_init_point", [0, 300])
def test_create_from_pcd_matches_jax(random_init_point):
    from gslidar_tpu.models import gaussians as JG
    from gslidar_tpu_torch.models import gaussians as TG
    pts, colors = step_pcd(np.random.default_rng(1), 1000)
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


def test_train_step_matches_jax():
    from gslidar_tpu.engine import train as JT
    from gslidar_tpu.models import gaussians as JG
    from gslidar_tpu.models.raydrop_prior import init_raydrop_prior
    from gslidar_tpu_torch.engine import train as TT
    import jax

    rng = np.random.default_rng(0)
    pts, colors = step_pcd(rng)
    params, aux = JG.create_from_pcd(pts, colors, None,
                                     JG.GaussianConfig(random_init_point=0),
                                     capacity=4096)
    state0 = JT.init_train_state(params, aux,
                                 init_raydrop_prior(STEP_H, STEP_W))
    tstate = TT.state_from_numpy(jax.tree.map(np.asarray, state0), "cpu")
    assert_step_matches(state0, tstate, step_camera(rng))


@pytest.mark.parametrize("which", ["single", "parallel"])
def test_both_steps_reach_adam_through_the_module(which, monkeypatch):
    """The single-camera step and the data-parallel step (two cameras over
    a loopback of two ranks) both call ``engine.train.adam_step`` through
    the module, where a wrapper put in its place sees the call."""
    import gslidar_tpu_torch.engine.train as T
    from gslidar_tpu_torch.parallel.comm import Loopback
    from gslidar_tpu_torch.parallel.shard import camera_at
    from test_torch_parallel_train import _init_params, _np_args, _port_setup
    adam, calls = T.adam_step, []

    def wrapped(*a, **k):
        calls.append(1)
        return adam(*a, **k)
    params, alive = _init_params()
    args, cfg, st, bg, state0, dp, cams = _port_setup(
        _np_args(), params, alive, Loopback(2), b=2)
    monkeypatch.setattr(T, "adam_step", wrapped)
    if which == "single":
        new = T.make_train_step(args, cfg, st, bg)(
            state0, camera_at(cams, 0), 100, 3, 0.0, True)[0]
    else:
        new = dp(state0, cams, 100, 3, [0.0, 0.0], True)[0]
    assert calls == [1]
    assert bool((new.params["xyz"] != state0.params["xyz"]).any())
