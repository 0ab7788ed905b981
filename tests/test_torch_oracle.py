"""The port's dense oracle (``gslidar_tpu_torch/raster/oracle.py``) as a
gradient reference, on the scenes and settings of tests/test_raster.py
(P = 48 gaussians on 48x96, two extra features; the 3-gaussian float64
scene of its finite-difference test):

* the oracle's gradients for means, scales, quats, opacity and SH against
  ``jax.grad`` of gslidar_tpu's ``rasterize_dense``, within 1e-4 of each
  tensor's largest magnitude (both walk the same gaussians in the same
  order with the same float32 arithmetic; what is left is rounding);
* the port's tiled ``rasterize`` (its plain compositors here on the CPU)
  against the oracle, at test_raster.py's bar of 5e-3 of each tensor's
  largest magnitude;
* the oracle's float64 gradient against central finite differences of
  its own loss, at test_raster.py's rtol 2e-3 and atol 1e-4 (the port's
  compositors take float32 only, so the tiled-vs-dense float64 check of
  test_raster.py has no counterpart: the finite differences are held on
  the oracle alone);
* the S features carry no gradient into alpha: changing only the feature
  values leaves the opacity gradient of a feature loss where it was, and
  the normals do carry one.
"""

import numpy as np
import pytest
import torch

from tests.test_raster import BG, HFOV, VFOV, make_scene

torch.set_num_threads(2)

H, W, S = 48, 96, 2
NAMES = ("means", "scales", "quats", "opac", "shs")


def _settings():
    from gslidar_tpu_torch.raster.settings import RasterSettings
    return RasterSettings(height=H, width=W, vfov=VFOV, hfov=HFOV,
                          num_extra_features=S)


def _target(rng):
    return rng.uniform(1, 30, (H, W)).astype(np.float32)


def _loss(out, target, dense):
    """test_raster.py::test_gradients_match_oracle's loss."""
    get = (lambda k: out[k]) if dense else (lambda k: getattr(out, k))
    depth = get("depth")
    return ((depth[0] - target).abs().mean() + (get("color") ** 2).mean()
            + 0.1 * get("alpha").mean() + 0.01 * depth[2].mean())


def _torch_grads(scene, target, dense):
    from gslidar_tpu_torch.raster.oracle import rasterize_dense
    from gslidar_tpu_torch.raster.rasterize import rasterize
    means, scales, quats, opac, shs, feats = (torch.tensor(x) for x in scene)
    params = [t.requires_grad_() for t in (means, scales, quats, opac, shs)]
    fn = rasterize_dense if dense else rasterize
    out = fn(*params, feats, torch.ones(len(means), dtype=torch.bool),
             torch.eye(4), torch.zeros(3), torch.tensor(np.asarray(BG)), 3,
             1.0, settings=_settings())
    return [g.numpy() for g in torch.autograd.grad(
        _loss(out, torch.tensor(target), dense), params)]


def _jax_dense_grads(scene, target):
    import jax
    import jax.numpy as jnp
    from gslidar_tpu.raster import RasterSettings
    from gslidar_tpu.raster.oracle import rasterize_dense
    st = RasterSettings(height=H, width=W, vfov=VFOV, hfov=HFOV,
                        num_extra_features=S, pair_cap=1 << 13,
                        tile_chunk=16, tile_list_cap=256)
    means, scales, quats, opac, shs, feats = map(jnp.asarray, scene)
    tgt = jnp.asarray(target)

    def loss(params):
        out = rasterize_dense(*params, feats, jnp.ones(len(means), bool),
                              jnp.eye(4), jnp.zeros(3), BG, 3, 1.0,
                              settings=st)
        return (jnp.mean(jnp.abs(out["depth"][0] - tgt))
                + jnp.mean(out["color"] ** 2)
                + 0.1 * jnp.mean(out["alpha"])
                + 0.01 * jnp.mean(out["depth"][2]))
    grads = jax.jit(jax.grad(loss))((means, scales, quats, opac, shs))
    return [np.asarray(g) for g in grads]


def _assert_rel(got, want, bar, what):
    for a, b, name in zip(got, want, NAMES):
        denom = max(float(np.abs(b).max()), 1e-8)
        err = float(np.abs(a - b).max()) / denom
        assert np.isfinite(a).all() and err <= bar, \
            f"{what} {name}: {err:.3g} of the largest, bar {bar}"


@pytest.fixture(scope="module")
def scene_grads():
    rng = np.random.default_rng(2023)
    scene = make_scene(rng, P=48)
    target = _target(rng)
    return scene, target, _torch_grads(scene, target, dense=True)


def test_dense_gradients_match_jax(scene_grads):
    scene, target, dense = scene_grads
    want = _jax_dense_grads(scene, target)
    _assert_rel(dense, want, 1e-4, "port oracle vs jax.grad of the oracle")
    # the scene has gradient everywhere worth comparing
    assert all(np.abs(g).max() > 0 for g in want)


def test_tiled_gradients_match_dense_oracle(scene_grads):
    scene, target, dense = scene_grads
    tiled = _torch_grads(scene, target, dense=False)
    _assert_rel(tiled, dense, 5e-3, "tiled vs dense")


def _fd_scene():
    """test_raster.py::test_finite_difference_gradient's scene."""
    from gslidar_tpu_torch.raster.settings import RasterSettings
    f64 = torch.float64
    st = RasterSettings(height=16, width=32, vfov=VFOV, hfov=HFOV,
                        num_extra_features=0)
    means = torch.tensor([[0.0, -0.5, 8.0], [1.0, 0.5, 10.0],
                          [-1.0, 0.0, 12.0]], dtype=f64)
    rest = dict(
        scales=torch.full((3, 3), 1.2, dtype=f64),
        quats=torch.tensor(np.random.default_rng(0).normal(size=(3, 4))),
        opac=torch.tensor([0.7, 0.6, 0.8], dtype=f64),
        shs=torch.tensor(0.3 * np.random.default_rng(1).normal(
            size=(3, 16, 4))),
        feats=torch.zeros(3, 0, dtype=f64))
    return st, means, rest


def test_dense_finite_difference_float64():
    from gslidar_tpu_torch.raster.oracle import rasterize_dense
    st, means, r = _fd_scene()
    bg = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float64)

    def loss(m):
        out = rasterize_dense(m, r["scales"], r["quats"], r["opac"],
                              r["shs"], r["feats"],
                              torch.ones(3, dtype=torch.bool),
                              torch.eye(4, dtype=torch.float64),
                              torch.zeros(3, dtype=torch.float64), bg, 3,
                              1.0, settings=st)
        assert out["color"].dtype == torch.float64
        return ((out["color"] ** 2).sum() + (out["depth"][0] ** 2).sum()
                * 1e-3 + out["depth"][2].sum())

    m = means.clone().requires_grad_()
    gd = torch.autograd.grad(loss(m), m)[0].numpy()
    assert np.abs(gd).max() > 0
    eps = 1e-5
    for i in range(3):
        for j in range(3):
            dm = torch.zeros(3, 3, dtype=torch.float64)
            dm[i, j] = eps
            fd = (float(loss(means + dm)) - float(loss(means - dm))) \
                / (2 * eps)
            assert np.isclose(gd[i, j], fd, rtol=2e-3, atol=1e-4), \
                f"grad[{i},{j}]={gd[i, j]} vs fd={fd}"


def test_features_carry_no_gradient_into_alpha():
    """A loss on the feature channels: its opacity gradient comes through
    the normals alone, so perturbing only the feature values leaves it as
    it was, while the feature values' own gradient follows the weights."""
    from gslidar_tpu_torch.raster.oracle import rasterize_dense
    rng = np.random.default_rng(5)
    means, scales, quats, opac, shs, feats = (
        torch.tensor(x) for x in make_scene(rng, P=24))

    def grads(f):
        o = opac.clone().requires_grad_()
        f = f.clone().requires_grad_()
        out = rasterize_dense(means, scales, quats, o, shs, f,
                              torch.ones(24, dtype=torch.bool), torch.eye(4),
                              torch.zeros(3), torch.tensor(np.asarray(BG)),
                              3, 1.0, settings=_settings())
        feat = out["feature"]
        loss = (feat[:S] ** 2).sum() + feat[S:].sum()
        return [g.numpy() for g in torch.autograd.grad(loss, (o, f))]

    g_opa, g_f = grads(feats)
    g_opa2, g_f2 = grads(feats + torch.tensor(
        rng.normal(size=feats.shape).astype(np.float32)))
    np.testing.assert_array_equal(g_opa2, g_opa)
    assert np.abs(g_opa).max() > 0           # the normals' share
    assert not np.array_equal(g_f2, g_f)     # the features' own gradient
