"""Port parity of checkpoints, in both directions, which pins the
TrainState leaf order:

* gslidar_tpu's save_checkpoint -> the port's load_checkpoint (params,
  alive mask, ray-drop prior: what serving reads) and load_train_state
  (every leaf, cut to the alive rows), from which one port step matches
  one JAX step at tests/test_torch_train.py's bars;
* the port's save_checkpoint -> gslidar_tpu's load_checkpoint, every leaf
  bit for bit.
"""

import numpy as np
import pytest
import torch
from torch_scenes import (STEP_H, STEP_W, assert_step_matches, step_camera,
                          step_pcd, to_jax_state)


def _state(rng, cap=256, n=200, h=6, w=10):
    import jax
    import jax.numpy as jnp
    from gslidar_tpu.engine.train import init_train_state
    from gslidar_tpu.models import gaussians as G
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 5
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    params, aux = G.create_from_pcd(pts, cols, None,
                                    G.GaussianConfig(random_init_point=0),
                                    capacity=cap)
    # distinct values in every leaf, so a swapped index cannot pass
    params = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
              for k, v in params.items()}
    prior = jnp.asarray(rng.normal(size=(1, h, 2 * w)).astype(np.float32))
    state = init_train_state(params, aux, prior)
    mu = jax.tree.map(lambda x: x + 1.0, state.opt.mu)
    return state._replace(opt=state.opt._replace(mu=mu))


def test_checkpoint_round_trip(tmp_path):
    from gslidar_tpu.engine.checkpoint import save_checkpoint
    from gslidar_tpu_torch.engine.checkpoint import load_checkpoint
    state = _state(np.random.default_rng(0))
    path = str(tmp_path / "chkpnt7000.npz")
    save_checkpoint(path, state, 7000)
    params, alive, prior, it = load_checkpoint(path, "cpu")
    assert it == 7000
    assert sorted(params) == sorted(state.params)
    for k, v in state.params.items():
        assert params[k].dtype == torch.float32
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(v),
                                      err_msg=k)
    np.testing.assert_array_equal(alive.numpy(), np.asarray(state.aux.alive))
    assert alive.dtype == torch.bool and 0 < int(alive.sum()) < alive.numel()
    np.testing.assert_array_equal(prior.numpy(), np.asarray(state.prior))


def test_checkpoint_rejects_other_layouts(tmp_path):
    from gslidar_tpu_torch.engine.checkpoint import load_checkpoint
    path = str(tmp_path / "other.npz")
    np.savez(path, leaf_0=np.zeros(3), iteration=np.asarray(1))
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(path, "cpu")


def _trained_jax_state(rng, cap=4096, n=2048):
    """A gslidar_tpu TrainState of step_pcd's gaussians whose alive slots
    are spread among dead ones, with nonzero moments, aux, step counts and
    prior moments."""
    import jax
    import jax.numpy as jnp
    from gslidar_tpu.engine.train import init_train_state
    from gslidar_tpu.models import gaussians as G
    from gslidar_tpu.models.raydrop_prior import init_raydrop_prior
    pts, colors = step_pcd(rng, n)
    params, aux = G.create_from_pcd(pts, colors, None,
                                    G.GaussianConfig(random_init_point=0),
                                    capacity=cap)
    state = init_train_state(params, aux, init_raydrop_prior(STEP_H, STEP_W))
    perm = rng.permutation(cap)
    dead = ~np.asarray(aux.alive)[perm]

    def spread(x):
        x = np.asarray(x)
        return jnp.asarray(x[perm]) if x.ndim and x.shape[0] == cap else x

    def noisy(x, lo, hi):
        x = np.array(x)
        return jnp.asarray(np.where(
            dead.reshape((-1,) + (1,) * (x.ndim - 1)), 0.0,
            rng.uniform(lo, hi, x.shape)).astype(np.float32))
    state = jax.tree.map(spread, state)
    opt = state.opt._replace(
        mu={k: noisy(v, -1e-3, 1e-3) for k, v in state.opt.mu.items()},
        nu={k: noisy(v, 0, 1e-6) for k, v in state.opt.nu.items()},
        count=jnp.asarray(5, jnp.int32))
    aux = state.aux.replace(
        max_radii2D=noisy(state.aux.max_radii2D, 0, 5),
        xyz_gradient_accum=noisy(state.aux.xyz_gradient_accum, 0, 1),
        denom=noisy(state.aux.denom, 0, 3))
    pm, pv, _ = state.prior_opt
    prior_opt = (jnp.asarray(rng.uniform(-1e-3, 1e-3, pm.shape), jnp.float32),
                 jnp.asarray(rng.uniform(0, 1e-6, pv.shape), jnp.float32),
                 jnp.asarray(5, jnp.int32))
    assert 0 < n < cap and dead[:n].any()
    return state._replace(opt=opt, aux=aux, prior_opt=prior_opt)


def test_resume_from_a_jax_checkpoint_matches_a_jax_step(tmp_path):
    import jax
    from gslidar_tpu.engine.checkpoint import save_checkpoint
    from gslidar_tpu_torch.engine.checkpoint import load_train_state
    from gslidar_tpu_torch.models.gaussians import PARAM_KEYS
    rng = np.random.default_rng(1)
    state = _trained_jax_state(rng)
    path = str(tmp_path / "chkpnt900.npz")
    save_checkpoint(path, state, 900)
    ts, it = load_train_state(path, "cpu")
    assert it == 900
    j = jax.tree.map(np.asarray, state)
    keep = j.aux.alive
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(ts.params[k].numpy(), j.params[k][keep])
        np.testing.assert_array_equal(ts.opt.mu[k].numpy(), j.opt.mu[k][keep])
        np.testing.assert_array_equal(ts.opt.nu[k].numpy(), j.opt.nu[k][keep])
    for f in ("alive", "max_radii2D", "xyz_gradient_accum",
              "xyz_gradient_accum_abs", "t_gradient_accum", "denom"):
        np.testing.assert_array_equal(getattr(ts.aux, f).numpy(),
                                      getattr(j.aux, f)[keep], err_msg=f)
    assert ts.opt.count == 5 and ts.prior_opt[2] == 5
    np.testing.assert_array_equal(ts.prior.numpy(), j.prior)
    for a, b in zip(ts.prior_opt[:2], j.prior_opt[:2]):
        np.testing.assert_array_equal(a.numpy(), b)
    assert_step_matches(state, ts, step_camera(rng))


def test_jax_reads_the_ports_checkpoint(tmp_path):
    import jax
    from gslidar_tpu.engine.checkpoint import load_checkpoint as jax_load
    from gslidar_tpu_torch.engine.checkpoint import (latest_checkpoint,
                                                     save_checkpoint)
    from gslidar_tpu_torch.engine.train import (state_from_numpy,
                                                state_to_numpy)
    rng = np.random.default_rng(2)
    j = jax.tree.map(np.asarray, _trained_jax_state(rng, 1024, 500))
    ts = state_from_numpy(j, "cpu")
    (tmp_path / "ckpt").mkdir()
    path = str(tmp_path / "ckpt" / "chkpnt700.npz")
    save_checkpoint(path, ts, 700)
    assert latest_checkpoint(str(tmp_path), [300, 700, 900]) == path
    n = ts.params["xyz"].shape[0]
    s = state_to_numpy(ts)
    template = to_jax_state(s)
    loaded, it = jax_load(path, template)
    assert it == 700
    want = [np.asarray(x) for x in jax.tree.leaves(template)]
    got = jax.tree.leaves(loaded)
    assert len(got) == len(want) == 41
    for a, b in zip(got, want):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the layout gslidar_tpu's TrainState has: alive rows only, int32 counts
    assert s.aux.alive.all() and s.aux.alive.shape == (n,)
    assert s.opt.count.dtype == np.int32 and int(s.opt.count) == 5
    keep = j.aux.alive
    np.testing.assert_array_equal(np.asarray(loaded.opt.nu["xyz"]),
                                  j.opt.nu["xyz"][keep])
    np.testing.assert_array_equal(np.asarray(loaded.aux.denom),
                                  j.aux.denom[keep])
