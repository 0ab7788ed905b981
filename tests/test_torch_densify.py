"""Port parity of densify and prune, the opacity reset, the moments'
surgery and the prior's upscale (gslidar_tpu_torch.models.{densify,optim,
raydrop_prior}) against gslidar_tpu on the CPU, on seeded numpy inputs.

``densify_and_prune``: the JAX package writes new gaussians into free
slots of a fixed capacity (enough here that none is dropped); the port
appends them. Rows are matched by (source row, copy index): the old rows
that stay keep their order, and JAX's k-th new gaussian, at its k-th free
slot (``jnp.argsort`` of its alive mask, as ``densify.py:124-126``
places it), is the port's k-th new row. JAX's split draws
(``jax.random.normal`` of the call's key) are handed to the port. Masks
and counts must be equal, values within rtol 1e-6 (atol 1e-7), and the
moments of new rows and every aux accumulator zero.
"""

import numpy as np
import pytest
import torch
from torch_scenes import (STEP_H, STEP_W, assert_step_matches, step_camera,
                          step_pcd, to_jax_state)

from gslidar_tpu_torch.models import densify as TD
from gslidar_tpu_torch.models import gaussians as TG
from gslidar_tpu_torch.models import optim as TO

torch.set_num_threads(2)

N, CAP = 300, 2048
EXTENT = 1.3
THRESH = dict(max_grad=2e-4, max_grad_t=2e-3, min_opacity=0.005)

# name -> (config, data) overrides of the mixed base case
CASES = {
    "clone_only": (dict(), dict(scale=(1e-3, 5e-3))),
    "split_no_time_split": (dict(), dict(scale=(0.1, 0.6))),
    "split_time_split": (dict(no_time_split=False), dict(scale=(0.1, 0.6))),
    "t_grad_no_time_split": (dict(t_grad=True), dict()),
    "t_grad_time_split": (dict(t_grad=True, no_time_split=False), dict()),
    "never_visible": (dict(), dict(radii=(0.0, 1.0))),
    "opacity_prune": (dict(), dict(low_opacity=0.5)),
    "world_size_on": (dict(size=True), dict(scale=(0.01, 3.0))),
    "world_size_off": (dict(), dict(scale=(0.01, 3.0))),
    "contract_off": (dict(contract=False, size=True), dict()),
    "prune_only": (dict(prune_only=True, size=True), dict()),
}


def _cfgs(t_grad=False, no_time_split=True, contract=True, **_):
    from gslidar_tpu.models import gaussians as JG
    kw = dict(sh_degree=1, t_grad=t_grad, no_time_split=no_time_split,
              contract=contract, random_init_point=0)
    return JG.GaussianConfig(**kw), TG.GaussianConfig(**kw)


def _state(seed, scale=(2e-3, 1.0), radii=(0.0, 5.0), low_opacity=0.1):
    """Numpy params, aux and moments of CAP slots, the first N alive: a mix
    of small and large gaussians, short and long in time, some never
    visible, some nearly transparent, some with large gradients."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def lu(lo, hi, shape):
        return np.exp(rng.uniform(np.log(lo), np.log(hi), shape)).astype(f32)
    opa = np.where(rng.random((CAP, 1)) < low_opacity,
                   rng.uniform(1e-3, 4e-3, (CAP, 1)),
                   rng.uniform(0.01, 0.9, (CAP, 1)))
    params = dict(
        xyz=(rng.normal(size=(CAP, 3)) * 5).astype(f32),
        f_dc=rng.normal(size=(CAP, 1, 4)).astype(f32),
        f_rest=rng.normal(size=(CAP, 3, 4)).astype(f32),
        opacity=np.log(opa / (1 - opa)).astype(f32),
        scaling=np.log(lu(*scale, (CAP, 3))),
        rotation=rng.normal(size=(CAP, 4)).astype(f32),
        t=rng.uniform(-0.5, 0.5, (CAP, 1)).astype(f32),
        scaling_t=np.log(lu(2e-3, 0.1, (CAP, 1))),
        velocity=rng.normal(size=(CAP, 3)).astype(f32),
        intensity=rng.normal(size=(CAP, 1)).astype(f32))
    alive = np.arange(CAP) < N
    denom = rng.integers(0, 5, CAP).astype(f32)
    aux = dict(
        alive=alive,
        max_radii2D=rng.uniform(*radii, CAP).astype(f32),
        xyz_gradient_accum=(denom * rng.uniform(0, 4e-4, CAP)).astype(f32),
        xyz_gradient_accum_abs=rng.uniform(0, 1, CAP).astype(f32),
        t_gradient_accum=(denom * rng.normal(0, 3e-3, CAP)).astype(f32),
        denom=denom)
    mu = {k: rng.normal(size=v.shape).astype(f32) for k, v in params.items()}
    nu = {k: rng.uniform(0, 1, v.shape).astype(f32)
          for k, v in params.items()}
    return params, aux, mu, nu


def _jax_masks(jparams, jaux, jcfg, prune_only):
    """JAX's selection (gslidar_tpu/models/densify.py:81-110), in jnp on the
    same arrays: (alive after the never-visible prune, clone, split,
    keep_scale, keep_scale_t)."""
    import jax.numpy as jnp
    from gslidar_tpu.models import gaussians as JG
    from gslidar_tpu.models.densify import RADII_PRUNE, _contract_scale_factor
    alive = jaux.alive & (jaux.max_radii2D >= RADII_PRUNE)
    d = jaux.denom
    g = jnp.where(d > 0, jaux.xyz_gradient_accum / d, 0.0)
    gt = jnp.where(d > 0, jaux.t_gradient_accum / d, 0.0)
    max_scale = jnp.max(JG.get_scaling(jparams), axis=-1)
    st = JG.get_scaling_t(jparams)[:, 0]
    pd = jcfg.percent_dense * EXTENT * _contract_scale_factor(
        jparams["xyz"], EXTENT, jcfg.contract)
    if prune_only:
        z = jnp.zeros_like(alive)
        return tuple(np.asarray(x) for x in (alive, z, z, z, z))
    clone = alive & (jnp.abs(g) >= THRESH["max_grad"]) & (max_scale <= pd)
    split = alive & (jnp.abs(g) >= THRESH["max_grad"]) & (max_scale > pd)
    if jcfg.t_grad:
        big_t = alive & (jnp.abs(gt) >= THRESH["max_grad_t"])
        clone |= big_t & (st <= jcfg.percent_dense)
        split |= big_t & (st > jcfg.percent_dense)
    return tuple(np.asarray(x) for x in (
        alive, clone, split, split & (max_scale < pd),
        split & (st < jcfg.percent_dense)))


def _run_case(name, seed=0):
    import jax
    import jax.numpy as jnp
    from gslidar_tpu.models import gaussians as JG
    from gslidar_tpu.models.densify import densify_and_prune as jax_densify
    from gslidar_tpu.models.optim import AdamState as JAdam
    cfg_kw, data_kw = CASES[name]
    jcfg, tcfg = _cfgs(**cfg_kw)
    prune_only, size = cfg_kw.get("prune_only", False), cfg_kw.get("size")
    params, aux, mu, nu = _state(seed, **data_kw)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jaux = JG.GaussianAux(**{k: jnp.asarray(v) for k, v in aux.items()})
    key = jax.random.PRNGKey(seed + 11)
    jout = jax_densify(
        jparams, jaux, JAdam({k: jnp.asarray(v) for k, v in mu.items()},
                             {k: jnp.asarray(v) for k, v in nu.items()},
                             jnp.asarray(7, jnp.int32)),
        key, jcfg, extent=EXTENT, size_threshold=20 if size else None,
        prune_only=prune_only, **THRESH)

    # JAX's emission: k-th new point -> (source, copy), at its k-th free slot
    masks = _jax_masks(jparams, jaux, jcfg, prune_only)
    alive0, clone, split = masks[:3]
    n_copies = 2 if jcfg.no_time_split else 3
    per = clone.astype(int) + split.astype(int) * n_copies
    total = int(per.sum())
    assert int(jout.n_new_requested) == int(jout.n_new_placed) == total
    dst = np.asarray(jnp.argsort(alive0))[:total]
    old = np.nonzero(alive0[:N] & ~split[:N])[0]
    order = np.concatenate([old, dst])
    k1, k2 = jax.random.split(key)
    z = np.array(jax.random.normal(k1, (CAP, 3)))[:total]
    z_t = np.array(jax.random.normal(k2, (CAP, 1)))[:total]

    keep = aux["alive"]
    tout = TD.densify_and_prune(
        TG.params_from_numpy(params, "cpu", keep),
        TG.GaussianAux(**{k: torch.as_tensor(v[keep])
                          for k, v in aux.items()}),
        TO.adam_from_numpy(mu, nu, 7, "cpu", keep), tcfg,
        extent=EXTENT, size_threshold=20 if size else None,
        prune_only=prune_only, z_xyz=torch.as_tensor(z),
        z_t=torch.as_tensor(z_t), **THRESH)
    tmasks = TD.selection(
        TG.params_from_numpy(params, "cpu", keep),
        TG.GaussianAux(**{k: torch.as_tensor(v[keep])
                          for k, v in aux.items()}), tcfg,
        max_grad=THRESH["max_grad"], max_grad_t=THRESH["max_grad_t"],
        extent=EXTENT, prune_only=prune_only)
    return dict(jout=jout, masks=masks, tmasks=[m.numpy() for m in tmasks],
                order=order, tout=tout, total=total, n_old=len(old))


def _close(a, b, what):
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_densify_and_prune_matches_jax(name):
    r = _run_case(name)
    jout, tout, order, counts = r["jout"], r["tout"], r["order"], \
        r["tout"].counts
    # the masks, on the alive rows
    for what, jm, tm in zip(("visible", "clone", "split", "keep_scale",
                             "keep_scale_t"), r["masks"], r["tmasks"]):
        np.testing.assert_array_equal(tm, jm[:N], err_msg=what)
    # the rows JAX keeps alive, in the port's order
    j_alive = np.asarray(jout.aux.alive)
    assert int(j_alive.sum()) == int(jout.n_alive) == counts["after"]
    assert not j_alive[np.setdiff1d(np.arange(CAP), order)].any()
    stay = j_alive[order]
    rows = order[stay]
    for k, v in tout.params.items():
        _close(v.numpy(), np.asarray(jout.params[k])[rows], k)
    for k in TG.PARAM_KEYS:
        _close(tout.opt_state.mu[k].numpy(),
               np.asarray(jout.opt_state.mu[k])[rows], f"mu {k}")
        _close(tout.opt_state.nu[k].numpy(),
               np.asarray(jout.opt_state.nu[k])[rows], f"nu {k}")
        new = np.arange(len(order))[stay] >= r["n_old"]
        assert not tout.opt_state.mu[k].numpy()[new].any()
    assert tout.opt_state.count == 7
    for f in ("max_radii2D", "xyz_gradient_accum", "xyz_gradient_accum_abs",
              "t_gradient_accum", "denom"):
        assert not getattr(tout.aux, f).any(), f
        assert not np.asarray(getattr(jout.aux, f)).any(), f
    assert bool(tout.aux.alive.all())
    # the counts add up, and each case does what it is named for
    assert counts["new"] == r["total"]
    assert counts["old_kept"] == int(stay[:r["n_old"]].sum())
    assert (counts["before"] - counts["never_visible"] - counts["splits"]
            + counts["new"] - counts["opacity_pruned"]
            - counts["world_size_pruned"]) == counts["after"]
    vis, clone, split, keep_scale, keep_scale_t = r["tmasks"]
    want = {
        "clone_only": clone.any() and not split.any(),
        "split_no_time_split": split.any() and not clone.any(),
        "split_time_split": split.any() and not clone.any(),
        "t_grad_no_time_split": (clone & split).any() and keep_scale.any()
        and keep_scale_t.any(),
        "t_grad_time_split": (clone & split).any() and keep_scale.any()
        and keep_scale_t.any(),
        "never_visible": counts["never_visible"] > N // 2,
        "opacity_prune": counts["opacity_pruned"] > N // 10,
        "world_size_on": counts["world_size_pruned"] > 0,
        "world_size_off": counts["world_size_pruned"] == 0,
        "contract_off": clone.any() and split.any(),
        "prune_only": counts["new"] == 0 and counts["after"] < N,
    }[name]
    assert want, (name, counts)


def test_train_step_after_densify_matches_jax():
    """The port densifies (clones, splits, prunes; draws from its
    generator); gslidar_tpu's step then runs on the port's rows in the
    port's order (``state_to_numpy``), so both bin the same rows with the
    same tie order, and one step of each agrees at
    tests/test_torch_train.py's bars."""
    import jax
    from gslidar_tpu.config import Config
    from gslidar_tpu.engine import train as JT
    from gslidar_tpu.models import gaussians as JG
    from gslidar_tpu.models.raydrop_prior import init_raydrop_prior
    from gslidar_tpu_torch.engine import train as TT
    rng = np.random.default_rng(6)
    pts, colors = step_pcd(rng)
    params, aux = JG.create_from_pcd(pts, colors, None,
                                     JG.GaussianConfig(random_init_point=0),
                                     capacity=2048)
    ts = TT.state_from_numpy(jax.tree.map(np.asarray, JT.init_train_state(
        params, aux, init_raydrop_prior(STEP_H, STEP_W))), "cpu")
    n = ts.params["xyz"].shape[0]
    denom = torch.as_tensor(rng.integers(0, 4, n).astype(np.float32))
    ts = ts._replace(aux=TG.GaussianAux(
        alive=ts.aux.alive,
        max_radii2D=torch.as_tensor(rng.uniform(0, 5, n).astype(np.float32)),
        xyz_gradient_accum=denom * torch.as_tensor(
            rng.uniform(0, 4e-4, n).astype(np.float32)),
        xyz_gradient_accum_abs=torch.zeros(n), t_gradient_accum=torch.zeros(n),
        denom=denom))
    args = Config(dict(densify_grad_threshold=2e-4,
                       densify_grad_t_threshold=2e-3, thresh_opa_prune=0.005))
    densify = TT.make_densify_fn(args, TG.GaussianConfig(
        random_init_point=0, no_time_split=False))
    ts, counts = densify(ts, torch.Generator().manual_seed(0), 3.0, 20)
    assert counts["clones"] > 0 and counts["splits"] > 0, counts
    assert counts["never_visible"] > 0 and counts["after"] > n, counts
    assert_step_matches(to_jax_state(TT.state_to_numpy(ts)), ts,
                        step_camera(rng))


def test_densify_draws_from_the_generator():
    """Without injected offsets the split draws come from the generator:
    the same seed gives the same rows, another seed other split rows."""
    from gslidar_tpu_torch.engine.train import init_train_state
    params, aux, _, _ = _state(1)
    keep = aux["alive"]
    _, tcfg = _cfgs(no_time_split=False)

    def run(seed):
        p = TG.params_from_numpy(params, "cpu", keep)
        a = TG.GaussianAux(**{k: torch.as_tensor(v[keep])
                              for k, v in aux.items()})
        s = init_train_state(p, a, torch.zeros(1, 2, 4))
        g = torch.Generator().manual_seed(seed)
        return TD.densify_and_prune(s.params, s.aux, s.opt, tcfg,
                                    extent=EXTENT, size_threshold=None,
                                    generator=g, **THRESH)
    a, b, c = run(0), run(0), run(1)
    assert a.counts == b.counts and a.counts["new"] > 0
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    assert not torch.equal(a.params["xyz"], c.params["xyz"])


def test_reset_opacity_matches_jax():
    import jax.numpy as jnp
    from gslidar_tpu.models import gaussians as JG
    from gslidar_tpu.models.densify import reset_opacity as jax_reset
    from gslidar_tpu.models.optim import AdamState as JAdam
    params, aux, mu, nu = _state(2)
    jp, jopt = jax_reset({k: jnp.asarray(v) for k, v in params.items()},
                         JAdam({k: jnp.asarray(v) for k, v in mu.items()},
                               {k: jnp.asarray(v) for k, v in nu.items()},
                               jnp.asarray(3, jnp.int32)),
                         JG.GaussianConfig())
    tp, topt = TD.reset_opacity(TG.params_from_numpy(params, "cpu"),
                                TO.adam_from_numpy(mu, nu, 3, "cpu"),
                                TG.GaussianConfig())
    # clamped rows take inverse_sigmoid(0.05) bit for bit; the others
    # inverse_sigmoid(sigmoid(x)), where XLA's CPU log and logistic are not
    # always correctly rounded: within one float32 ulp there
    clamped = np.asarray(JG.get_opacity(
        {"opacity": jnp.asarray(params["opacity"])})) >= 0.05
    assert 0 < clamped.sum() < clamped.size
    jo, to = np.asarray(jp["opacity"]), tp["opacity"].numpy()
    np.testing.assert_array_equal(to[clamped], jo[clamped])
    assert np.all(np.abs(to - jo) <= np.spacing(np.abs(jo)))
    for k in TG.PARAM_KEYS:
        if k != "opacity":
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]),
                                          k)
        np.testing.assert_array_equal(topt.mu[k].numpy(),
                                      np.asarray(jopt.mu[k]), k)
        np.testing.assert_array_equal(topt.nu[k].numpy(),
                                      np.asarray(jopt.nu[k]), k)
    assert not topt.mu["opacity"].any() and topt.count == 3


def test_zero_moments_at_matches_jax():
    import jax.numpy as jnp
    from gslidar_tpu.models.optim import AdamState as JAdam
    from gslidar_tpu.models.optim import zero_moments_at as jax_zero
    params, _, mu, nu = _state(3)
    mask = np.random.default_rng(3).random(CAP) < 0.3
    j = jax_zero(JAdam({k: jnp.asarray(v) for k, v in mu.items()},
                       {k: jnp.asarray(v) for k, v in nu.items()},
                       jnp.asarray(5, jnp.int32)), jnp.asarray(mask))
    t = TO.zero_moments_at(TO.adam_from_numpy(mu, nu, 5, "cpu"),
                           torch.as_tensor(mask))
    for k in TG.PARAM_KEYS:
        np.testing.assert_array_equal(t.mu[k].numpy(), np.asarray(j.mu[k]))
        np.testing.assert_array_equal(t.nu[k].numpy(), np.asarray(j.nu[k]))
    # the exact-size surgery: cut rows, append zero ones
    rows = torch.as_tensor(np.nonzero(~mask)[0])
    c = TO.cut_and_append_moments(t, rows, 7)
    for k in TG.PARAM_KEYS:
        assert c.mu[k].shape[0] == len(rows) + 7
        np.testing.assert_array_equal(c.nu[k][:len(rows)].numpy(),
                                      nu[k][~mask])
        assert not c.mu[k][len(rows):].any()
    assert c.count == 5


@pytest.mark.parametrize("src_hw,dst_hw", [((8, 16), (16, 32)),
                                           ((33, 257), (66, 515)),
                                           ((5, 7), (5, 7))])
def test_raydrop_prior_upscale_matches_jax(src_hw, dst_hw):
    import jax.numpy as jnp
    from gslidar_tpu.models.raydrop_prior import raydrop_prior_upscale as jup
    from gslidar_tpu_torch.models.raydrop_prior import raydrop_prior_upscale
    h, w = src_hw
    p = np.random.default_rng(4).normal(size=(1, h, 2 * w)).astype(
        np.float32)
    j = np.asarray(jup(jnp.asarray(p), *dst_hw))
    t = raydrop_prior_upscale(torch.as_tensor(p), *dst_hw).numpy()
    assert t.shape == j.shape == (1, dst_hw[0], 2 * dst_hw[1])
    assert t.dtype == np.float32
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
    if src_hw == dst_hw:
        np.testing.assert_array_equal(t, p)


def test_depth_visualization_matches_jax(tmp_path):
    """visualize_depth, make_image_grid and save_image without matplotlib
    and PIL, against the JAX package's, which use them: within 1/255."""
    from PIL import Image
    from gslidar_tpu.utils import general as JU
    from gslidar_tpu_torch.utils import general as TU
    rng = np.random.default_rng(5)
    d = rng.uniform(0, 80, (1, 16, 64)).astype(np.float32)
    d[0, 0, :5] = 0.0
    imgs = []
    for kw in (dict(), dict(scale_factor=0.5), dict(linear=True),
               dict(near=0, far=0)):
        t, j = TU.visualize_depth(d, **kw), JU.visualize_depth(d, **kw)
        assert t.shape == (3, 16, 64) and t.dtype == np.float32
        np.testing.assert_allclose(t, j, rtol=0, atol=1 / 255, err_msg=kw)
        imgs.append(t)
    grid = TU.make_image_grid(imgs, nrow=2)
    np.testing.assert_array_equal(grid, JU.make_image_grid(imgs, nrow=2))
    TU.save_image(grid, tmp_path / "port.png")
    JU.save_image(grid, tmp_path / "jax.png")
    a = np.asarray(Image.open(tmp_path / "port.png"))
    b = np.asarray(Image.open(tmp_path / "jax.png"))
    assert a.shape == b.shape == (grid.shape[1], grid.shape[2], 3)
    assert np.abs(a.astype(int) - b).max() <= 1
