"""Port parity for the ray-drop refinement: gslidar_tpu_torch's U-Net
(models/unet.py) and refine module (engine/refine.py) against
gslidar_tpu's flax U-Net and refine.py, on seeded numpy inputs.

* the U-Net's eval-mode forward, flax-initialised weights (and perturbed
  BatchNorm statistics) carried across, at sizes whose downsampling
  floors make non-2x upsampling steps (33 -> 16 -> 33 rows, 65 -> 32 ->
  65 and 129 -> 64 -> 129 columns): 1e-5 absolute;
* the bilinear upsampling at kitti360_nvs_1908's steps (4 -> 8, 16 ->
  33, 128 -> 257, 257 -> 515) against ``jax.image.resize``: 4e-6 on
  values of unit scale (the float32 weights' last bits);
* flax's BatchNorm update (momentum 0.99, biased variance) at the
  bottleneck's B x 4 x 64 values per channel: 1e-5 relative, a bar that
  ``torch.nn.BatchNorm2d``'s defaults and its unbiased update miss;
* two refine steps in train mode, in float64 (the test says why), with
  dropout inactive on both sides (the JAX modules are subclassed inside
  the test with rate 0) and the same numpy box masks: the loss (1e-5
  relative), the gradients (1e-4 of each tensor's largest), the
  BatchNorm running statistics (1e-5 relative to each tensor's largest)
  and the params after Adam (1e-9);
* the one-cycle learning rate over 1000 steps;
* ``refine.npz`` both ways: the JAX package's ``refine`` writes and the
  port's ``_load_unet`` reads, the port's ``refine`` writes and the JAX
  package's ``_load_unet`` reads, each giving its writer's outputs
  (1e-5 absolute).
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _flax_unet(shape, seed=0, perturb=True):
    """(flax UNet module, params, batch_stats) initialised by flax at
    ``shape``; with ``perturb``, BatchNorm scales, biases and statistics
    drawn from ``seed`` so that eval mode normalizes with real numbers."""
    import jax
    import jax.numpy as jnp
    from gslidar_tpu.models.unet import UNet
    m = UNet()
    key = jax.random.PRNGKey(seed)
    v = jax.jit(lambda k, x: m.init({"params": k, "dropout": k}, x,
                                    train=True))(
        key, jnp.zeros((1,) + tuple(shape[1:]), jnp.float32))
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    if perturb:
        rng = np.random.default_rng(seed + 1)

        def bn(tree, name, lo, hi):
            return {k: (bn(t, name, lo, hi) if isinstance(t, dict) else
                        (t + rng.uniform(lo, hi, t.shape).astype(np.float32)
                         if k == name else t)) for k, t in tree.items()}
        params = bn(bn(params, "scale", -0.3, 0.3), "bias", -0.2, 0.2)
        stats = bn(bn(stats, "mean", -0.2, 0.2), "var", 0.1, 0.6)
    return m, params, stats


def _jit_apply(m, params, stats, x):
    """The flax U-Net's eval-mode forward, jitted (eager flax runs op by
    op, compiling each, which costs far more on the CPU)."""
    import jax
    return jax.jit(lambda p, s, x: m.apply({"params": p, "batch_stats": s},
                                           x, train=False))(params, stats, x)


def _jit_flax_init(monkeypatch):
    """The JAX package's ``UNet.init``, jitted, for the package's own
    ``refine`` and ``_load_unet`` in these tests: the same variables,
    without eager flax's per-op compiles."""
    import jax
    import gslidar_tpu.models.unet as JU
    init = JU.UNet.init

    def jitted(self, rngs, x, train=True):
        return jax.jit(lambda r, x: init(self, r, x, train=train))(rngs, x)
    monkeypatch.setattr(JU.UNet, "init", jitted)


@pytest.mark.parametrize("shape", [(2, 3, 66, 130), (1, 3, 34, 258)])
def test_unet_eval_forward_matches_flax(shape):
    from gslidar_tpu_torch.models.unet import unet_from_flax
    m, params, stats = _flax_unet(shape)
    x = np.random.default_rng(3).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(_jit_apply(m, params, stats, x))
    model = unet_from_flax(params, stats).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (shape[0], 1) + shape[2:]
    assert 1e-3 < want.std()          # the output is not constant
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("src,dst", [((4, 64), (8, 128)),
                                     ((16, 128), (33, 257)),
                                     ((33, 257), (66, 515))])
def test_bilinear_upsampling_matches_jax(src, dst):
    import jax
    import jax.numpy as jnp
    import torch.nn.functional as F
    x = np.random.default_rng(4).normal(size=(2, 3) + src).astype(np.float32)
    want = np.asarray(jax.image.resize(
        jnp.asarray(x.transpose(0, 2, 3, 1)), (2,) + dst + (3,),
        "bilinear")).transpose(0, 3, 1, 2)
    got = F.interpolate(torch.from_numpy(x), size=dst, mode="bilinear",
                        align_corners=False).numpy()
    # the same sample points and taps; the float32 weights differ in the
    # last bits (JAX normalizes its kernel's weights, torch takes 1 - f)
    np.testing.assert_allclose(got, want, atol=4e-6, rtol=0)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def test_batchnorm_update_matches_flax():
    """The running statistics after one train-mode pass at the bottleneck's
    size: the port's BatchNorm matches flax's at 1e-5 relative, and the
    bar is tight enough that torch's BatchNorm2d misses it both with its
    default momentum and with flax's (its running variance is unbiased)."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    from gslidar_tpu_torch.models.unet import BatchNorm
    x = np.random.default_rng(5).normal(0.4, 1.3, (2, 256, 4, 64)) \
        .astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    v = bn.init(jax.random.PRNGKey(0), xj)
    v = {"params": v["params"], "batch_stats": {
        "mean": jnp.full(256, 0.3), "var": jnp.full(256, 2.0)}}
    yj, upd = bn.apply(v, xj, mutable=["batch_stats"])
    want_mean = np.asarray(upd["batch_stats"]["mean"])
    want_var = np.asarray(upd["batch_stats"]["var"])

    def run(mod):
        with torch.no_grad():
            mod.running_mean.fill_(0.3)
            mod.running_var.fill_(2.0)
            y = mod.train()(torch.from_numpy(x))
        return y.numpy(), mod.running_mean.numpy(), mod.running_var.numpy()

    y, mean, var = run(BatchNorm(256))
    assert _rel(mean, want_mean) <= 1e-5 and _rel(var, want_var) <= 1e-5
    np.testing.assert_allclose(y, np.asarray(yj).transpose(0, 3, 1, 2),
                               atol=1e-5, rtol=0)
    for mod in (torch.nn.BatchNorm2d(256),
                torch.nn.BatchNorm2d(256, momentum=0.01)):
        _, mean_t, var_t = run(mod)
        assert max(_rel(mean_t, want_mean), _rel(var_t, want_var)) > 1e-5


def _no_dropout_jax(monkeypatch):
    """The JAX U-Net with dropout at rate 0: its DoubleConv and AttnBlock
    subclassed with rate 0 under the same names (so the param tree keeps
    its keys), the module's globals patched for this test only."""
    import gslidar_tpu.models.unet as JU

    class DoubleConv(JU.DoubleConv):
        dropout: float = 0.0

    class AttnBlock(JU.AttnBlock):
        dropout: float = 0.0
    monkeypatch.setattr(JU, "DoubleConv", DoubleConv)
    monkeypatch.setattr(JU, "AttnBlock", AttnBlock)


def _jax_box_mask(rng, shape):
    """The JAX package's box masking, as gslidar_tpu/engine/refine.py:
    75-84 draws it."""
    mask = np.ones(shape, np.float32)
    by = max(int(0.1 * shape[2]), 2)
    bx = max(int(0.1 * shape[3]), 2)
    for _ in range(rng.integers(32)):
        sy = rng.integers(1, by)
        sx = rng.integers(1, bx)
        yi = rng.integers(shape[2] - sy)
        xi = rng.integers(shape[3] - sx)
        mask[:, :, yi:yi + sy, xi:xi + sx] = 0.0
    return mask


def test_box_masks_match_jax():
    from gslidar_tpu_torch.engine.refine import box_mask
    a, b = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(20):
        want = _jax_box_mask(a, (2, 3, 66, 1030))
        got = box_mask(b, 66, 1030)
        np.testing.assert_array_equal(np.broadcast_to(got, want.shape), want)


def test_refine_steps_match_jax(monkeypatch):
    """Two epochs of refine's step, as gslidar_tpu/engine/refine.py:62-77
    builds it (full-batch, clipped BCE, optax adam on the one-cycle lr),
    against the port's ``refine_step`` from the same weights, in float64
    on both sides. In float32 the two agree on the loss (1e-5) but their
    gradients carry ~1e-2 relative rounding noise at this initialisation,
    each package its own: every train-mode BatchNorm's backward subtracts
    near-equal terms, layer after layer. In float64 they agree to ~1e-12,
    so these bars hold with room. The in-conv's bias only feeds
    BatchNorms, so its gradient is 0 up to rounding: both sides must give
    less than 1e-12 there."""
    import jax
    import jax.numpy as jnp
    import optax
    from gslidar_tpu.engine.refine import _onecycle_lr
    from gslidar_tpu_torch.engine import refine as TR
    from gslidar_tpu_torch.models.unet import (_flatten, _to_flax, flax_tree,
                                               unet_from_flax, unet_leaves)
    _no_dropout_jax(monkeypatch)
    shape, epochs = (3, 3, 34, 130), 1000
    m, params, stats = _flax_unet(shape, perturb=False)
    params, stats = (jax.tree.map(lambda a: a.astype(np.float64), t)
                     for t in (params, stats))
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, shape)
    y = (rng.uniform(0, 1, (shape[0], 1) + shape[2:]) < 0.3).astype(
        np.float64)

    tx = optax.adam(learning_rate=lambda i: _onecycle_lr(i, epochs))

    def loss_fn(p, bs, mask):
        out, upd = m.apply({"params": p, "batch_stats": bs},
                           jnp.asarray(x) * mask, train=True,
                           mutable=["batch_stats"],
                           rngs={"dropout": jax.random.PRNGKey(0)})
        o = jnp.clip(out, 1e-7, 1 - 1e-7)
        y_ = jnp.asarray(y)
        return (-jnp.mean(y_ * jnp.log(o) + (1 - y_) * jnp.log(1 - o)),
                upd["batch_stats"])

    @jax.jit
    def step(params, stats, opt_state, mask):
        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, stats, mask)
        upd, opt_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, upd), stats, opt_state, loss,
                grads)

    model = unet_from_flax(params, stats).double().train()
    for mod in model.modules():
        if hasattr(mod, "dropout"):
            mod.dropout = 0.0
    opt = TR.adam(model)
    rj, rt = np.random.default_rng(0), np.random.default_rng(0)
    with jax.enable_x64(True):
        opt_state = tx.init(params)
        for i in range(2):
            params, stats, opt_state, loss_j, grads = step(
                params, stats, opt_state,
                jnp.asarray(_jax_box_mask(rj, shape), jnp.float64))
            loss_t = TR.refine_step(
                model, opt, torch.from_numpy(x), torch.from_numpy(y),
                torch.from_numpy(TR.box_mask(rt, *shape[2:])).double(),
                TR._onecycle_lr(i, epochs), None)

            assert abs(float(loss_t.detach()) - float(loss_j)) \
                <= 1e-5 * float(loss_j)
            slots = _flatten(flax_tree(model)[0])
            for (t, kind), g in zip(slots, jax.tree.leaves(grads)):
                g, got = np.asarray(g), _to_flax(t.grad, kind)
                scale = np.abs(g).max()
                if scale < 1e-12:
                    assert np.abs(got).max() < 1e-12, i
                else:
                    assert np.abs(got - g).max() <= 1e-4 * scale, i
            leaves = unet_leaves(model)
            n_p = len(slots)
            for a, b in zip(leaves[n_p:], jax.tree.leaves(stats)):
                assert _rel(a, b) <= 1e-5, i
            for a, b in zip(leaves[:n_p], jax.tree.leaves(params)):
                np.testing.assert_allclose(a, np.asarray(b), atol=1e-9,
                                           rtol=0)


def test_onecycle_lr_matches_jax():
    """The schedule at all 1000 steps. Both evaluate it in float32; JAX's
    CPU cos is the C library's cosf, which is not correctly rounded at a
    few of these arguments, where the port's (the float64 cos rounded to
    float32) is; near the end 1 + cos(x) cancels and one ulp of cos turns
    into up to 2.3e-7 relative of the rate. Elsewhere they are equal bit
    for bit."""
    from gslidar_tpu.engine.refine import _onecycle_lr as jlr
    from gslidar_tpu_torch.engine.refine import _onecycle_lr as tlr
    want = np.array([float(jlr(i, 1000)) for i in range(1000)])
    got = np.array([tlr(i, 1000) for i in range(1000)])
    rel = np.abs(got - want) / want
    assert rel.max() <= 2.5e-7
    assert (got == want).mean() >= 0.99
    assert got[0] == pytest.approx(4e-5) and got.max() == pytest.approx(1e-3)


def _ray_drop_dataset(root, hw=(16, 64), n=2, seed=7):
    """A ray_drop_datasets/ tree of ``n`` train renders and their GT."""
    rng = np.random.default_rng(seed)
    h, w2 = hw[0], 2 * hw[1]
    for sub in ("gt", "render_train", "render_test"):
        os.makedirs(os.path.join(root, "ray_drop_datasets", sub))
    os.makedirs(os.path.join(root, "ckpt"))
    for i in range(n):
        depth = rng.uniform(0.2, 6.0, (1, h, w2)).astype(np.float32)
        drop = (rng.uniform(0, 1, (1, h, w2)) < 0.25)
        gt = np.concatenate([drop.astype(np.float64),
                             rng.uniform(0, 1, (1, h, w2)),
                             np.where(drop, 0, depth)])
        render = np.concatenate([rng.uniform(0, 1, (1, h, w2)),
                                 rng.uniform(0, 1, (1, h, w2)),
                                 depth]).astype(np.float32)
        for sub, arr in (("gt", gt), ("render_train", render)):
            np.save(os.path.join(root, "ray_drop_datasets", sub,
                                 f"{i:03d}.npy"), arr)
    return np.stack([np.load(os.path.join(
        root, "ray_drop_datasets", "render_train", f"{i:03d}.npy"))
        for i in range(n)])


def test_refine_npz_read_both_ways(tmp_path, monkeypatch):
    from gslidar_tpu.config import Config
    from gslidar_tpu.engine import refine as JR
    from gslidar_tpu_torch.engine import refine as TR
    xs = {}
    for side in ("jax", "torch"):
        xs[side] = _ray_drop_dataset(str(tmp_path / side))
    args = {side: Config({"model_path": str(tmp_path / side),
                          "refine_epochs": 2}) for side in xs}
    _jit_flax_init(monkeypatch)

    # the JAX package writes, the port reads
    params, stats = JR.refine(args["jax"])
    model_j = JR._load_unet(args["jax"])[0]
    want = np.asarray(_jit_apply(model_j, params, stats, xs["jax"]))
    with torch.no_grad():
        got = TR._load_unet(args["jax"], "cpu")(
            torch.from_numpy(xs["jax"])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    # the port writes, the JAX package reads
    model, printed = TR.refine(args["torch"], "cpu")
    assert [i for i, _ in printed] == [0] and np.isfinite(printed[0][1])
    with torch.no_grad():
        want = model.eval()(torch.from_numpy(xs["torch"])).numpy()
    m, p, s = JR._load_unet(args["torch"])
    got = np.asarray(_jit_apply(m, p, s, xs["torch"]))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
