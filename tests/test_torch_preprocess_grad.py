"""The preprocess pass's backward: the port's written-out plain backward
(``preprocess_backward_reference``, ``eval_sh_backward``) against JAX's
autodiff of gslidar_tpu's preprocess and SH, against torch autograd
through the plain forward, and ``PreprocessFn`` (the public
``preprocess``) inside ``rasterize`` against autograd through the plain
forward.

Bars:
* against ``jax.vjp`` in float32: rtol 1e-4 / atol 1e-5. The two sum
  the same terms in another order (JAX's splat frame is a matmul, its SH
  an einsum) and the gradient runs through 1 / |q| and 1 / |means -
  campos|, so float32 rounding of a few ulps, amplified there, is what
  separates them;
* against torch autograd through ``preprocess_reference`` in float64:
  rtol 1e-10 / atol 1e-12, the same formulas differentiated by hand and
  by autograd, which differ only by float64 rounding;
* ``rasterize`` through the Function against ``rasterize`` through the
  plain forward's autograd on the CPU (the forward is the same plain
  code, so the renders are equal): each gradient within 1e-5 of its
  largest magnitude, float32 rounding of the two backwards.
"""

import numpy as np
import pytest
import torch

from torch_scenes import settings_pair, splat_scene, to_jax, to_torch

torch.set_num_threads(2)

GRAD_KEYS = ("means", "scales", "quats", "shs")


def _prep_launches():
    """The preprocess kernels' launches so far: [forward, backward]."""
    from gslidar_tpu_torch.utils.trace import counters
    c = counters()
    return [c.get("launches.preprocess_fwd", 0),
            c.get("launches.preprocess_bwd", 0)]


def _scene(wrap, seed=21, P=384):
    sc = splat_scene(np.random.default_rng(seed + wrap), P=P, wrap=wrap)
    js, ts = settings_pair(wrap=wrap,
                           hfov=(-180.0, 180.0) if wrap else (-60.0, 60.0))
    return sc, js, ts


def _cotangents(P, C, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(P, 3, 3)).astype(np.float32),
            rng.normal(size=(P, C)).astype(np.float32))


def _plain_backward(t, ts, sh_degree, colors, dT, dcolor):
    """The port's plain backward at the scene's inputs, with the clamp
    mask of its plain forward."""
    from gslidar_tpu_torch.raster.preprocess import (
        _preprocess_plain, preprocess_backward_reference)
    shs = None if colors is not None else t["shs"]
    _, clamped = _preprocess_plain(
        t["means"], t["scales"], t["quats"], t["opac"], shs, t["mask"],
        t["viewmat"], t["campos"], sh_degree, 1.0, ts,
        colors_precomp=colors)
    return preprocess_backward_reference(
        t["means"], t["scales"], t["quats"], shs, t["viewmat"], t["campos"],
        sh_degree, clamped, dT, dcolor)


@pytest.mark.parametrize("variant", ["sh0", "sh3", "colors"])
@pytest.mark.parametrize("tight", [True, False])
@pytest.mark.parametrize("wrap", [False, True])
def test_backward_reference_matches_jax_vjp(wrap, tight, variant):
    import dataclasses
    import jax
    import jax.numpy as jnp
    from gslidar_tpu.raster.preprocess import preprocess as jprep
    sc, js, ts = _scene(wrap)
    js = dataclasses.replace(js, tight_rects=tight)
    ts = dataclasses.replace(ts, tight_rects=tight)
    deg = 0 if variant == "sh0" else 3
    P = sc["means"].shape[0]
    colors = (np.random.default_rng(3).uniform(0, 1, (P, 4))
              .astype(np.float32) if variant == "colors" else None)
    dT, dc = _cotangents(P, 4, 7 + wrap)
    j = to_jax(sc)

    def f(means, scales, quats, shs):
        out = jprep(means, scales, quats, j["opac"],
                    None if colors is not None else shs, j["mask"],
                    j["viewmat"], j["campos"], deg, 1.0, js,
                    colors_precomp=None if colors is None
                    else jnp.asarray(colors))
        return out.T, out.color

    _, vjp = jax.vjp(f, j["means"], j["scales"], j["quats"], j["shs"])
    want = vjp((jnp.asarray(dT), jnp.asarray(dc)))
    t = to_torch(sc)
    got = _plain_backward(t, ts, deg, None if colors is None
                          else torch.as_tensor(colors),
                          torch.as_tensor(dT), torch.as_tensor(dc))
    assert float(np.abs(np.asarray(want[0])).max()) > 0
    for name, a, b in zip(GRAD_KEYS, want, got):
        if name == "shs" and colors is not None:
            assert b is None
            continue
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("variant", ["sh1", "sh3", "colors"])
@pytest.mark.parametrize("wrap", [False, True])
def test_backward_reference_matches_autograd_float64(wrap, variant):
    from gslidar_tpu_torch.raster.preprocess import preprocess_reference
    sc, _, ts = _scene(wrap, seed=31)
    deg = 1 if variant == "sh1" else 3
    t = {k: (v.double() if v.dtype == torch.float32 else v)
         for k, v in to_torch(sc).items()}
    P = t["means"].shape[0]
    colors = (torch.as_tensor(np.random.default_rng(4).uniform(
        0, 1, (P, 4))) if variant == "colors" else None)
    leaves = [t[k].clone().requires_grad_(True) for k in GRAD_KEYS]
    out = preprocess_reference(leaves[0], leaves[1], leaves[2], t["opac"],
                               leaves[3], t["mask"], t["viewmat"],
                               t["campos"], deg, 1.0, ts,
                               colors_precomp=colors)
    dT, dc = (torch.as_tensor(x).double() for x in _cotangents(P, 4, 9))
    outs = [out.T] if colors is not None else [out.T, out.color]
    want = torch.autograd.grad(outs, leaves, [dT, dc][:len(outs)],
                               allow_unused=True)
    got = _plain_backward(t, ts, deg, colors, dT, dc)
    for name, a, b in zip(GRAD_KEYS, want, got):
        if name == "shs" and colors is not None:
            assert a is None and b is None
            continue
        assert a.dtype == b.dtype == torch.float64
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-10,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_backward_matches_jax_vjp(degree):
    """Clamped entries included: with coefficients of scale 0.6 about a
    third of the values fall below 0, where both give no gradient."""
    import jax
    import jax.numpy as jnp
    from gslidar_tpu.ops.sh import eval_sh as jsh
    from gslidar_tpu_torch.ops.sh import eval_sh, eval_sh_backward
    rng = np.random.default_rng(40 + degree)
    d = rng.normal(size=(600, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    coeffs = (rng.normal(size=(600, 16, 4)) * 0.6).astype(np.float32)
    dc = rng.normal(size=(600, 4)).astype(np.float32)
    _, vjp = jax.vjp(lambda c, x: jsh(degree, c, x)[0], jnp.asarray(coeffs),
                     jnp.asarray(d))
    want = vjp(jnp.asarray(dc))
    tc, td = torch.as_tensor(coeffs), torch.as_tensor(d)
    _, clamped = eval_sh(degree, tc, td)
    if degree:
        assert 0 < int(clamped.sum()) < clamped.numel()
    got = eval_sh_backward(degree, tc, td, clamped, torch.as_tensor(dc))
    for name, a, b in zip(("coeffs", "dirs"), want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    assert not got[0][:, (degree + 1) ** 2:].any()


@pytest.mark.parametrize("colors", [False, True])
@pytest.mark.parametrize("wrap", [False, True])
def test_rasterize_grads_through_function(wrap, colors, monkeypatch):
    """The gradients of every rasterize input, and the T tap's, through
    the Function (plain forward, written-out backward) against autograd
    through the plain forward."""
    import gslidar_tpu_torch.raster.rasterize as rz
    from gslidar_tpu_torch.raster.preprocess import (preprocess,
                                                     preprocess_reference)
    sc, _, ts = _scene(wrap, seed=51, P=256)
    t = to_torch(sc)
    P = t["means"].shape[0]
    bg = torch.tensor([0.0, 0.0, 0.0, 1.0])
    rng = np.random.default_rng(52)
    cts = [torch.as_tensor(rng.normal(size=s).astype(np.float32)) for s in
           ((4, ts.height, ts.width), (5, ts.height, ts.width),
            (4, ts.height, ts.width), (1, ts.height, ts.width))]
    col = torch.as_tensor(rng.uniform(0, 1, (P, 4)).astype(np.float32))

    def grads(prep_fn):
        monkeypatch.setattr(rz, "preprocess", prep_fn)
        leaves = {k: t[k].clone().requires_grad_(True)
                  for k in ("means", "scales", "quats", "opac", "shs",
                            "feats")}
        cp = col.clone().requires_grad_(True) if colors else None
        tap = torch.zeros(P, 3, 3, requires_grad=True)
        out = rz.rasterize(leaves["means"], leaves["scales"],
                           leaves["quats"], leaves["opac"],
                           None if colors else leaves["shs"],
                           leaves["feats"], t["mask"], t["viewmat"],
                           t["campos"], bg, 3, 1.0, ts, colors_precomp=cp,
                           T_tap=tap)
        loss = sum((o * c).sum() for o, c in zip(
            (out.color, out.feature, out.depth, out.final_T), cts))
        keys = [k for k in leaves if not (colors and k == "shs")]
        wrt = [leaves[k] for k in keys] + [tap] + ([cp] if colors else [])
        g = torch.autograd.grad(loss, wrt)
        return dict(zip(keys + ["T_tap"] + (["colors"] if colors else []),
                        g)), out

    want, out_p = grads(preprocess_reference)
    before = _prep_launches()
    got, out_f = grads(preprocess)
    assert _prep_launches() == before
    assert out_f.num_pairs == out_p.num_pairs > 0
    assert torch.equal(out_f.color, out_p.color)
    assert torch.equal(out_f.radii, out_p.radii)
    for k, a in want.items():
        b = got[k]
        scale = float(a.abs().max())
        assert scale > 0 or k == "opac", k
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=1e-5 * max(scale, 1e-30),
                                   err_msg=k)


def test_function_outputs_and_refusals():
    """Only T and color carry a gradient; the public preprocess refuses
    float64 (``preprocess_reference`` takes it) and devices other than
    the CPU and a card."""
    from gslidar_tpu_torch.raster.preprocess import (preprocess,
                                                     preprocess_reference)
    sc, _, ts = _scene(False, seed=61, P=64)
    t = to_torch(sc)
    means = t["means"].clone().requires_grad_(True)
    shs = t["shs"].clone().requires_grad_(True)
    args = (t["scales"], t["quats"], t["opac"])
    rest = (t["mask"], t["viewmat"], t["campos"], 3, 1.0, ts)
    out = preprocess(means, *args, shs, *rest)
    assert out.T.grad_fn is not None and out.color.grad_fn is not None
    for f in ("xy", "depth", "normal", "radius", "rect_min", "rect_max",
              "tiles_touched", "valid"):
        x = getattr(out, f)
        assert x.grad_fn is None and not x.requires_grad, f
    ref = preprocess_reference(means, *args, shs, *rest)
    for f in out._fields:
        assert torch.equal(getattr(out, f).detach(),
                           getattr(ref, f).detach()), f
    d = {k: v.double() if v.dtype == torch.float32 else v
         for k, v in t.items()}
    with pytest.raises(TypeError, match="float32"):
        preprocess(d["means"], d["scales"], d["quats"], d["opac"], d["shs"],
                   d["mask"], d["viewmat"], d["campos"], 3, 1.0, ts)
    m = {k: v.to("meta") for k, v in t.items()}
    with pytest.raises(ValueError, match="cpu or cuda"):
        preprocess(m["means"], m["scales"], m["quats"], m["opac"], m["shs"],
                   m["mask"], m["viewmat"], m["campos"], 3, 1.0, ts)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_device):
    """On the card: the forward kernel against the plain forward on every
    field (floats within 1e-6 of the field's largest magnitude, the
    integer fields equal on >= 99.9 % of the gaussians) and the backward
    kernel against the plain backward within 1e-5 of each column's
    largest, one launch of each counted."""
    from gslidar_tpu_torch.raster import preprocess as pp
    sc, _, ts = _scene(True, seed=71, P=4096)
    t = {k: v.to(cuda_device) for k, v in to_torch(sc).items()}
    args = (t["means"], t["scales"], t["quats"], t["opac"], t["shs"],
            t["mask"], t["viewmat"], t["campos"], 3, 1.0, ts)
    leaves = [t[k].clone().requires_grad_(True) for k in GRAD_KEYS]
    before = _prep_launches()
    out = pp.preprocess(leaves[0], leaves[1], leaves[2], t["opac"],
                        leaves[3], *args[5:])
    plain, _ = pp._preprocess_plain(*args)
    for f in out._fields:
        a, b = getattr(out, f).detach(), getattr(plain, f)
        if a.dtype.is_floating_point:
            assert float((a - b).abs().max()) <= \
                1e-6 * float(b.abs().max()), f
        else:
            assert int((a != b).reshape(len(a), -1).any(1).sum()) <= \
                len(a) // 1000, f
    dT, dc = (torch.as_tensor(x, device=cuda_device)
              for x in _cotangents(4096, 4, 72))
    got = torch.autograd.grad([out.T, out.color], leaves, [dT, dc])
    assert _prep_launches() == [before[0] + 1, before[1] + 1]
    # the kernel's clamp mask: its colors that the clamp set to 0
    want = pp.preprocess_backward_reference(
        t["means"], t["scales"], t["quats"], t["shs"], t["viewmat"],
        t["campos"], 3, out.color.detach() == 0, dT, dc)
    for name, a, b in zip(GRAD_KEYS, got, want):
        scale = b.abs().amax(0).clamp_min(1e-30)
        assert float(((a - b).abs().amax(0) / scale).max()) <= 1e-5, name
