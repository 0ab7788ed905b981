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
    assert out.payload is None and ref.payload is None
    for f in out._fields[:-1]:
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
    assert out.payload is None and plain.payload is None
    for f in out._fields[:-1]:
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


# ------------------------------------------------- the direct payload path
def _plain_kernel(means3D, scales, quats, opacity, shs, colors_precomp,
                  features, mask, viewmat, campos, opts):
    """``_preprocess_kernel``'s contract in plain torch: the plain
    forward's fields and, given the features, the payload rows written
    through ``payload_views``, where the kernel writes them."""
    from gslidar_tpu_torch.raster import preprocess as pp
    out, clamped = pp._preprocess_plain(
        means3D, scales, quats, opacity, shs, mask, viewmat, campos,
        opts.sh_degree, opts.scale_factor, opts.settings,
        opts.scale_modifier, colors_precomp, opts.angle_bounds,
        opts.cull_bounds)
    if features is None:
        return out, clamped
    P, C = out.color.shape
    payload = torch.empty(P, 10 + C + features.shape[1])
    T, color = pp.payload_views(payload, C)
    T.copy_(out.T)
    color.copy_(out.color)
    payload[:, 9] = opacity
    payload[:, 10 + C:] = features
    return out._replace(T=T, color=color, payload=payload), clamped


@pytest.fixture
def card_standins(monkeypatch):
    """The card's path on the CPU: ``PreprocessFn`` takes the kernels'
    route, and plain stand-ins keep the kernels' contracts; returns the
    strides of the cotangents the backward was given, one entry a call."""
    from gslidar_tpu_torch.raster import preprocess as pp
    seen = []

    def backward(means3D, scales, quats, shs, viewmat, campos, clamped, dT,
                 dcolor, opts):
        seen.append((dT.stride(), None if shs is None else dcolor.stride()))
        return pp.preprocess_backward_reference(
            means3D, scales, quats, shs, viewmat, campos, opts.sh_degree,
            clamped, dT, dcolor, opts.scale_modifier)
    monkeypatch.setattr(pp, "_on_card", lambda x: True)
    monkeypatch.setattr(pp, "_preprocess_kernel", _plain_kernel)
    monkeypatch.setattr(pp, "_preprocess_backward_kernel", backward)
    return seen


def _payload_counts():
    from gslidar_tpu_torch.utils.trace import counters
    c = counters()
    return [c.get("payload.direct", 0), c.get("payload.packed", 0)]


@pytest.mark.parametrize("variant,P", [("sh0", 300), ("sh3", 300),
                                       ("colors", 300), ("sh3", 0)])
def test_direct_payload_matches_pack_payload(variant, P, card_standins):
    """Given the features, ``preprocess`` returns the payload rows, and
    ``T`` and ``color`` as views of them: ``pack_payload``'s rows of the
    parent path (``get_features``'s one [P, K, C] tensor, its separate
    outputs, the eager pack) bit for bit, the other fields equal. The
    gradients of every input through the payload equal the parent path's
    bit for bit, the backward reading T's and the colour's cotangents in
    place in the payload's gradient rows."""
    from gslidar_tpu_torch.models import gaussians as G
    from gslidar_tpu_torch.raster import preprocess as pp
    from gslidar_tpu_torch.raster.composite_fwd import pack_payload
    sc, _, ts = _scene(True, seed=81, P=max(P, 1))
    t = {k: v[:P] if k not in ("viewmat", "campos") else v
         for k, v in to_torch(sc).items()}
    deg = 0 if variant == "sh0" else 3
    rng = np.random.default_rng(82)
    col = (torch.as_tensor(rng.uniform(0, 1, (P, 4)).astype(np.float32))
           if variant == "colors" else None)
    D = 10 + 4 + t["feats"].shape[1]
    gpay = torch.as_tensor(rng.normal(size=(P, D)).astype(np.float32))

    def run(direct):
        L = {k: t[k].clone().requires_grad_(True)
             for k in ("means", "scales", "quats", "opac", "feats")}
        L["f_dc"] = t["shs"][:, :1].clone().requires_grad_(True)
        L["f_rest"] = t["shs"][:, 1:].clone().requires_grad_(True)
        if col is not None:
            L["colors"] = col.clone().requires_grad_(True)
        shs = (L["f_dc"], L["f_rest"]) if direct else G.get_features(L)
        before = _payload_counts()
        prep = pp.preprocess(L["means"], L["scales"], L["quats"], L["opac"],
                             shs, t["mask"], t["viewmat"], t["campos"], deg,
                             1.0, ts, colors_precomp=L.get("colors"),
                             features=L["feats"] if direct else None)
        rows = (prep.payload if direct
                else pack_payload(prep, L["opac"], L["feats"]))
        counts = [a - b for a, b in zip(_payload_counts(), before)]
        keys = [k for k in L if not (col is not None and k.startswith("f_"))]
        grads = torch.autograd.grad((rows * gpay).sum(), [L[k] for k in keys],
                                    allow_unused=True)
        return prep, rows, counts, dict(zip(keys, grads))

    prep_d, rows_d, counts_d, grads_d = run(True)
    prep_p, rows_p, counts_p, grads_p = run(False)
    assert counts_d == [1, 0] and counts_p == [0, 1]
    assert rows_d.shape == (P, D) and torch.equal(rows_d, rows_p)
    assert prep_d.T._base is rows_d and prep_d.color._base is rows_d
    for f in prep_p._fields[:-1]:
        assert torch.equal(getattr(prep_d, f).detach(),
                           getattr(prep_p, f).detach()), f
    for k, a in grads_p.items():
        b = grads_d[k]
        assert b is not None and torch.equal(b, a), k
    assert len(card_standins) == 2          # the direct run's, the parent's
    if P:
        # the backward read the payload's gradient rows where they lie
        assert card_standins[0] == ((D, 1, 3),
                                    None if col is not None else (D, 1))
        assert float(grads_d["means"].abs().max()) > 0


def test_payload_counters_on_the_cpu_and_under_a_tap(card_standins,
                                                     monkeypatch):
    """``payload.direct`` counts a render whose rows the kernel wrote and
    ``payload.packed`` one packed eagerly: on the card's route 1 and 0 a
    render, under a T tap 0 and 1 (the tap needs T as an operand of its
    own), and on the CPU's own route 0 and 1."""
    import gslidar_tpu_torch.raster.rasterize as rz
    from gslidar_tpu_torch.raster import preprocess as pp
    sc, _, ts = _scene(False, seed=91, P=200)
    t = to_torch(sc)
    P = t["means"].shape[0]
    bg = torch.tensor([0.0, 0.0, 0.0, 1.0])
    shs = (t["shs"][:, :1], t["shs"][:, 1:])

    def render(tap=None):
        before = _payload_counts()
        out = rz.rasterize(t["means"], t["scales"], t["quats"], t["opac"],
                           shs, t["feats"], t["mask"], t["viewmat"],
                           t["campos"], bg, 3, 1.0, ts, T_tap=tap)
        return out, [a - b for a, b in zip(_payload_counts(), before)]

    direct, counts = render()
    assert counts == [1, 0]
    tapped, counts = render(torch.zeros(P, 3, 3, requires_grad=True))
    assert counts == [0, 1]
    monkeypatch.setattr(pp, "_on_card", lambda x: x.device.type == "cuda")
    plain, counts = render()
    assert counts == [0, 1]
    assert direct.num_pairs == plain.num_pairs > 0
    for a, b in ((direct, plain), (tapped, plain)):
        assert torch.equal(a.color, b.color)
        assert torch.equal(a.feature, b.feature)
