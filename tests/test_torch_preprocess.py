"""Port parity: gslidar_tpu_torch.raster.preprocess vs gslidar_tpu's.

Same seeded numpy scene through both packages, field by field: float
fields at rtol 1e-5 / atol 1e-5, the integer tile rects, tile counts and
the valid mask exactly.

On the card (``-m cuda``): the preprocess kernels' payload layout bit for
bit against the parent layout (separate outputs, then ``pack_payload``;
cotangents copied contiguous), with the SH as two blocks and as two views
of one tensor.
"""

import numpy as np
import pytest
import torch

from torch_scenes import settings_pair, splat_scene, to_jax, to_torch

torch.set_num_threads(2)


def _both(sc, js, ts, sh_degree=3):
    from gslidar_tpu.raster.preprocess import preprocess as jprep
    from gslidar_tpu_torch.raster.preprocess import preprocess as tprep
    j, t = to_jax(sc), to_torch(sc)
    jp = jprep(j["means"], j["scales"], j["quats"], j["opac"], j["shs"],
               j["mask"], j["viewmat"], j["campos"], sh_degree, 1.0, js)
    tp = tprep(t["means"], t["scales"], t["quats"], t["opac"], t["shs"],
               t["mask"], t["viewmat"], t["campos"], sh_degree, 1.0, ts)
    return jp, tp


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("tight", [True, False])
def test_preprocess_matches_jax(wrap, tight):
    rng = np.random.default_rng(11 + wrap)
    sc = splat_scene(rng, P=768, wrap=wrap)
    js, ts = settings_pair(wrap=wrap, tight_rects=tight,
                           hfov=(-180.0, 180.0) if wrap else (-60.0, 60.0))
    jp, tp = _both(sc, js, ts)
    assert int(np.asarray(jp.tiles_touched).sum()) > 0
    for name in jp._fields:
        a = np.asarray(getattr(jp, name))
        b = getattr(tp, name).numpy()
        assert a.shape == b.shape, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
    from gslidar_tpu.raster.preprocess import center_projection as jcp
    from gslidar_tpu_torch.raster.preprocess import center_projection as tcp
    for a, b in zip(jcp(jp.T, js.angle_bounds, js),
                    tcp(tp.T, ts.angle_bounds, ts)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)


def test_preprocess_sh_degree_and_cull():
    """A lower active SH degree masks the higher bands, and splats behind
    the near plane or outside the 1.3x window are culled, in both."""
    rng = np.random.default_rng(5)
    sc = splat_scene(rng, P=512)
    sc["means"][:64] *= 0.02                      # inside the near plane
    sc["means"][64:128, 0] *= -40.0               # far outside the hfov
    js, ts = settings_pair()
    jp, tp = _both(sc, js, ts, sh_degree=1)
    np.testing.assert_allclose(tp.color.numpy(), np.asarray(jp.color),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    assert not tp.valid[:64].any()


def test_mark_visible_matches_jax():
    from gslidar_tpu.raster.preprocess import mark_visible as jmv
    from gslidar_tpu_torch.raster.preprocess import mark_visible as tmv
    rng = np.random.default_rng(9)
    sc = splat_scene(rng, P=1024, wrap=True)
    js, ts = settings_pair()
    j, t = to_jax(sc), to_torch(sc)
    a = np.asarray(jmv(j["means"], j["viewmat"], 1.0, js))
    b = tmv(t["means"], t["viewmat"], 1.0, ts).numpy()
    np.testing.assert_array_equal(b, a)
    assert 0 < b.sum() < b.size


def test_wrap_col_rect_matches_jax():
    """Spans across the seam, near a full revolution and past it, with a
    partial last tile column (W != tiles_x * tile_w)."""
    import jax.numpy as jnp
    from gslidar_tpu.raster.preprocess import wrap_col_rect as jw
    from gslidar_tpu_torch.raster.preprocess import wrap_col_rect as tw_
    rng = np.random.default_rng(2)
    W, tw, gx = 130.0, 16, 9
    cx = rng.uniform(-20, 150, 2048).astype(np.float32)
    lo = rng.uniform(0, 140, 2048).astype(np.float32)
    hi = rng.uniform(0, 140, 2048).astype(np.float32)
    a0, a1 = jw(jnp.asarray(cx), jnp.asarray(lo), jnp.asarray(hi), W, tw, gx)
    b0, b1 = tw_(torch.as_tensor(cx), torch.as_tensor(lo),
                 torch.as_tensor(hi), W, tw, gx)
    np.testing.assert_array_equal(b0.numpy(), np.asarray(a0))
    np.testing.assert_array_equal(b1.numpy(), np.asarray(a1))


def test_sh_matches_jax():
    import jax.numpy as jnp
    from gslidar_tpu.ops.sh import eval_sh as jsh, sh_basis as jb
    from gslidar_tpu_torch.ops.sh import eval_sh as tsh, sh_basis as tb
    rng = np.random.default_rng(4)
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    coeffs = rng.normal(size=(500, 16, 4)).astype(np.float32)
    np.testing.assert_allclose(tb(torch.as_tensor(d)).numpy(),
                               np.asarray(jb(jnp.asarray(d))), rtol=1e-5,
                               atol=1e-6)
    for deg in range(4):
        a, ac = jsh(deg, jnp.asarray(coeffs), jnp.asarray(d))
        b, bc = tsh(deg, torch.as_tensor(coeffs), torch.as_tensor(d))
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(bc.numpy(), np.asarray(ac))


# ------------------------------------------------------------- on the card
CARD_P = 5000 + 37         # not a multiple of the kernels' 128-thread block


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _card_scene(device, seed=101):
    """A seeded 360-degree scene with S = 4 on the card, the port's
    settings (no JAX on the card's machine) and the SH in both forms."""
    from gslidar_tpu_torch.raster.settings import RasterSettings
    sc = splat_scene(np.random.default_rng(seed), P=CARD_P, S=4, wrap=True)
    t = {k: v.to(device) for k, v in to_torch(sc).items()}
    ts = RasterSettings(height=32, width=256, vfov=(-20.0, 20.0),
                        hfov=(-180.0, 180.0), num_extra_features=4,
                        wrap_x=True)
    forms = {"two blocks": (t["shs"][:, :1].contiguous(),
                            t["shs"][:, 1:].contiguous()),
             "one tensor": t["shs"]}
    return t, ts, forms


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["two blocks", "one tensor"])
def test_card_payload_rows_bitwise(card, form):
    """The forward kernel given the features writes ``pack_payload``'s
    rows of its separate outputs bit for bit, ``T`` and ``color`` are
    those views, and every other field is the separate call's."""
    from gslidar_tpu_torch.raster import preprocess as pp
    from gslidar_tpu_torch.raster.composite_fwd import pack_payload
    t, ts, forms = _card_scene(card)
    args = (t["mask"], t["viewmat"], t["campos"], 3, 1.0, ts)
    head = (t["means"], t["scales"], t["quats"], t["opac"])
    with torch.no_grad():
        sep = pp.preprocess(*head, t["shs"], *args)
        got = pp.preprocess(*head, forms[form], *args, features=t["feats"])
        want = pack_payload(sep, t["opac"], t["feats"])
    assert sep.payload is None and got.payload is not None
    assert got.payload.shape == (CARD_P, 18)
    assert torch.equal(got.payload, want)
    for f in sep._fields[:-1]:
        assert torch.equal(getattr(got, f), getattr(sep, f)), f
    assert int(sep.valid.sum()) > CARD_P // 2


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["two blocks", "one tensor"])
def test_card_backward_reads_the_payload_gradient_in_place(card, form):
    """The backward kernel given T's and the colour's cotangents as views
    of [P, 18] gradient rows returns d means, d scales, d quats and d SH
    (as two contiguous blocks when the SH came so) equal bit for bit to
    its result on their contiguous copies."""
    from gslidar_tpu_torch.raster import preprocess as pp
    t, ts, forms = _card_scene(card)
    opts = pp._Options(3, 1.0, ts, 1.0, None, None)
    sh = forms[form]
    with torch.no_grad():
        _, clamped = pp._preprocess_kernel(
            t["means"], t["scales"], t["quats"], t["opac"], sh, None, None,
            t["mask"], t["viewmat"], t["campos"], opts)
        g = torch.Generator(device=card).manual_seed(102)
        gpay = torch.randn(CARD_P, 18, generator=g, device=card)
        dT, dc = pp.payload_views(gpay, 4)
        assert not dT.is_contiguous() and not dc.is_contiguous()
        head = (t["means"], t["scales"], t["quats"], sh, t["viewmat"],
                t["campos"], clamped)
        a = pp._preprocess_backward_kernel(*head, dT, dc, opts)
        b = pp._preprocess_backward_kernel(*head, dT.contiguous(),
                                           dc.contiguous(), opts)
    for name, x, y in zip(("means", "scales", "quats"), a, b):
        assert torch.equal(x, y), name
    if isinstance(sh, tuple):
        assert all(x.is_contiguous() for x in a[3])
        assert [x.shape for x in a[3]] == [x.shape for x in sh]
    assert torch.equal(pp.sh_rows(a[3]), pp.sh_rows(b[3]))
    assert float(a[0].abs().max()) > 0


@pytest.mark.cuda
def test_card_render_counts_the_payload_path(card):
    """A render on the card counts ``payload.direct`` 1 and
    ``payload.packed`` 0, one with a T tap 0 and 1; the two renders'
    planes are equal."""
    from gslidar_tpu_torch.raster.rasterize import rasterize
    from gslidar_tpu_torch.utils.trace import counters
    t, ts, forms = _card_scene(card)
    bg = torch.tensor([0.0, 0.0, 0.0, 1.0], device=card)

    def render(tap=None):
        c0 = counters()
        out = rasterize(t["means"], t["scales"], t["quats"], t["opac"],
                        forms["two blocks"], t["feats"], t["mask"],
                        t["viewmat"], t["campos"], bg, 3, 1.0, ts,
                        T_tap=tap)
        c1 = counters()
        return out, [c1.get(k, 0) - c0.get(k, 0)
                     for k in ("payload.direct", "payload.packed")]
    direct, n = render()
    assert n == [1, 0]
    tapped, n = render(torch.zeros(CARD_P, 3, 3, device=card,
                                   requires_grad=True))
    assert n == [0, 1]
    assert direct.num_pairs == tapped.num_pairs > 0
    assert torch.equal(direct.depth, tapped.depth)
    assert torch.equal(direct.color, tapped.color)
