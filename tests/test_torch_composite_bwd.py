"""Port parity of the backward compositor and the differentiable
rasterizer (gslidar_tpu_torch.raster.composite_bwd, composite_op and
rasterize) on the CPU, where the wrappers run the plain versions.

* ``composite_backward_reference`` against autograd through
  ``composite_forward_reference`` on the same rows: the same walk, so the
  sharpest oracle. Bar: per gradient column, max error <= 1e-4 of the
  column's largest magnitude. The plain forward blends the S features with
  live weights, so autograd would also send their cotangent into alpha,
  which the semantics exclude: the full comparison runs with a zero S
  cotangent and the S columns are checked separately.
* ``rasterize`` gradients (means, scales, quats, opacity, SH, features and
  the T tap) against jax.grad through gslidar_tpu's
  ``rasterize(backend="xla")``. The XLA scan decays T to the end of each
  tile's list while the port stops walking at the block vote, so the final
  T path differs by up to the 1e-4 floor. Bar: per parameter, max error
  <= 5e-4 of its largest gradient magnitude and the error's norm <= 2e-4
  of the gradient's norm (measured: <= 1.3e-4 and <= 6e-5).
* the edge-on fixture (tests/test_pallas_interpret.py) against the Pallas
  backward kernel in interpret mode.
* the wrapper: the plain version on the CPU, no counted launch, bad inputs
  raise; and on a card, the kernel against the plain version.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from torch_scenes import settings_pair, splat_scene, to_torch

torch.set_num_threads(2)

CASES = {"normal": (1, False, True, 400), "seam": (2, True, True, 400),
         "no_distortion": (3, False, False, 400),
         "dense": (4, False, True, 1500)}


def _scene(case, S=2):
    seed, wrap, dist, P = CASES[case]
    sc = splat_scene(np.random.default_rng(seed), P=P, S=S, wrap=wrap)
    if case == "dense":
        sc["opac"] = np.full_like(sc["opac"], 0.95)   # saturate tiles early
    js, ts = settings_pair(wrap=wrap, hfov=(-180.0, 180.0) if wrap
                           else (-60.0, 60.0), S=S, compute_distortion=dist)
    return sc, js, ts


def _rows(sc, ts):
    from gslidar_tpu_torch.raster.binning import bin_gaussians
    from gslidar_tpu_torch.raster.composite_fwd import pack_payload
    from gslidar_tpu_torch.raster.preprocess import preprocess
    t = to_torch(sc)
    prep = preprocess(t["means"], t["scales"], t["quats"], t["opac"],
                      t["shs"], t["mask"], t["viewmat"], t["campos"], 3, 1.0,
                      ts)
    b = bin_gaussians(prep.rect_min, prep.rect_max, prep.depth,
                      prep.tiles_touched, 1.0, ts,
                      payload=pack_payload(prep, t["opac"], t["feats"]))
    return b.data_rows.contiguous(), b.tile_starts


def _cotangents(ts, C, S, seed):
    r = np.random.default_rng(seed)
    H, W = ts.height, ts.width
    cts = [torch.as_tensor(r.normal(size=s).astype(np.float32))
           for s in ((C, H, W), (S + 3, H, W), (4, H, W), (1, H, W))]
    if not ts.compute_distortion:
        cts[2][2] = 0.0
    return cts


def _autograd_table(rows, starts, params, ts, C, S, cts):
    from gslidar_tpu_torch.raster.composite_fwd import \
        composite_forward_reference
    r = rows.clone().requires_grad_(True)
    out = composite_forward_reference(r, starts, params, ts, C, S)
    loss = ((out.color * cts[0]).sum() + (out.feature * cts[1]).sum()
            + (out.depth * cts[2]).sum() + (out.misc[0:1] * cts[3]).sum())
    return torch.autograd.grad(loss, r)[0]


def _col_err(a, ref):
    """Per column: max |a - ref| / max |ref|."""
    scale = ref.abs().amax(0).clamp_min(1e-30)
    return ((a - ref).abs().amax(0) / scale).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_reference_matches_autograd_of_forward_reference(case):
    from gslidar_tpu_torch.raster.composite_bwd import \
        composite_backward_reference
    from gslidar_tpu_torch.raster.composite_fwd import (
        composite_forward_reference, make_params)
    C, S = 4, 2
    sc, _, ts = _scene(case, S)
    rows, starts = _rows(sc, ts)
    params = make_params(1.0, ts)
    cts = _cotangents(ts, C, S, seed=10 + CASES[case][0])
    with torch.no_grad():
        fwd = composite_forward_reference(rows, starts, params, ts, C, S)
    table = composite_backward_reference(rows, starts, fwd, cts, params, ts,
                                         C, S)
    assert torch.isfinite(table).all()
    # the S feature columns: sum of w * cotangent, in both
    auto = _autograd_table(rows, starts, params, ts, C, S, cts)
    s_cols = slice(10 + C, 10 + C + S)
    assert _col_err(table[:, s_cols], auto[:, s_cols]).max() <= 1e-4
    # every column, with no S cotangent (autograd would send it into alpha)
    cts[1][:S] = 0.0
    table = composite_backward_reference(rows, starts, fwd, cts, params, ts,
                                         C, S)
    auto = _autograd_table(rows, starts, params, ts, C, S, cts)
    err = _col_err(table[:, :10 + C], auto[:, :10 + C])
    assert err.max() <= 1e-4, err
    # instances never walked have zero rows; some tile stopped early
    walked = fwd.misc[5, ::ts.tile_h, ::ts.tile_w].reshape(-1).long()
    if case == "dense":
        counts = (starts[1:] - starts[:-1]).long()
        assert bool((walked < counts).any())
    skipped = torch.ones(rows.shape[0], dtype=torch.bool)
    for t in range(ts.num_tiles):
        skipped[int(starts[t]):int(starts[t]) + int(walked[t])] = False
    assert float(table[skipped].abs().sum()) == 0.0


NAMES = ("means", "scales", "quats", "opac", "shs", "feats", "T_tap")


def _loss_weights(ts, seed):
    r = np.random.default_rng(seed)
    H, W = ts.height, ts.width
    w = {k: r.normal(size=(ch, H, W)).astype(np.float32) for k, ch in
         (("color", 4), ("feature", ts.num_extra_features + 3),
          ("depth", 4), ("alpha", 1))}
    if not ts.compute_distortion:
        w["depth"][2] = 0.0
    return w


@pytest.mark.parametrize("case", list(CASES))
def test_rasterize_grads_match_jax(case):
    import jax
    import jax.numpy as jnp
    from gslidar_tpu.raster.rasterize import rasterize as jax_rasterize
    from gslidar_tpu_torch.raster.rasterize import rasterize
    sc, js, ts = _scene(case)
    P = sc["means"].shape[0]
    wts = _loss_weights(ts, 100 + CASES[case][0])
    bg = np.asarray([0.0, 0.0, 0.0, 1.0], np.float32)

    def jloss(*a):
        out = jax_rasterize(*a[:6], jnp.asarray(sc["mask"]),
                            jnp.asarray(sc["viewmat"]),
                            jnp.asarray(sc["campos"]), jnp.asarray(bg), 3,
                            1.0, js, T_tap=a[6])
        return sum(jnp.sum(getattr(out, k) * w) for k, w in wts.items())

    jargs = [jnp.asarray(sc[k]) for k in NAMES[:-1]] + [
        jnp.zeros((P, 3, 3), jnp.float32)]
    jg = jax.grad(jloss, argnums=tuple(range(7)))(*jargs)

    targs = [torch.tensor(sc[k], requires_grad=True) for k in NAMES[:-1]] + [
        torch.zeros(P, 3, 3, requires_grad=True)]
    out = rasterize(*targs[:6], torch.as_tensor(sc["mask"]),
                    torch.as_tensor(sc["viewmat"]),
                    torch.as_tensor(sc["campos"]), torch.as_tensor(bg), 3,
                    1.0, ts, T_tap=targs[6])
    loss = sum((getattr(out, k) * torch.as_tensor(w)).sum()
               for k, w in wts.items())
    tg = torch.autograd.grad(loss, targs)
    for name, a, b in zip(NAMES, jg, tg):
        a, b = np.asarray(a), b.numpy()
        assert np.isfinite(b).all(), name
        assert np.abs(a).max() > 0, name
        assert np.abs(a - b).max() <= 5e-4 * np.abs(a).max(), name
        assert np.linalg.norm(a - b) <= 2e-4 * np.linalg.norm(a), name


@pytest.fixture()
def interpret_pallas(monkeypatch):
    import gslidar_tpu.raster.pallas_fwd as pf
    monkeypatch.setattr(pf.pl, "pallas_call",
                        functools.partial(pf.pl.pallas_call, interpret=True))


def test_edge_on_fixture_matches_pallas_backward(interpret_pallas):
    """tests/test_pallas_interpret.py's edge-on fixture: splat 0 is seen
    nearly edge-on (s2 overflows to -inf), splat 1 is an ordinary splat in
    the same tile. The port's gradients are finite, splat 1 gets gradient,
    and they match the Pallas backward kernel's."""
    import jax
    import jax.numpy as jnp
    from gslidar_tpu.raster.pallas_fwd import make_params as jax_params
    from gslidar_tpu.raster.pallas_fwd import pack_payload as jax_pack
    from gslidar_tpu.raster.pallas_op import composite_op
    from gslidar_tpu.raster.preprocess import PreprocessOut
    from gslidar_tpu_torch.raster.composite_fwd import make_params
    from gslidar_tpu_torch.raster.composite_op import CompositeOp
    from test_torch_composite import _edge_on_prep

    js, ts = settings_pair(height=48, width=96, S=0, tile_h=8, tile_w=128)
    js = dataclasses.replace(js, pair_cap=256, backend="pallas")
    prep = _edge_on_prep()
    opac = jnp.full(prep.depth.shape, 0.9)
    feats = jnp.zeros((prep.depth.shape[0], 0))
    jparams = jax_params(1.0, js)

    def jloss(packed):
        color, feature, depth, misc8 = composite_op(
            packed, prep.rect_min, prep.rect_max, prep.depth,
            prep.tiles_touched, 1.0, jparams, js, 4, 0)
        return (jnp.sum(color) + jnp.sum(feature) + jnp.sum(depth[:, :2])
                + jnp.sum(misc8[:, 0]))

    packed = jax_pack(prep, opac, feats)
    jg = np.asarray(jax.grad(jloss)(packed))

    tp = PreprocessOut(*[torch.as_tensor(np.array(x)) for x in prep])
    tpacked = torch.tensor(np.asarray(packed), requires_grad=True)
    color, feature, depth, misc = CompositeOp.apply(
        tpacked, tp.rect_min, tp.rect_max, tp.depth, tp.tiles_touched, 1.0,
        make_params(1.0, ts), ts, 4, 0, {})
    loss = color.sum() + feature.sum() + depth[:2].sum() + misc[0].sum()
    g = torch.autograd.grad(loss, tpacked)[0].numpy()
    assert np.isfinite(float(loss.detach())) and np.isfinite(g).all()
    assert np.abs(g[1]).sum() > 0                 # the ordinary splat
    np.testing.assert_allclose(g, jg, atol=1e-4 * np.abs(jg).max())


def _small_case():
    from gslidar_tpu_torch.raster.composite_fwd import (
        composite_forward_reference, make_params)
    sc, _, ts = _scene("normal")
    rows, starts = _rows(sc, ts)
    params = make_params(1.0, ts)
    fwd = composite_forward_reference(rows, starts, params, ts, 4, 2)
    return rows, starts, fwd, _cotangents(ts, 4, 2, 0), params, ts


def test_wrapper_cpu_runs_the_plain_version():
    from gslidar_tpu_torch.raster import composite_bwd as cb
    rows, starts, fwd, cts, params, ts = _small_case()
    before = cb.composite_backward.launches
    a = cb.composite_backward(rows, starts, fwd, cts, params, ts, 4, 2)
    b = cb.composite_backward_reference(rows, starts, fwd, cts, params, ts,
                                        4, 2)
    assert cb.composite_backward.launches == before
    assert torch.equal(a, b) and a.shape == rows.shape


@pytest.mark.parametrize("bad", ["ct_dtype", "ct_shape", "fwd_shape",
                                 "tile", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    from gslidar_tpu_torch.raster import composite_bwd as cb
    rows, starts, fwd, cts, params, ts = _small_case()
    if bad == "ct_dtype":
        cts[0] = cts[0].double()
    elif bad == "ct_shape":
        cts[1] = cts[1][:-1]
    elif bad == "fwd_shape":
        fwd = fwd._replace(misc=fwd.misc[:7])
    elif bad == "tile":
        ts = dataclasses.replace(ts, tile_h=3, tile_w=5)
        starts = torch.zeros(ts.num_tiles + 1, dtype=torch.int32)
    else:
        rows, starts = rows.to("meta"), starts.to("meta")
        fwd = type(fwd)(*[x.to("meta") for x in fwd])
        cts = [x.to("meta") for x in cts]
    with pytest.raises((TypeError, ValueError)):
        cb.composite_backward(rows, starts, fwd, cts, params, ts, 4, 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_backward_kernel_matches_plain_on_card(cuda_device):
    """On the card, without JAX: the backward kernel against its plain
    version on the port's own forward kernel outputs (chip_smoke.py's bar:
    per column, max error <= 1e-4 of the column's largest magnitude), one
    counted launch, a finite table."""
    from gslidar_tpu_torch.raster import composite_bwd as cb
    from gslidar_tpu_torch.raster import composite_fwd as cf
    torch.backends.cuda.matmul.allow_tf32 = False
    sc, _, ts = _scene("seam")
    rows, starts = _rows(sc, ts)
    rows, starts = rows.to(cuda_device), starts.to(cuda_device)
    params = cf.make_params(1.0, ts)
    fwd = cf.composite_forward(rows, starts, params, ts, 4, 2)
    cts = [x.to(cuda_device) for x in _cotangents(ts, 4, 2, 5)]
    before = cb.composite_backward.launches
    k = cb.composite_backward(rows, starts, fwd, cts, params, ts, 4, 2)
    p = cb.composite_backward_reference(rows, starts, fwd, cts, params, ts,
                                        4, 2)
    torch.cuda.synchronize()
    assert cb.composite_backward.launches == before + 1
    assert torch.isfinite(k).all()
    assert _col_err(k.cpu(), p.cpu()).max() <= 1e-4
