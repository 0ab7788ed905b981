"""Port parity: the plain PyTorch forward compositor
(gslidar_tpu_torch.raster.composite_fwd.composite_forward_reference) vs
the JAX package's XLA compositor (gslidar_tpu.raster.composite.composite),
on the same preprocess output and the same sorted instance order.

Bars are the Pallas-vs-XLA ones (tests/test_pallas.py:56-65): color,
alpha and final T at 5e-4 (the port stops walking a tile once no pixel
has T >= 1e-4, the XLA scan decays T to the end, so final T may differ by
up to 1e-4), features at 2e-3, mean depth at 2e-2. The median position
and n_contrib are integers and must agree on >= 99.9% of pixels.
"""

import numpy as np
import pytest
import torch

from torch_scenes import settings_pair, splat_scene, to_jax

torch.set_num_threads(2)


def _jax_side(prep, feats, opac, js):
    import jax.numpy as jnp
    from gslidar_tpu.raster.binning import bin_gaussians
    from gslidar_tpu.raster.composite import composite, tile_list_overflow
    jb = bin_gaussians(prep.rect_min, prep.rect_max, prep.depth,
                       prep.tiles_touched, 1.0, js)
    assert int(jb.num_dropped) == 0
    assert int(tile_list_overflow(jb, js)) == 0
    bg = jnp.asarray([0.0, 0.0, 0.0, 1.0])
    return jb, composite(jb, prep, feats, opac, bg, 1.0, js)


def _port_side(prep, feats, opac, jb, ts):
    from gslidar_tpu.raster.preprocess import PreprocessOut
    from gslidar_tpu_torch.raster.composite_fwd import (
        composite_forward_reference, make_params, pack_payload)
    tp = PreprocessOut(*[torch.as_tensor(np.array(x)) for x in prep])
    total = int(jb.num_pairs)
    gid = torch.as_tensor(np.array(jb.gid_sorted)[:total]).long()
    rows = pack_payload(tp, torch.as_tensor(np.array(opac)),
                        torch.as_tensor(np.array(feats)))[gid].contiguous()
    starts = torch.as_tensor(np.array(jb.tile_starts))
    C, S = tp.color.shape[1], feats.shape[1]
    return composite_forward_reference(rows, starts, make_params(1.0, ts),
                                       ts, C, S)


def _assert_close(xla, out, S):
    T = out.misc[0:1]
    color = out.color + T * torch.tensor([0.0, 0.0, 0.0, 1.0])[:, None, None]
    for name, a, b, tol in [
            ("color", xla.color, color, 5e-4),
            ("alpha", xla.alpha, 1.0 - T, 5e-4),
            ("final_T", xla.final_T, T, 5e-4),
            ("feature", xla.feature, out.feature, 2e-3)]:
        b = b.numpy()
        assert np.isfinite(b).all(), name
        np.testing.assert_allclose(b, np.asarray(a), atol=tol, err_msg=name)
    for i in (0, 3):                                 # mean depth, sum w d^2
        np.testing.assert_allclose(out.depth[i].numpy(),
                                   np.asarray(xla.depth[i]), rtol=1e-4,
                                   atol=2e-2)
    np.testing.assert_allclose(out.depth[2].numpy(), np.asarray(xla.depth[2]),
                               atol=1e-4)            # distortion
    for k, name in ((0, "n_contrib"), (1, "median position")):
        same = out.misc[1 + k].numpy() == np.asarray(xla.contrib[k])
        assert same.mean() >= 0.999, name
    med = (out.misc[2].numpy() == np.asarray(xla.contrib[1]))
    np.testing.assert_allclose(out.depth[1].numpy()[med],
                               np.asarray(xla.depth[1])[med], atol=2e-2)


@pytest.mark.parametrize("case", ["normal", "seam", "no_distortion",
                                  "dense"])
def test_reference_matches_xla_composite(case):
    from gslidar_tpu.raster.preprocess import preprocess
    wrap = case == "seam"
    rng = np.random.default_rng({"normal": 1, "seam": 2, "no_distortion": 3,
                                 "dense": 4}[case])
    P = 1500 if case == "dense" else 400
    sc = splat_scene(rng, P=P, S=2, wrap=wrap)
    if case == "dense":
        sc["opac"] = np.full_like(sc["opac"], 0.95)   # saturate tiles early
    js, ts = settings_pair(
        wrap=wrap, hfov=(-180.0, 180.0) if wrap else (-60.0, 60.0),
        compute_distortion=case != "no_distortion")
    j = to_jax(sc)
    prep = preprocess(j["means"], j["scales"], j["quats"], j["opac"],
                      j["shs"], j["mask"], j["viewmat"], j["campos"], 3, 1.0,
                      js)
    jb, xla = _jax_side(prep, j["feats"], j["opac"], js)
    out = _port_side(prep, j["feats"], j["opac"], jb, ts)
    if case == "no_distortion":
        assert float(out.depth[2].abs().max()) == 0.0
        assert float(out.misc[3:5].abs().max()) == 0.0
        xla = xla._replace(depth=xla.depth.at[2].set(0.0))
    _assert_close(xla, out, 2)
    walked = out.misc[5]
    assert float(walked.max()) > 0
    if case == "dense":
        # some tile stopped before its list ended: the early exit ran
        starts = np.asarray(jb.tile_starts)
        counts = torch.as_tensor(starts[1:] - starts[:-1])
        per_tile = walked[::ts.tile_h, ::ts.tile_w].flatten()
        assert bool((per_tile < counts[:per_tile.numel()]).any())


def _edge_on_prep(P=128):
    """tests/test_pallas_interpret.py's edge-on fixture: splat 0 is seen
    nearly edge-on (p3 ~ 1e-36, s2 overflows to inf); splat 1 is an
    ordinary splat nearer in the same tile."""
    import jax.numpy as jnp
    from gslidar_tpu.raster.preprocess import PreprocessOut
    T = np.zeros((P, 3, 3), np.float32)
    T[0] = [[1, 0, 0], [0, 1e-36, 0], [0, -1.43365, 4.79005]]
    T[1] = [[0.5, 0, 0], [0, 0.5, 0], [0, -1.14692, 3.83204]]
    xy = np.tile(np.asarray([[48.0, 4.0]], np.float32), (P, 1))
    depth = np.full(P, 5.0, np.float32)
    depth[1] = 4.0
    valid = np.zeros(P, bool)
    valid[:2] = True
    return PreprocessOut(
        T=jnp.asarray(T), xy=jnp.asarray(xy), depth=jnp.asarray(depth),
        normal=jnp.asarray(np.tile([[0, 0, 1]], (P, 1)).astype(np.float32)),
        color=jnp.asarray(np.full((P, 4), 0.8, np.float32)),
        radius=jnp.where(jnp.asarray(valid), 4.0, 0.0),
        rect_min=jnp.zeros((P, 2), jnp.int32),
        rect_max=jnp.where(jnp.asarray(valid)[:, None],
                           jnp.ones((P, 2), jnp.int32), 0),
        tiles_touched=jnp.asarray(valid, jnp.int32),
        valid=jnp.asarray(valid))


def test_reference_edge_on_splat_finite():
    import jax.numpy as jnp
    js, ts = settings_pair(height=48, width=96, S=0, tile_h=8, tile_w=128)
    prep = _edge_on_prep()
    opac = jnp.full(prep.depth.shape, 0.9)
    feats = jnp.zeros((prep.depth.shape[0], 0))
    jb, xla = _jax_side(prep, feats, opac, js)
    out = _port_side(prep, feats, opac, jb, ts)
    for x in out:
        assert torch.isfinite(x).all()
    assert float(out.misc[6].max()) > 0          # splat 1 contributes
    _assert_close(xla, out, 0)


def _rows(ts, n=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    rows = torch.rand(n, 10 + 4 + 2, generator=g)
    starts = torch.zeros(ts.num_tiles + 1, dtype=torch.int32)
    starts[1:] = n
    return rows, starts


def test_wrapper_cpu_runs_the_plain_version():
    from gslidar_tpu_torch.raster import composite_fwd as cf
    _, ts = settings_pair()
    rows, starts = _rows(ts)
    params = cf.make_params(1.0, ts)
    before = cf.composite_forward.launches
    a = cf.composite_forward(rows, starts, params, ts, 4, 2)
    b = cf.composite_forward_reference(rows, starts, params, ts, 4, 2)
    assert cf.composite_forward.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a.color.shape == (4, ts.height, ts.width)
    assert a.misc.shape == (8, ts.height, ts.width)


@pytest.mark.parametrize("bad", ["dtype", "width", "starts", "layout"])
def test_wrapper_rejects_bad_inputs(bad):
    from gslidar_tpu_torch.raster import composite_fwd as cf
    _, ts = settings_pair()
    rows, starts = _rows(ts)
    if bad == "dtype":
        rows = rows.double()
    elif bad == "width":
        rows = rows[:, :-1]
    elif bad == "starts":
        starts = starts.long()
    else:
        rows = rows.t().contiguous().t()
    with pytest.raises((TypeError, ValueError)):
        cf.composite_forward(rows, starts, cf.make_params(1.0, ts), ts, 4, 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    """On the card, without JAX: the CUDA kernel against its plain version
    on the port's own preprocess and binning (chip_smoke.py's bars), one
    counted launch, and gradients flowing through rasterize: one forward
    and one backward kernel launch, finite gradients that reach every
    differentiated input."""
    from gslidar_tpu_torch.raster import composite_bwd as cb
    from gslidar_tpu_torch.raster import composite_fwd as cf
    from gslidar_tpu_torch.raster.binning import bin_gaussians
    from gslidar_tpu_torch.raster.preprocess import preprocess
    from gslidar_tpu_torch.raster.rasterize import rasterize
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(6)
    sc = {k: torch.as_tensor(v, device=cuda_device) for k, v in
          splat_scene(rng, P=2000, S=2, wrap=True).items()}
    _, ts = settings_pair(wrap=True, hfov=(-180.0, 180.0))
    prep = preprocess(sc["means"], sc["scales"], sc["quats"], sc["opac"],
                      sc["shs"], sc["mask"], sc["viewmat"], sc["campos"], 3,
                      1.0, ts)
    b = bin_gaussians(prep.rect_min, prep.rect_max, prep.depth,
                      prep.tiles_touched, 1.0, ts,
                      payload=cf.pack_payload(prep, sc["opac"], sc["feats"]))
    params = cf.make_params(1.0, ts)
    before = cf.composite_forward.launches
    k = cf.composite_forward(b.data_rows, b.tile_starts, params, ts, 4, 2)
    p = cf.composite_forward_reference(b.data_rows, b.tile_starts, params,
                                       ts, 4, 2)
    torch.cuda.synchronize()
    assert cf.composite_forward.launches == before + 1
    keep = k.misc[1] == p.misc[1]
    assert keep.float().mean() >= 0.999
    for a_ in k:
        assert torch.isfinite(a_).all()
    for a_, b_ in zip((k.color, k.feature, k.misc[0:1]),
                      (p.color, p.feature, p.misc[0:1])):
        assert float((a_ - b_).abs()[:, keep].max()) <= 1e-4
    inputs = [sc[k].clone().requires_grad_(True)
              for k in ("means", "scales", "quats", "opac", "shs", "feats")]
    fwd0, bwd0 = cf.composite_forward.launches, cb.composite_backward.launches
    out = rasterize(*inputs, sc["mask"], sc["viewmat"], sc["campos"],
                    torch.zeros(4, device=cuda_device), 3, 1.0, ts)
    loss = (out.color.square().sum() + 0.1 * out.depth.sum()
            + 0.05 * out.feature.sum() + 0.3 * out.alpha.sum())
    grads = torch.autograd.grad(loss, inputs)
    torch.cuda.synchronize()
    assert cf.composite_forward.launches == fwd0 + 1
    assert cb.composite_backward.launches == bwd0 + 1
    for g in grads:
        assert torch.isfinite(g).all() and float(g.abs().max()) > 0
