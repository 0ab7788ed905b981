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

from torch_scenes import (deep_tile_scene, opaque_front_tile_scene,
                          port_rows, settings_pair, splat_scene, to_jax,
                          to_torch)

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


def _ckpt_case(case, device="cpu"):
    """(rows, starts, params, settings) of the port's own preprocess and
    binning: ``normal``, ``dense`` (opacity 0.95, some tiles stop before
    their lists end), ``deep`` (one tile walks 12 staging batches) or
    ``opaque`` (a tile of 43 batches turns opaque within its first 2)."""
    from gslidar_tpu_torch.raster.composite_fwd import make_params
    from gslidar_tpu_torch.raster.settings import RasterSettings
    rng = np.random.default_rng({"normal": 1, "dense": 4, "deep": 7,
                                 "opaque": 11}[case])
    if case == "deep":
        sc = deep_tile_scene(rng)
    elif case == "opaque":
        sc = opaque_front_tile_scene(rng)
    else:
        sc = splat_scene(rng, P=1500 if case == "dense" else 400)
    if case == "dense":
        sc["opac"] = np.full_like(sc["opac"], 0.95)
    ts = RasterSettings(height=30, width=130, vfov=(-20.0, 20.0),
                        hfov=(-60.0, 60.0), num_extra_features=2)
    sc = {k: v.to(device) for k, v in to_torch(sc).items()}
    rows, starts = port_rows(sc, ts)
    return rows, starts, make_params(1.0, ts), ts


@pytest.mark.parametrize("case", ["normal", "dense", "deep"])
def test_checkpoints_leave_outputs_bitwise_unchanged(case):
    from gslidar_tpu_torch.raster import composite_fwd as cf
    rows, starts, params, ts = _ckpt_case(case)
    ckpt = cf.new_checkpoints(starts, rows.shape[0], ts, 4)
    with_ = cf.composite_forward(rows, starts, params, ts, 4, 2, ckpt)
    without = cf.composite_forward(rows, starts, params, ts, 4, 2)
    for a_, b_ in zip(with_, without):
        assert torch.equal(a_, b_)


@pytest.mark.parametrize("case", ["normal", "dense", "deep"])
def test_reference_checkpoint_zero_is_the_start(case):
    """Every tile's first checkpoint: T = 1 inside the image, 0 in the
    tile padding; every running sum 0."""
    from gslidar_tpu_torch.raster import composite_fwd as cf
    from gslidar_tpu_torch.raster.composite_bwd import _tile
    rows, starts, params, ts = _ckpt_case(case)
    ckpt = cf.new_checkpoints(starts, rows.shape[0], ts, 4)
    cf.composite_forward_reference(rows, starts, params, ts, 4, 2, ckpt)
    counts = starts[1:] - starts[:-1]
    assert int(ckpt.chunk_off[-1]) == int(((counts + 255) // 256).sum())
    inside = _tile(torch.ones(1, ts.height, ts.width), ts)[:, 0]
    for t in torch.nonzero(counts > 0)[:, 0].tolist():
        first = ckpt.state[int(ckpt.chunk_off[t])]
        assert torch.equal(first[0], inside[t])
        assert float(first[1:].abs().max()) == 0.0


def test_reference_checkpoint_after_the_walk_holds_the_totals():
    """Where the block vote stopped a tile before its list ended, the
    checkpoint of the batch it did not walk (written before the vote) holds
    the forward's totals, bit for bit: final T, the color and normal sums,
    sum w*d, sum w*d^2, sum w, M1 and M2."""
    from gslidar_tpu_torch.raster import composite_fwd as cf
    from gslidar_tpu_torch.raster.composite_bwd import _tile
    rows, starts, params, ts = _ckpt_case("dense")
    ckpt = cf.new_checkpoints(starts, rows.shape[0], ts, 4)
    out = cf.composite_forward_reference(rows, starts, params, ts, 4, 2,
                                         ckpt)
    totals = _tile(torch.cat(
        [out.misc[0:1], out.color, out.feature[2:5], out.depth[0:1],
         out.depth[3:4], out.misc[6:7], out.misc[3:5]]), ts)
    walked = out.misc[5, ::ts.tile_h, ::ts.tile_w].reshape(-1).long()
    counts = (starts[1:] - starts[:-1]).long()
    stopped = torch.nonzero(walked < counts)[:, 0]
    assert stopped.numel() > 0
    at = ckpt.chunk_off[stopped].long() + walked[stopped] // ts.tile_pixels
    assert torch.equal(ckpt.state[at], totals[stopped])


# ------------------------------------------ the kernel's passes, plainly
def _batch_hits(rows, starts, g, ts, C, S, b, idx):
    """Staged instances and hits of staging batch b of the tiles idx."""
    from gslidar_tpu_torch.raster import composite_fwd as cf
    B = ts.tile_pixels
    st = starts[:-1].long()[idx]
    end = starts[1:].long()[idx]
    pos = st[:, None] + b * B + torch.arange(B)[None, :]
    in_rng = pos < end[:, None]
    inst = cf.stage_instances(rows[pos.clamp(max=rows.shape[0] - 1)], g,
                              g.tcx[idx, None], C, S)
    return inst, cf.intersect(inst, g, idx, in_rng)


def _batch_products(rows, starts, params, ts, C, S, acc=torch.float32):
    """Pass A: [n_tiles, batches, pix] prod (1 - alpha) over each batch's
    ``ok`` instances, each pixel's product taken serially from 1.0 in
    list order (1 for the batches a tile does not hold), accumulated in
    ``acc`` and rounded to float32: the kernel accumulates in float32, as
    torch.cumprod does on the card; on the CPU torch.cumprod accumulates
    float32 in float64."""
    from gslidar_tpu_torch.raster import composite_fwd as cf
    g = cf.tile_grid(params, ts, rows.device)
    B = ts.tile_pixels
    counts = (starts[1:] - starts[:-1]).long()
    n_b = int((counts.max() + B - 1) // B)
    idx = torch.arange(ts.num_tiles)
    prod = torch.ones(ts.num_tiles, n_b, B)
    for b in range(n_b):
        _, h = _batch_hits(rows, starts, g, ts, C, S, b, idx)
        P = torch.ones(ts.num_tiles, B, dtype=acc)
        for j in range(B):
            P = torch.where(h.ok[:, j], P * (1.0 - h.alpha[:, j]).to(acc),
                            P)
        prod[:, b] = P.float()
    return prod


def _passes_plain(rows, starts, params, ts, C, S):
    """A plain model of the kernel's four passes (csrc/composite_fwd.cu):
    the batch products, the per-tile scan with the block vote, each walked
    batch composited from its scan T with the serial walk's arithmetic
    into local sums, and the in-order merge (the distortion in closed
    form). Returns (CompositeOut, Checkpoints, prod, T_start, local sums
    [n_tiles, batches, C + S + 12, pix])."""
    from gslidar_tpu_torch.raster import composite_fwd as cf
    from gslidar_tpu_torch.raster.settings import T_STOP
    g = cf.tile_grid(params, ts, rows.device)
    B, n_tiles, NB = ts.tile_pixels, ts.num_tiles, C + S
    counts = (starts[1:] - starts[:-1]).long()
    n_b = (counts + B - 1) // B
    prod = _batch_products(rows, starts, params, ts, C, S)
    # B: scan and vote
    T_start = torch.zeros_like(prod)
    nw = n_b.clone()
    T = g.inside.float()
    for b in range(prod.shape[1]):
        T_start[:, b] = T
        going = (b < nw) & (b < n_b)
        dead = going & ~(T >= T_STOP).any(1)
        nw = torch.where(dead, torch.full_like(nw, b), nw)
        T = torch.where(((b < nw) & going)[:, None], T * prod[:, b], T)
    T_fin = T
    # C: each walked batch from its scan T, local sums from zero
    far, near = g.far, g.near
    m_scale = far / (far - near)
    loc = torch.zeros(n_tiles, prod.shape[1], NB + 12, B)
    for b in range(prod.shape[1]):
        idx = torch.nonzero(b < nw)[:, 0]
        if idx.numel() == 0:
            continue
        inst, h = _batch_hits(rows, starts, g, ts, C, S, b, idx)
        T = T_start[idx, b]
        z = torch.zeros_like(T)
        acc = torch.zeros(idx.numel(), NB + 3, B)
        wsum, dsum, d2sum, M1, M2, dist, med_d, med_pos, ncon = (
            z.clone() for _ in range(9))
        fields = torch.cat([inst.blend, inst.nrm], -1)            # [t, B, F]
        for j in range(B):
            ok, a, d = h.ok[:, j], h.alpha[:, j], h.depth[:, j]
            Tb = T
            Tn = Tb * (1.0 - a)
            T = torch.where(ok, Tn, T)
            acc_ = ok & (Tn >= T_STOP)
            w = a * Tb
            pos1 = float(b * B + j + 1)
            acc = torch.where(acc_[:, None], acc + w[:, None] *
                              fields[:, j, :, None], acc)
            wsum = torch.where(acc_, wsum + w, wsum)
            dw = d * w
            dsum = torch.where(acc_, dsum + dw, dsum)
            d2sum = torch.where(acc_, d2sum + dw * d, d2sum)
            if ts.compute_distortion:
                m = m_scale * (1.0 - near / d)
                dist = torch.where(acc_, dist + (m * m * (1.0 - Tb) + M2
                                                 - 2.0 * m * M1) * w, dist)
                M1 = torch.where(acc_, M1 + m * w, M1)
                M2 = torch.where(acc_, M2 + m * m * w, M2)
            med = acc_ & (Tb > 0.5)
            med_d = torch.where(med, d, med_d)
            med_pos = torch.where(med, pos1, med_pos)
            if ts.compute_contrib:
                ncon = torch.where(acc_, pos1, ncon)
        loc[idx, b] = torch.cat([acc, torch.stack(
            [wsum, dsum, d2sum, M1, M2, dist, med_d, med_pos, ncon], 1)], 1)
    # D: the in-order merge, the checkpoint of each batch before it
    ckpt = cf.new_checkpoints(starts, rows.shape[0], ts, C)
    run = torch.zeros(n_tiles, NB + 12, B)
    W_, D_, D2, M1_, M2_, DI, MD, MP, NC = range(NB + 3, NB + 12)
    for b in range(prod.shape[1]):
        reached = (b <= nw) & (b < n_b)
        r = torch.nonzero(reached)[:, 0]
        ckpt.state[ckpt.chunk_off[r].long() + b] = torch.cat(
            [T_start[r, b, None], run[r, :C], run[r, NB:NB + 3],
             run[r][:, [D_, D2, W_, M1_, M2_]]], 1)
        i = torch.nonzero(b < nw)[:, 0]
        x, y = run[i], loc[i, b]
        new = x + y
        new[:, DI] = x[:, DI] + (y[:, DI] + x[:, M2_] * y[:, W_]
                                 - 2.0 * x[:, M1_] * y[:, M1_])
        has_med = y[:, MP] > 0
        new[:, MD] = torch.where(has_med, y[:, MD], x[:, MD])
        new[:, MP] = torch.where(has_med, y[:, MP], x[:, MP])
        new[:, NC] = torch.maximum(x[:, NC], y[:, NC])
        run[i] = new
    walked = torch.minimum(nw * B, counts).float()
    misc = torch.stack([T_fin, run[:, NC], run[:, MP], run[:, M1_],
                        run[:, M2_], walked[:, None].expand(n_tiles, B),
                        run[:, W_], torch.zeros(n_tiles, B)], 1)
    out = cf.CompositeOut(
        color=cf._untile(run[:, :C], ts), feature=cf._untile(run[:, C:NB + 3],
                                                             ts),
        depth=cf._untile(run[:, [D_, MD, DI, D2]], ts),
        misc=cf._untile(misc, ts))
    return out, ckpt, prod, T_start, loc


def _walked_batches(out, ts):
    return out.misc[5, ::ts.tile_h, ::ts.tile_w].reshape(-1).long()


@pytest.mark.parametrize("case", ["dense", "deep"])
def test_batch_products_are_the_checkpoint_steps(case):
    """T carries from batch to batch as T times the batch's product: the
    plain forward's checkpoint T of batch b + 1 is, bit for bit, its T of
    batch b times prod (1 - alpha) over batch b's ``ok`` instances, taken
    serially from 1.0 (the kernel's pass A), accumulated as the plain
    version's cumprod accumulates on the CPU."""
    from gslidar_tpu_torch.raster import composite_fwd as cf
    rows, starts, params, ts = _ckpt_case(case)
    ckpt = cf.new_checkpoints(starts, rows.shape[0], ts, 4)
    out = cf.composite_forward_reference(rows, starts, params, ts, 4, 2, ckpt)
    prod = _batch_products(rows, starts, params, ts, 4, 2, torch.float64)
    counts = (starts[1:] - starts[:-1]).long()
    walked = _walked_batches(out, ts)
    steps = 0
    for t in range(ts.num_tiles):
        n_w = int(-(-int(walked[t]) // ts.tile_pixels))
        n_b = int(-(-int(counts[t]) // ts.tile_pixels))
        c0 = int(ckpt.chunk_off[t])
        for b in range(min(n_w, n_b - 1)):
            T0, T1 = ckpt.state[c0 + b, 0], ckpt.state[c0 + b + 1, 0]
            assert torch.equal(T1, T0 * prod[t, b]), (t, b)
            steps += 1
    assert steps >= (11 if case == "deep" else 1)


@pytest.mark.parametrize("case", ["normal", "dense", "deep", "opaque"])
def test_walk_ends_at_the_first_batch_without_a_live_pixel(case):
    """Every tile's walked count (misc slot 5) is 256 x the first batch
    at whose start no pixel of the tile has T >= 1e-4, capped at the
    tile's count; on ``opaque`` that is 2 batches of 43."""
    from gslidar_tpu_torch.raster import composite_fwd as cf
    from gslidar_tpu_torch.raster.settings import T_STOP
    rows, starts, params, ts = _ckpt_case(case)
    ckpt = cf.new_checkpoints(starts, rows.shape[0], ts, 4)
    out = cf.composite_forward_reference(rows, starts, params, ts, 4, 2, ckpt)
    counts = (starts[1:] - starts[:-1]).long()
    B = ts.tile_pixels
    walked = _walked_batches(out, ts)
    stopped = 0
    for t in range(ts.num_tiles):
        n_b = int(-(-int(counts[t]) // B))
        c0 = int(ckpt.chunk_off[t])
        dead = [b for b in range(n_b)
                if not bool((ckpt.state[c0 + b, 0] >= T_STOP).any())]
        stop = dead[0] if dead else n_b
        assert int(walked[t]) == min(B * stop, int(counts[t])), t
        stopped += bool(dead)
    if case == "opaque":
        t = int(counts.argmax())
        assert int(counts[t]) >= 40 * B and int(walked[t]) == 2 * B
    if case in ("dense", "opaque"):
        assert stopped > 0


def test_distortion_merges_in_closed_form():
    """The deep tile's 12 batches: their local distortion sums, merged in
    batch order as dist += dist_b + M2 * sum w_b - 2 M1 M1_b, give the plain
    forward's distortion within 1e-5."""
    from gslidar_tpu_torch.raster import composite_fwd as cf
    rows, starts, params, ts = _ckpt_case("deep")
    ref = cf.composite_forward_reference(rows, starts, params, ts, 4, 2)
    out, _, _, _, loc = _passes_plain(rows, starts, params, ts, 4, 2)
    assert int(torch.count_nonzero(loc[:, :, -4].abs().amax(-1)
                                   .amax(0))) >= 12   # batches with a dist
    assert float(ref.depth[2].abs().max()) > 5e-3
    err = (out.depth[2] - ref.depth[2]).abs()
    assert float(err.max()) <= 1e-5


@pytest.mark.parametrize("case", ["normal", "dense", "deep", "opaque"])
def test_plain_passes_match_the_plain_forward(case):
    """The kernel's four passes, written plainly, against
    composite_forward_reference at chip_smoke.py's bars (atol 1e-4; the
    depth moments at rtol 1e-4 + atol 1e-3; integer choices on >= 99.9 %
    of pixels); the walked counts equal on every tile; the checkpoints'
    T within 1e-6 (both carry T as T times the batch's product, which the
    passes accumulate in float32 and the plain version's cumprod, on the
    CPU, in float64), their sums within 1e-4 of their field's largest."""
    from gslidar_tpu_torch.raster import composite_fwd as cf
    rows, starts, params, ts = _ckpt_case(case)
    ref_ck = cf.new_checkpoints(starts, rows.shape[0], ts, 4)
    ref = cf.composite_forward_reference(rows, starts, params, ts, 4, 2,
                                         ref_ck)
    out, ck, _, _, _ = _passes_plain(rows, starts, params, ts, 4, 2)
    assert torch.equal(out.misc[5], ref.misc[5])
    keep = out.misc[1] == ref.misc[1]
    assert keep.float().mean() >= 0.999
    assert (out.misc[2] == ref.misc[2]).float().mean() >= 0.999
    for a_, b_ in [(out.color, ref.color), (out.feature, ref.feature),
                   (out.misc[0:1], ref.misc[0:1]), (out.depth[2:3],
                                                    ref.depth[2:3]),
                   (out.misc[3:5], ref.misc[3:5]), (out.misc[6:7],
                                                    ref.misc[6:7])]:
        assert float((a_ - b_).abs()[:, keep].max()) <= 1e-4
    for i in (0, 3):
        over = ((out.depth[i] - ref.depth[i]).abs()
                - (1e-3 + 1e-4 * ref.depth[i].abs()))[keep]
        assert float(over.max()) <= 0
    walked = _walked_batches(out, ts)
    counts = (starts[1:] - starts[:-1]).long()
    for t in range(ts.num_tiles):
        reach = min(int(-(-int(walked[t]) // 256)) + 1,
                    int(-(-int(counts[t]) // 256)))
        if reach == 0:
            continue
        c = slice(int(ck.chunk_off[t]), int(ck.chunk_off[t]) + reach)
        assert float((ck.state[c, 0] - ref_ck.state[c, 0]).abs().max()
                     ) <= 1e-6
        scale = ref_ck.state[c, 1:].abs().amax((0, 2)).clamp_min(1e-30)
        rel = (ck.state[c, 1:] - ref_ck.state[c, 1:]).abs().amax((0, 2))
        assert float((rel / scale).max()) <= 1e-4


def test_plain_passes_match_xla_composite():
    """The kernel's passes, written plainly, against the JAX package's XLA
    compositor on the dense scene, at the Pallas-vs-XLA bars."""
    from gslidar_tpu.raster.preprocess import preprocess
    from gslidar_tpu.raster.preprocess import PreprocessOut
    from gslidar_tpu_torch.raster.composite_fwd import (make_params,
                                                        pack_payload)
    rng = np.random.default_rng(4)
    sc = splat_scene(rng, P=1500, S=2)
    sc["opac"] = np.full_like(sc["opac"], 0.95)
    js, ts = settings_pair()
    j = to_jax(sc)
    prep = preprocess(j["means"], j["scales"], j["quats"], j["opac"],
                      j["shs"], j["mask"], j["viewmat"], j["campos"], 3, 1.0,
                      js)
    jb, xla = _jax_side(prep, j["feats"], j["opac"], js)
    tp = PreprocessOut(*[torch.as_tensor(np.array(x)) for x in prep])
    gid = torch.as_tensor(np.array(jb.gid_sorted)[:int(jb.num_pairs)]).long()
    rows = pack_payload(tp, torch.as_tensor(np.array(j["opac"])),
                        torch.as_tensor(np.array(j["feats"])))[gid]
    starts = torch.as_tensor(np.array(jb.tile_starts))
    out = _passes_plain(rows.contiguous(), starts, make_params(1.0, ts), ts,
                        4, 2)[0]
    _assert_close(xla, out, 2)


def _rows(ts, n=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    rows = torch.rand(n, 10 + 4 + 2, generator=g)
    starts = torch.zeros(ts.num_tiles + 1, dtype=torch.int32)
    starts[1:] = n
    return rows, starts


def test_wrapper_cpu_runs_the_plain_version():
    from gslidar_tpu_torch.raster import composite_fwd as cf
    from gslidar_tpu_torch.utils.trace import counters
    _, ts = settings_pair()
    rows, starts = _rows(ts)
    params = cf.make_params(1.0, ts)
    before = counters().get("launches.composite_fwd", 0)
    a = cf.composite_forward(rows, starts, params, ts, 4, 2)
    b = cf.composite_forward_reference(rows, starts, params, ts, 4, 2)
    assert counters().get("launches.composite_fwd", 0) == before
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
    from gslidar_tpu_torch.utils.trace import counters
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
    before = counters().get("launches.composite_fwd", 0)
    k = cf.composite_forward(b.data_rows, b.tile_starts, params, ts, 4, 2)
    p = cf.composite_forward_reference(b.data_rows, b.tile_starts, params,
                                       ts, 4, 2)
    torch.cuda.synchronize()
    assert counters().get("launches.composite_fwd", 0) == before + 1
    keep = k.misc[1] == p.misc[1]
    assert keep.float().mean() >= 0.999
    for a_ in k:
        assert torch.isfinite(a_).all()
    for a_, b_ in zip((k.color, k.feature, k.misc[0:1]),
                      (p.color, p.feature, p.misc[0:1])):
        assert float((a_ - b_).abs()[:, keep].max()) <= 1e-4
    inputs = [sc[k].clone().requires_grad_(True)
              for k in ("means", "scales", "quats", "opac", "shs", "feats")]
    fwd0 = counters().get("launches.composite_fwd", 0)
    bwd0 = counters().get("launches.composite_bwd", 0)
    out = rasterize(*inputs, sc["mask"], sc["viewmat"], sc["campos"],
                    torch.zeros(4, device=cuda_device), 3, 1.0, ts)
    loss = (out.color.square().sum() + 0.1 * out.depth.sum()
            + 0.05 * out.feature.sum() + 0.3 * out.alpha.sum())
    grads = torch.autograd.grad(loss, inputs)
    torch.cuda.synchronize()
    assert counters().get("launches.composite_fwd", 0) == fwd0 + 1
    assert counters().get("launches.composite_bwd", 0) == bwd0 + 1
    for g in grads:
        assert torch.isfinite(g).all() and float(g.abs().max()) > 0


@pytest.mark.cuda
def test_kernel_checkpoints_on_card(cuda_device):
    """On the card: the forward kernel's outputs are bitwise the same with
    and without the checkpoint buffer, on the deep tile and a dense scene,
    and the checkpoints of every batch the walk took agree with the plain
    version's (T within 1e-4; the sums within 1e-4 of their largest
    magnitude, as the outputs)."""
    from gslidar_tpu_torch.raster import composite_fwd as cf
    for case in ("deep", "dense"):
        rows, starts, params, ts = _ckpt_case(case, cuda_device)
        ckpt = cf.new_checkpoints(starts, rows.shape[0], ts, 4)
        with_ = cf.composite_forward(rows, starts, params, ts, 4, 2, ckpt)
        without = cf.composite_forward(rows, starts, params, ts, 4, 2)
        plain = cf.new_checkpoints(starts, rows.shape[0], ts, 4)
        cf.composite_forward_reference(rows, starts, params, ts, 4, 2, plain)
        torch.cuda.synchronize()
        for a_, b_ in zip(with_, without):
            assert torch.equal(a_, b_)
        walked = with_.misc[5, ::ts.tile_h, ::ts.tile_w].reshape(-1).long()
        taken = torch.cat([
            torch.arange(int(ckpt.chunk_off[t]), int(ckpt.chunk_off[t])
                         + (int(walked[t]) + 255) // 256)
            for t in range(ts.num_tiles)]).to(cuda_device)
        k, p = ckpt.state[taken], plain.state[taken]
        assert float((k[:, 0] - p[:, 0]).abs().max()) <= 1e-4
        scale = p[:, 1:].abs().amax((0, 2)).clamp_min(1e-30)
        assert float(((k[:, 1:] - p[:, 1:]).abs().amax((0, 2))
                      / scale).max()) <= 1e-4


@pytest.mark.cuda
def test_kernel_is_bitwise_repeatable_on_card(cuda_device):
    """On the card: the forward kernel twice on the same rows gives the
    same bits (no atomics, no order that depends on timing), with and
    without checkpoints, and the same checkpoints."""
    from gslidar_tpu_torch.raster import composite_fwd as cf
    for case in ("deep", "dense"):
        rows, starts, params, ts = _ckpt_case(case, cuda_device)
        cks = [cf.new_checkpoints(starts, rows.shape[0], ts, 4)
               for _ in range(2)]
        runs = [cf.composite_forward(rows, starts, params, ts, 4, 2, ck)
                for ck in cks]
        runs.append(cf.composite_forward(rows, starts, params, ts, 4, 2))
        torch.cuda.synchronize()
        for other in runs[1:]:
            for a_, b_ in zip(runs[0], other):
                assert torch.equal(a_, b_)
        walked = _walked_batches(runs[0], ts)
        taken = torch.cat([
            torch.arange(int(cks[0].chunk_off[t]), int(cks[0].chunk_off[t])
                         + (int(walked[t]) + 255) // 256)
            for t in range(ts.num_tiles)]).to(cuda_device)
        assert torch.equal(cks[0].state[taken], cks[1].state[taken])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["normal", "dense", "deep", "opaque"])
def test_kernel_walks_as_far_as_plain_on_card(case, cuda_device):
    """On the card: misc slot 5, the instances each tile walked, equals
    the plain version's on every tile (the scan's vote is the plain
    version's ``alive``)."""
    from gslidar_tpu_torch.raster import composite_fwd as cf
    rows, starts, params, ts = _ckpt_case(case, cuda_device)
    k = cf.composite_forward(rows, starts, params, ts, 4, 2)
    p = cf.composite_forward_reference(rows, starts, params, ts, 4, 2)
    torch.cuda.synchronize()
    assert torch.equal(_walked_batches(k, ts), _walked_batches(p, ts))
    assert torch.equal(k.misc[5], p.misc[5])


@pytest.mark.cuda
def test_kernel_matches_plain_on_early_opaque_tile_on_card(cuda_device):
    """On the card: a tile of 43 staging batches that turns opaque within
    its first 2: the kernel walks 2 batches, as the plain version does,
    and matches it at chip_smoke.py's bars; its checkpoints agree."""
    from gslidar_tpu_torch.raster import composite_fwd as cf
    rows, starts, params, ts = _ckpt_case("opaque", cuda_device)
    ckpt = cf.new_checkpoints(starts, rows.shape[0], ts, 4)
    plain_ck = cf.new_checkpoints(starts, rows.shape[0], ts, 4)
    k = cf.composite_forward(rows, starts, params, ts, 4, 2, ckpt)
    p = cf.composite_forward_reference(rows, starts, params, ts, 4, 2,
                                       plain_ck)
    torch.cuda.synchronize()
    counts = (starts[1:] - starts[:-1]).long()
    t = int(counts.argmax())
    assert int(counts[t]) >= 40 * 256
    assert int(_walked_batches(k, ts)[t]) == 2 * 256
    assert torch.equal(k.misc[5], p.misc[5])
    keep = k.misc[1] == p.misc[1]
    assert keep.float().mean() >= 0.999
    for a_, b_ in [(k.color, p.color), (k.feature, p.feature),
                   (k.misc[0:1], p.misc[0:1]), (k.depth[2:3], p.depth[2:3])]:
        assert float((a_ - b_).abs()[:, keep].max()) <= 1e-4
    for i in (0, 3):
        over = ((k.depth[i] - p.depth[i]).abs()
                - (1e-3 + 1e-4 * p.depth[i].abs()))[keep]
        assert float(over.max()) <= 0
    c0 = int(ckpt.chunk_off[t])
    c = slice(c0, c0 + 3)                  # 2 walked, and where it stopped
    assert float((ckpt.state[c, 0] - plain_ck.state[c, 0]).abs().max()
                 ) <= 1e-4
