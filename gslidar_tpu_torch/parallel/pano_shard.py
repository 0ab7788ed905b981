"""Single-frame 360° renders spread over a group (port of
gslidar_tpu/parallel/pano_shard.py).

The panorama is separable in azimuth: pixels of different columns never
share a compositing order, so it renders as n angular slices, one per
rank, each a [*, H, W/n] block of the image. Three renders:

* ``render_pano_sharded`` (hfov-sliced): every rank preprocesses all
  gaussians in a camera yawed so that its slice is centred at φ = 0,
  culls to its slice and composites it; one ``all_gather`` joins the
  slices along the width (JAX got that from its output sharding);
* ``render_pano_sh_sharded``: each rank evaluates SH for its P/n rows
  only, one ``all_gather`` of the [P, C] colors follows, then the
  hfov-sliced render with them;
* ``render_pano_gaussian_sharded``: each rank preprocesses only its P/n
  rows, in the shared frame, and routes each visible splat's record to
  the ranks whose slices it covers (one exact-size ``all_to_all``); each
  rank bins and composites its slice from what it received.

Each is split at its collectives into per-rank stages ``(d, n, ...)``;
the group calls the stages of the ranks it hosts. The renders are
forward only (serving and evaluation), like JAX's.
"""

from __future__ import annotations

import dataclasses

import torch

from gslidar_tpu_torch.raster.binning import bin_gaussians
from gslidar_tpu_torch.raster.composite_fwd import (PAYLOAD_BASE,
                                                    composite_forward,
                                                    make_params,
                                                    pack_payload)
from gslidar_tpu_torch.raster.preprocess import preprocess
from gslidar_tpu_torch.raster.rasterize import rasterize
from gslidar_tpu_torch.raster.settings import RasterSettings

# floats carry the records' tile indices exactly below 2^24
_EXACT_INT = 1 << 24


def _f32(x, device):
    return torch.tensor(x, dtype=torch.float32, device=device)


def _join(group, planes):
    """[per hosted rank] tuples of [*, H, W/n] planes -> the tuple of full
    [*, H, W] planes (one all_gather of all of them, along the width)."""
    sizes = [p.shape[0] for p in planes[0]]
    whole = group.all_gather([torch.cat(ps, 0) for ps in planes], -1)[0]
    return tuple(whole.split(sizes, 0))


def hfov_slice_stage(d, n, means3D, scales, rotations, opacity, shs,
                     features, mask, viewmat, campos, bg, sh_degree,
                     scale_factor, settings: RasterSettings,
                     colors_precomp=None):
    """Slice d of n of the hfov-sliced render: (color, feature, depth,
    alpha, contrib, final_T, num_pairs), each plane [*, H, W/n]."""
    dev = means3D.device
    vmin, vmax, hmin, hmax = settings.angle_bounds
    step = (hmax - hmin) / n
    # a slice is not circular, whatever the panorama is, and sorts on the
    # unsliced render's depth buckets (its fewer tiles would leave it
    # finer ones), so that it blends near-equal depths in the same order
    sub = dataclasses.replace(settings, width=settings.width // n,
                              wrap_x=False,
                              sort_depth_bits=settings.depth_bits)
    # render in a camera yawed so that this slice is centred at phi = 0:
    # its window stays away from the atan2 branch cut at +-pi, so splats
    # that wrap around (which the full render catches by their wrapped
    # rects) are still seen by the edge slices
    center = hmin + (_f32(d, dev) + 0.5) * step
    a = -center
    ca, sa = torch.cos(a), torch.sin(a)
    zero, one = torch.zeros((), device=dev), torch.ones((), device=dev)
    R = torch.stack([torch.stack([ca, zero, sa]),
                     torch.stack([zero, one, zero]),
                     torch.stack([-sa, zero, ca])])
    vm = viewmat.clone()
    vm[:3, :] = R @ viewmat[:3, :]
    half = 0.5 * step * one
    bounds = (float(vmin), float(vmax), float(-half), float(half))
    cull = (float(vmin), float(vmax), float(hmin - center),
            float(hmax - center))
    out = rasterize(means3D, scales, rotations, opacity,
                    None if colors_precomp is not None else shs, features,
                    mask, vm, campos, bg, sh_degree, scale_factor,
                    settings=sub, angle_bounds=bounds, cull_bounds=cull,
                    colors_precomp=colors_precomp)
    # normals were rendered in the yawed frame: rotate the last 3 feature
    # channels back to the caller's camera frame
    feat = out.feature
    nrm = torch.einsum("ij,ihw->jhw", R, feat[-3:])
    feat = torch.cat([feat[:-3], nrm], 0)
    return (out.color, feat, out.depth, out.alpha, out.contrib, out.final_T,
            out.num_pairs)


def render_pano_sharded(means3D, scales, rotations, opacity, shs, features,
                        mask, viewmat, campos, bg, sh_degree, scale_factor,
                        settings: RasterSettings, group, colors_precomp=None):
    """One panorama with its width split over ``group``'s ranks.

    The gaussian arrays are whole on every rank. Returns (color, feature,
    depth, alpha, contrib, final_T) as full [*, H, W] planes on every
    rank. With ``colors_precomp`` [P, C] the SH stage is skipped (``shs``
    may be None). Requires ``settings.width % n == 0``."""
    n = group.size
    W = settings.width
    if W % n != 0:
        raise ValueError(f"width {W} not divisible by mesh axis size {n}")
    planes = [hfov_slice_stage(d, n, means3D, scales, rotations, opacity,
                               shs, features, mask, viewmat, campos, bg,
                               sh_degree, scale_factor, settings,
                               colors_precomp)[:6]
              for d in group.ranks]
    return _join(group, planes)


def sh_colors_stage(d, n, means3D, campos, shs_local, sh_degree):
    """Rank d's [P/n, C] view colors from its own SH rows (the view
    direction depends only on the shared camera position, so one
    evaluation serves every slice)."""
    from gslidar_tpu_torch.ops.sh import eval_sh
    shard = means3D.shape[0] // n
    dirs = means3D[d * shard:(d + 1) * shard] - campos[None, :]
    dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, -1, keepdim=True)
                             + 1e-24)
    return eval_sh(sh_degree, shs_local, dirs)[0]


def render_pano_sh_sharded(means3D, scales, rotations, opacity, shs,
                           features, mask, viewmat, campos, bg, sh_degree,
                           scale_factor, settings: RasterSettings, group):
    """The hfov-sliced render with the SH color stage split over the
    gaussians: rank d evaluates rows [d·P/n, (d+1)·P/n) of ``shs`` (the
    [P, K, C] table is the largest per-gaussian array, and its evaluation
    the largest per-gaussian work), one all_gather moves the [P, C]
    colors, then ``render_pano_sharded`` runs with them. Requires P % n
    == 0."""
    n = group.size
    P = means3D.shape[0]
    if P % n != 0:
        raise ValueError(f"P {P} not divisible by mesh axis size {n}")
    shard = P // n
    cols = [sh_colors_stage(d, n, means3D, campos,
                            shs[d * shard:(d + 1) * shard], sh_degree)
            for d in group.ranks]
    colors = group.all_gather(cols, 0)[0]
    return render_pano_sharded(means3D, scales, rotations, opacity, None,
                               features, mask, viewmat, campos, bg,
                               sh_degree, scale_factor, settings, group,
                               colors_precomp=colors)


def slice_settings(settings: RasterSettings, n: int) -> RasterSettings:
    """A slice's settings in the gaussian-sharded render: W/n wide, not
    circular, the low-pass distance wrapping at the global width, and the
    global sort-key depth bits, so each slice sorts on the unsliced
    render's depth buckets."""
    return dataclasses.replace(settings, width=settings.width // n,
                               wrap_x=False,
                               wrap_period=float(settings.width),
                               sort_depth_bits=settings.depth_bits)


def route_stage(d, n, means3D, scales, rotations, opacity, shs, features,
                mask, viewmat, campos, sh_degree, scale_factor,
                settings: RasterSettings):
    """Rank d's records for each rank s, from its own P/n gaussians (the
    arrays given are its rows): a list of n [k_s, R + 6] float32 tensors,
    R the payload width, each row ``[payload, depth, y0, y1, lo, hi, 1]``
    for one linear column run of one splat that overlaps slice s, and the
    (gaussian, tile) instances those records hold on s, [n] int64.

    A splat's modular column run [lo, hi) (hi may pass tiles_x) is split
    into <= 2 linear runs in [0, tiles_x); a rank's records for s are its
    run-1 records, then its run-2 records, each in gaussian order, as
    JAX's buffers hold them."""
    gx = settings.tiles_x
    gxl = gx // n
    prep = preprocess(means3D, scales, rotations, opacity, shs, mask,
                      viewmat, campos, sh_degree, scale_factor, settings)
    payload = pack_payload(prep, opacity, features)
    live = prep.tiles_touched > 0
    lo, hi = prep.rect_min[:, 0], prep.rect_max[:, 0]
    y0, y1 = prep.rect_min[:, 1], prep.rect_max[:, 1]
    runs = ((lo, torch.clamp_max(hi, gx)),
            (torch.zeros_like(lo), torch.clamp_min(hi - gx, 0)))
    ones = payload.new_ones(payload.shape[0], 1)

    def col(x):
        return x[:, None].to(torch.float32)
    recs = [torch.cat([payload, prep.depth[:, None], col(y0), col(y1),
                       col(rlo), col(rhi), ones], 1) for rlo, rhi in runs]
    rows_y = (y1 - y0).to(torch.int64)
    send, inst = [], []
    for s in range(n):
        w0c, w1c = s * gxl, (s + 1) * gxl
        parts, k = [], payload.new_zeros((), dtype=torch.int64)
        for (rlo, rhi), rec in zip(runs, recs):
            m = live & (rhi > rlo) & (rlo < w1c) & (rhi > w0c)
            parts.append(rec[m])
            width = (torch.clamp_max(rhi, w1c) - torch.clamp_min(rlo, w0c))
            k = k + torch.where(m, width.to(torch.int64) * rows_y, 0).sum()
        send.append(torch.cat(parts, 0))
        inst.append(k)
    return send, torch.stack(inst)


def composite_slice_stage(d, n, recv, bg, scale_factor,
                          settings: RasterSettings):
    """Rank d's slice from the records it received (``recv``: one
    [k, R + 6] tensor per source rank, concatenated in source order):
    (color, feature, depth, alpha, contrib, final_T, num_pairs), planes
    [*, H, W/n]. The records bin on the slice's grid; the forward kernel
    composites under the slice's angle bounds, which give slice-local
    centre columns (the seam wrap at the global width brings a splat past
    -pi back by one period)."""
    sub = slice_settings(settings, n)
    C = bg.shape[-1]
    S = recv.shape[1] - 6 - PAYLOAD_BASE - C
    R = PAYLOAD_BASE + C + S
    gxl = settings.tiles_x // n
    vmin, vmax, hmin, hmax = settings.angle_bounds
    step = (hmax - hmin) / n
    dev = recv.device
    w0c = d * gxl
    ry0 = recv[:, R + 1].to(torch.int64)
    ry1 = recv[:, R + 2].to(torch.int64)
    lo_l = torch.clamp(recv[:, R + 3].to(torch.int64) - w0c, 0, gxl)
    hi_l = torch.clamp(recv[:, R + 4].to(torch.int64) - w0c, 0, gxl)
    tt = torch.where(recv[:, R + 5] > 0.5, (hi_l - lo_l) * (ry1 - ry0), 0)
    b = bin_gaussians(torch.stack([lo_l, ry0], -1),
                      torch.stack([hi_l, ry1], -1), recv[:, R], tt,
                      scale_factor, sub, payload=recv[:, :R])
    fd = _f32(d, dev)
    bounds = (float(vmin), float(vmax), float(hmin + fd * step),
              float(hmin + (fd + 1.0) * step))
    out = composite_forward(b.data_rows.contiguous(), b.tile_starts,
                            make_params(scale_factor, sub, bounds), sub, C,
                            S)
    T_fin = out.misc[0:1]
    return (out.color + T_fin * bg[:, None, None], out.feature, out.depth,
            1.0 - T_fin, out.misc[1:3], T_fin, b.num_pairs)


def render_pano_gaussian_sharded(means3D, scales, rotations, opacity, shs,
                                 features, mask, viewmat, campos, bg,
                                 sh_degree, scale_factor,
                                 settings: RasterSettings, group,
                                 edge_cap=None, stats=None):
    """The panorama with every per-gaussian stage split over the
    gaussians, and an instance exchange.

    1. rank d preprocesses rows [d·P/n, (d+1)·P/n) (full view, wrap-aware,
       in the caller's frame) and packs their payload (``route_stage``);
    2. the records go to the ranks whose slices they overlap: the counts,
       then the records, in one exact-size ``all_to_all``;
    3. rank d bins and composites its slice (``composite_slice_stage``).

    Requires ``settings.wrap_x`` (a full-360 panorama), ``width % (n ·
    tile_w) == 0`` (slices own whole tile columns) and ``P % n == 0``.
    Returns (color, feature, depth, alpha, contrib, final_T, num_dropped)
    with full [*, H, W] planes on every rank; ``num_dropped`` is the
    instances routed less the instances binned, over all slices: 0, as
    nothing is capped. ``edge_cap`` (JAX's static per-edge record
    capacity) is accepted and has no effect. ``stats``, a dict, receives
    per hosted rank the records sent and received and the instances
    composited (``records_sent``, ``records_received``, ``instances``)."""
    del edge_cap
    n = group.size
    W, tw = settings.width, settings.tile_w
    if not settings.wrap_x:
        raise ValueError("gaussian-sharded render needs a circular pano "
                         "(settings.wrap_x)")
    if W % (n * tw) != 0:
        raise ValueError(f"width {W} not divisible by {n} slices of whole "
                         f"{tw}-pixel tile columns")
    P = means3D.shape[0]
    if P % n != 0:
        raise ValueError(f"P {P} not divisible by mesh axis size {n}")
    if max(settings.tiles_x, settings.tiles_y) >= _EXACT_INT:
        raise ValueError("tile indices past 2^24 do not ride float32 "
                         "records exactly")
    shard = P // n

    def rows(x, d):
        return x[d * shard:(d + 1) * shard]
    routed = [route_stage(d, n, rows(means3D, d), rows(scales, d),
                          rows(rotations, d), rows(opacity, d),
                          rows(shs, d), rows(features, d), rows(mask, d),
                          viewmat, campos, sh_degree, scale_factor,
                          settings) for d in group.ranks]
    received = group.all_to_all([send for send, _ in routed])
    slices = [composite_slice_stage(d, n, torch.cat(recv, 0), bg,
                                    scale_factor, settings)
              for d, recv in zip(group.ranks, received)]
    counts = torch.stack([torch.stack([inst.sum(), inst.new_tensor(out[6])])
                          for (_, inst), out in zip(routed, slices)])
    total = group.all_reduce(list(counts), "sum")[0]
    if stats is not None:
        for d, (send, _), recv, out in zip(group.ranks, routed, received,
                                           slices):
            stats[d] = dict(records_sent=sum(s.shape[0] for s in send),
                            records_received=sum(r.shape[0] for r in recv),
                            instances=out[6])
    return _join(group, [out[:6] for out in slices]) + (
        int(total[0] - total[1]),)


def render_pano_sharded_jit(settings: RasterSettings, group, sh_degree: int,
                            scale_factor: float):
    """``render_pano_sharded`` as a closure over its settings (JAX's jitted
    twin; eager PyTorch has nothing to compile)."""
    def run(means3D, scales, rotations, opacity, shs, features, mask,
            viewmat, campos, bg):
        return render_pano_sharded(means3D, scales, rotations, opacity, shs,
                                   features, mask, viewmat, campos, bg,
                                   sh_degree, scale_factor, settings, group)
    return run
