"""Tile binning: exact-size duplication + one stable sort
(port of gslidar_tpu/raster/binning.py; reference rasterizer_impl.cu:
66-142,308-354).

Every (gaussian, tile) instance is materialized: ``total =
sum(tiles_touched)`` is read on the host once per render (one sync) and
the instance list is exactly that long, as the CUDA original sizes its
buffers per frame (rasterize_points.cu:25-33). There is no pair cap and
nothing is dropped.

The sort key is the JAX package's bit for bit: ``tile << depth_bits |
dq`` with the same depth quantization, held in int64. A stable sort keeps
the gaussian-major tie order of the expansion, so ``gid_sorted`` equals
``bin_gaussians``'s.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gslidar_tpu_torch.raster.settings import FAR_N, NEAR_N, RasterSettings


class Binning(NamedTuple):
    gid_sorted: torch.Tensor     # [total] int64 gaussian index per instance
    tile_sorted: torch.Tensor    # [total] int64 tile id per instance
    tile_starts: torch.Tensor    # [num_tiles + 1] int32 range starts
    num_pairs: int               # total instances
    data_rows: Optional[torch.Tensor] = None   # [total, D] payload rows
                                 # in (tile, depth) order


def depth_quant(depth, scale_factor, settings: RasterSettings):
    """Quantized depth of the sort key (binning.py:167-171 of the JAX
    package): [P] int64 in [0, 2^depth_bits - 1]."""
    near = NEAR_N * scale_factor
    far = FAR_N * scale_factor
    dq_max = (1 << settings.depth_bits) - 1
    dnorm = torch.clamp((depth - near) / max(far - near, 1e-12), 0.0, 1.0)
    return torch.clamp_max((dnorm * float(dq_max)).to(torch.int32),
                           dq_max).to(torch.int64)


def expand_instances(rect_min, rect_max, depth, tiles_touched, total,
                     scale_factor, settings: RasterSettings):
    """The expansion pass: one (gaussian, tile) instance per covered tile,
    gaussian-major. Returns ([total] gaussian index, [total] int64 sort
    key ``tile << depth_bits | dq``)."""
    device = depth.device
    P = depth.shape[0]
    gx = settings.tiles_x
    tt = tiles_touched.to(torch.int64)
    gid = torch.repeat_interleave(torch.arange(P, device=device), tt,
                                  output_size=total)
    offsets = torch.cumsum(tt, 0) - tt
    j = torch.arange(total, device=device) - offsets[gid]
    x0 = rect_min[:, 0].to(torch.int64)[gid]
    y0 = rect_min[:, 1].to(torch.int64)[gid]
    rw = torch.clamp_min(rect_max[:, 0].to(torch.int64)
                         - rect_min[:, 0].to(torch.int64), 1)[gid]
    dy = torch.div(j, rw, rounding_mode="floor")
    xcol = x0 + (j - dy * rw)
    if settings.wrap_x:
        # circular x: rect_min_x lies in [0, tiles_x) and the run is at
        # most tiles_x wide, so one conditional subtract is the mod
        xcol = torch.where(xcol >= gx, xcol - gx, xcol)
    tile = (y0 + dy) * gx + xcol
    dq = depth_quant(depth, scale_factor, settings)
    return gid, (tile << settings.depth_bits) | dq[gid]


def sort_instances(gid, key, settings: RasterSettings):
    """The sort pass: the int64 stable sort of the keys, the gaussian
    index permuted along, and each tile's range. Returns (gid_sorted,
    tile_sorted, int32 tile_starts)."""
    key_s, perm = torch.sort(key, stable=True)
    tile_s = key_s >> settings.depth_bits
    tile_starts = torch.searchsorted(
        tile_s, torch.arange(settings.num_tiles + 1, device=key.device))
    return gid[perm], tile_s, tile_starts.to(torch.int32)


def bin_gaussians(rect_min, rect_max, depth, tiles_touched, scale_factor,
                  settings: RasterSettings,
                  payload: Optional[torch.Tensor] = None) -> Binning:
    """Duplicate gaussians into per-tile instance lists sorted by
    (tile, quantized depth): the host sync of the total, the expansion,
    the sort and the payload gather.

    Args:
        rect_min, rect_max: [P, 2] int tile rects (x wraps mod tiles_x
            when ``settings.wrap_x``).
        depth: [P] spherical center range (the sort depth).
        tiles_touched: [P] int instance count per gaussian.
        payload: optional [P, D] rows, gathered once into sorted order.
    """
    total = int(tiles_touched.to(torch.int64).sum())     # the one host sync
    gid, key = expand_instances(rect_min, rect_max, depth, tiles_touched,
                                total, scale_factor, settings)
    gid_s, tile_s, tile_starts = sort_instances(gid, key, settings)
    return Binning(
        gid_sorted=gid_s,
        tile_sorted=tile_s,
        tile_starts=tile_starts,
        num_pairs=total,
        data_rows=payload[gid_s] if payload is not None else None,
    )
