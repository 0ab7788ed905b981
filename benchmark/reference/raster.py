"""The reference rasterizer: preprocess -> bin -> composite, differentiable.

The plain versions of the passes (``preprocess``, ``binning``,
``composite``) assembled as the program assembles its kernels: one
autograd function wraps binning and compositing, and its backward is the
plain backward compositor followed by the per-gaussian sum of the
instances' gradient rows. The splat frame ``T`` and the SH colors are
computed differentiably (autograd carries their gradient on to the
gaussians); the rects, depths and tile counts, which carry none, are
computed in blocks of gaussians under ``no_grad`` so that a 10M-gaussian
scene fits beside its autograd graph.

``SINK``, when a list, receives one ``Composited`` per render: what the
work counts of ``benchmark/counts.py`` are computed from.
``PAYLOAD_DTYPE`` set to a lower precision rounds the packed rows to it
(the precision control of the correctness check).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.binning import bin_gaussians
from benchmark.reference.composite import (CompositeOut,
                                           composite_backward_reference,
                                           composite_forward_reference,
                                           make_params, pack_payload)
from benchmark.reference.geometry import RasterSettings
from benchmark.reference.preprocess import (_preprocess_plain, _view_dirs,
                                            build_transmat)
from benchmark.reference.sh import eval_sh

BLOCK = 1 << 21            # gaussians per block of the no-grad preprocess
SINK = None
PAYLOAD_DTYPE = None


class RasterOut(NamedTuple):
    color: torch.Tensor        # [C, H, W]
    feature: torch.Tensor      # [S+3, H, W]
    depth: torch.Tensor        # [4, H, W]
    alpha: torch.Tensor        # [1, H, W]
    contrib: torch.Tensor      # [2, H, W]
    final_T: torch.Tensor      # [1, H, W]
    radii: torch.Tensor        # [P]
    num_pairs: int
    num_dropped: int
    tile_need: int


class Composited(NamedTuple):
    """One render's compositing, for the work counts."""
    fwd: CompositeOut
    tile_starts: torch.Tensor
    num_pairs: int
    settings: RasterSettings
    gaussians: int


class CompositeRef(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, rect_min, rect_max, bin_depth, tiles_touched,
                scale_factor, params, settings, C, S, info):
        binning = bin_gaussians(rect_min, rect_max, bin_depth, tiles_touched,
                                scale_factor, settings, payload=packed)
        rows = binning.data_rows.contiguous()
        out = composite_forward_reference(rows, binning.tile_starts, params,
                                          settings, C, S)
        info["num_pairs"] = binning.num_pairs
        info["tile_starts"] = binning.tile_starts
        ctx.save_for_backward(rows, binning.tile_starts, binning.gid_sorted,
                              *out)
        ctx.meta = (params, settings, C, S, packed.shape[0])
        return tuple(out)

    @staticmethod
    def backward(ctx, gC, gF, gD4, gMisc):
        rows, tile_starts, gid, *outs = ctx.saved_tensors
        params, settings, C, S, P = ctx.meta
        fwd = CompositeOut(*outs)

        def ct(g, like):
            return (torch.zeros_like(like) if g is None
                    else g.to(torch.float32).contiguous())

        gT = ct(None if gMisc is None else gMisc[0:1], fwd.misc[0:1])
        table = composite_backward_reference(
            rows, tile_starts, fwd,
            (ct(gC, fwd.color), ct(gF, fwd.feature), ct(gD4, fwd.depth), gT),
            params, settings, C, S)
        grad = rows.new_zeros(P, rows.shape[1]).index_add_(0, gid, table)
        return (grad,) + (None,) * 10


def _geometry(means3D, scales, rotations, opacity, shs, mask, viewmat,
              campos, sh_degree, scale_factor, settings):
    """The preprocess outputs that carry no gradient, in blocks."""
    parts = []
    with torch.no_grad():
        for i in range(0, means3D.shape[0], BLOCK):
            sl = slice(i, i + BLOCK)
            prep, _ = _preprocess_plain(
                means3D[sl].detach(), scales[sl].detach(),
                rotations[sl].detach(), opacity[sl].detach(),
                shs[sl].detach(), mask[sl], viewmat, campos, sh_degree,
                scale_factor, settings)
            parts.append((prep.depth, prep.radius, prep.rect_min,
                          prep.rect_max, prep.tiles_touched))
    return [torch.cat(p) for p in zip(*parts)]


def rasterize(means3D, scales, rotations, opacity, shs, features, mask,
              viewmat, campos, bg, sh_degree, scale_factor,
              settings: RasterSettings, T_tap=None) -> RasterOut:
    depth, radius, rect_min, rect_max, tiles = _geometry(
        means3D, scales, rotations, opacity, shs, mask, viewmat, campos,
        sh_degree, scale_factor, settings)
    T, _ = build_transmat(means3D, scales, rotations, viewmat)
    color, _ = eval_sh(sh_degree, shs, _view_dirs(means3D, campos)[0])
    if T_tap is not None:
        T = T + T_tap
    C, S = color.shape[-1], features.shape[-1]

    class _Prep(NamedTuple):
        T: torch.Tensor
        color: torch.Tensor

    packed = pack_payload(_Prep(T, color), opacity, features)
    if PAYLOAD_DTYPE is not None:
        packed = packed.to(PAYLOAD_DTYPE).to(torch.float32)
    info = {}
    color_px, feature, depth4, misc = CompositeRef.apply(
        packed, rect_min, rect_max, depth, tiles, scale_factor,
        make_params(scale_factor, settings), settings, C, S, info)
    if SINK is not None:
        SINK.append(Composited(
            fwd=CompositeOut(color_px.detach(), feature.detach(),
                             depth4.detach(), misc.detach()),
            tile_starts=info["tile_starts"], num_pairs=info["num_pairs"],
            settings=settings, gaussians=means3D.shape[0]))
    T_fin = misc[0:1]
    return RasterOut(
        color=color_px + T_fin * bg[:, None, None], feature=feature,
        depth=depth4, alpha=1.0 - T_fin, contrib=misc[1:3], final_T=T_fin,
        radii=radius, num_pairs=info["num_pairs"], num_dropped=0,
        tile_need=0)
