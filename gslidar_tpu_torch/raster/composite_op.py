"""Differentiable compositing: bin -> forward kernel, and back
(port of gslidar_tpu/raster/pallas_op.py::composite_op).

``CompositeOp`` wraps the whole bin -> composite pipeline, as JAX's
custom_vjp does, so autograd never differentiates through the sort or the
payload gather. Only the packed per-gaussian rows [P, D] are
differentiated; the binning inputs set the instance order, which has no
gradient (pallas_op.py:100-103).

* forward: ``bin_gaussians`` (one host sync, an exact-size instance list,
  one payload gather), then the forward compositing kernel, in four
  passes that split each tile's walk into one CTA per staging batch (the
  batches' transmittance products, a per-tile scan of them, each walked
  batch composited from its scan T, an in-order merge of the batches'
  sums). When the rows will need a gradient, the merge also leaves the
  checkpoints (each pixel's running state at the start of every staging
  batch, T being the scan's) for the backward;
* backward: the backward compositing kernel, started per (tile, batch)
  from those checkpoints, writes one gradient row per
  sorted instance, and the per-gaussian reduction sums each gaussian's
  rows: ``zeros(P, D).index_add_(0, gid_sorted, table)``. The JAX package
  did that reduction in XLA outside any Pallas kernel
  (``segment_sum_runs``); its span is ``composite.reduce``, the
  kernel's ``composite.bwd``. On the card ``index_add_`` uses float atomics,
  so the per-gaussian gradients are not bitwise repeatable from run to
  run (the per-instance table is).
"""

from __future__ import annotations

import torch

from gslidar_tpu_torch.raster.binning import bin_gaussians
from gslidar_tpu_torch.raster.composite_bwd import composite_backward
from gslidar_tpu_torch.raster.composite_fwd import (Checkpoints,
                                                    CompositeOut,
                                                    composite_forward,
                                                    new_checkpoints)
from gslidar_tpu_torch.utils.trace import span


class CompositeOp(torch.autograd.Function):
    """(color, feature, depth, misc) planes from per-gaussian rows.

    ``apply(packed, rect_min, rect_max, bin_depth, tiles_touched,
    scale_factor, params, settings, C, S, info)``: ``info`` is a dict that
    receives ``num_pairs``, the instances composited. The forward keeps
    its checkpoints only when ``packed`` needs a gradient (rows packed
    under ``no_grad``, as serving packs them, do not). Of the outputs only
    color, feature, depth and misc slot 0 (final T) carry gradients.
    """

    @staticmethod
    def forward(ctx, packed, rect_min, rect_max, bin_depth, tiles_touched,
                scale_factor, params, settings, C, S, info):
        differentiable = ctx.needs_input_grad[0]
        binning = bin_gaussians(rect_min, rect_max, bin_depth, tiles_touched,
                                scale_factor, settings, payload=packed)
        rows = binning.data_rows.contiguous()
        ckpt = (new_checkpoints(binning.tile_starts, rows.shape[0], settings,
                                C) if differentiable else None)
        out = composite_forward(rows, binning.tile_starts, params, settings,
                                C, S, ckpt)
        info["num_pairs"] = binning.num_pairs
        if differentiable:
            ctx.save_for_backward(rows, binning.tile_starts,
                                  binning.gid_sorted, *ckpt, *out)
        ctx.meta = (params, settings, C, S, packed.shape[0])
        return tuple(out)

    @staticmethod
    def backward(ctx, gC, gF, gD4, gMisc):
        rows, tile_starts, gid, state, chunk_off, *outs = ctx.saved_tensors
        params, settings, C, S, P = ctx.meta
        fwd = CompositeOut(*outs)

        def ct(g, like):
            return (torch.zeros_like(like) if g is None
                    else g.to(torch.float32).contiguous())

        gT = ct(None if gMisc is None else gMisc[0:1], fwd.misc[0:1])
        table = composite_backward(
            rows, tile_starts, fwd,
            (ct(gC, fwd.color), ct(gF, fwd.feature), ct(gD4, fwd.depth), gT),
            params, settings, C, S, Checkpoints(state, chunk_off))
        with span("composite.reduce"):
            grad = rows.new_zeros(P, rows.shape[1]).index_add_(0, gid, table)
        return (grad,) + (None,) * 10
