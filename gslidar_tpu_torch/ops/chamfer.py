"""Chamfer distance (port of gslidar_tpu/ops/chamfer.py, which replaces
the reference's chamfer3D CUDA extension, chamfer3D.cu).

``chamfer_distance`` takes the points as fixed-size [H*W, 3] panorama
clouds with their validity masks; only the valid ones are compared. On
CUDA tensors it is ``ChamferFn``: the forward and backward kernels of
csrc/chamfer.cu, which take the clouds and masks as they are, so nothing
is selected by a mask and nothing is read to the host (the counters
``launches.chamfer_fwd`` and ``launches.chamfer_bwd`` count them). On
CPU tensors it is the plain version, ``chamfer_reference``.

The plain version is a chunked brute force: each [chunk, M] block of
squared distances comes from |a|^2 + |b|^2 - 2 a.b (one matmul in full
float32) and only picks each point's nearest neighbour; the distance is
then recomputed exactly from the coordinate differences, so its gradient
is the exact 2(a - b) of the CUDA backward (chamfer3D.cu:167-196). Its
boolean selections read each mask's count on the host, and so do their
gradients in the backward: it counts each as a host sync
(``utils/trace.py``: ``chamfer_mask``, ``chamfer_index_bwd``,
``chamfer_scatter_bwd``).

``fscore`` is the F-score the eval meters report (chamfer/fscore.py).
"""

from __future__ import annotations

import torch

from gslidar_tpu_torch.kernels import launch
from gslidar_tpu_torch.raster.preprocess import check_full_f32_matmul
from gslidar_tpu_torch.utils.trace import count, count_sync, host_sync


def _one_sided_min_sqdist(a, b, chunk: int):
    """For each a[i]: min_j ||a_i - b_j||^2 ([N]; zeros when b is empty)."""
    if b.shape[0] == 0:
        return a.new_zeros(a.shape[0])
    bsq = torch.sum(b * b, dim=-1).detach()
    out = []
    for i in range(0, a.shape[0], chunk):
        blk = a[i:i + chunk]
        with torch.no_grad():
            d2 = (torch.sum(blk * blk, dim=-1)[:, None] + bsq[None, :]
                  - 2.0 * blk @ b.T)
            nn = torch.argmin(d2, dim=1)
        out.append(torch.sum((blk - b[nn]) ** 2, dim=-1))
    return torch.cat(out) if out else a.new_zeros(0)


def _all_valid(mask, x):
    if mask is None:
        return torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    return mask


def chamfer_reference(x1, x2, mask1=None, mask2=None, chunk: int = 4096):
    """The plain version of ``chamfer_distance``, on any device: the
    valid points selected by their masks, then chunked brute force
    (``_one_sided_min_sqdist``)."""
    check_full_f32_matmul(x1.device)
    mask1, mask2 = _all_valid(mask1, x1), _all_valid(mask2, x2)
    with host_sync("chamfer_mask", 2):
        a, b = x1[mask1], x2[mask2]
    s1 = _one_sided_min_sqdist(a, b, chunk)
    d1 = x1.new_zeros(x1.shape[0]).masked_scatter(mask1, s1)
    s2 = _one_sided_min_sqdist(b, a, chunk)
    d2 = x2.new_zeros(x2.shape[0]).masked_scatter(mask2, s2)
    if torch.is_grad_enabled():
        # the backward's reads: each selection's gradient goes through
        # index_put_ with its boolean mask, each masked_scatter's is a
        # masked_select; both take a nonzero
        n_index = int(a.requires_grad) + int(b.requires_grad)
        n_scatter = int(s1.requires_grad) + int(s2.requires_grad)
        if n_index:
            count_sync("chamfer_index_bwd", n_index)
        if n_scatter:
            count_sync("chamfer_scatter_bwd", n_scatter)
    return d1, d2, *_means(d1, d2, mask1, mask2)


def _means(d1, d2, mask1, mask2):
    n1 = torch.clamp_min(mask1.sum(), 1)
    n2 = torch.clamp_min(mask2.sum(), 1)
    return d1.sum() / n1, d2.sum() / n2


def _check_cloud(name, x, mask):
    """Raise unless x is float32 [n, 3] and mask bool [n] beside it."""
    if x.dim() != 2 or x.shape[1] != 3 or x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 [n, 3], got {x.dtype} "
                        f"{tuple(x.shape)}")
    if mask.dtype != torch.bool or mask.shape != (x.shape[0],) or \
            mask.device != x.device:
        raise TypeError(f"the mask of {name} must be bool [{x.shape[0]}] "
                        f"on {x.device}")


def chamfer_nearest(x1, x2, mask1, mask2):
    """The forward kernel: (dist1 [N], idx1 [N], dist2 [M], idx2 [M]) of
    float32 CUDA clouds x1 [N, 3], x2 [M, 3] (any strides) and their bool
    masks: each valid point's squared distance to its nearest valid point
    of the other cloud and that point's index (int32; the lowest on a
    tie), 0 and -1 where the point is invalid or the other cloud has no
    valid point."""
    N, M = x1.shape[0], x2.shape[0]
    dev = x1.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    dist1, idx1 = torch.empty(N, **f32), torch.empty(N, **i32)
    dist2, idx2 = torch.empty(M, **f32), torch.empty(M, **i32)
    if N + M:
        # the merge's scratch: a key per query, and a count per tile of
        # queries (fewer tiles than queries, whatever the kernel's tile)
        keys = torch.empty(N + M, dtype=torch.int64, device=dev)
        merged = torch.empty(N + M, **i32)
        launch("gslidar_chamfer_fwd", dev,
               x1.data_ptr(), N, *x1.stride(), mask1.data_ptr(),
               x2.data_ptr(), M, *x2.stride(), mask2.data_ptr(),
               keys.data_ptr(), merged.data_ptr(), dist1.data_ptr(),
               idx1.data_ptr(), dist2.data_ptr(), idx2.data_ptr())
        count("launches.chamfer_fwd")
    return dist1, idx1, dist2, idx2


def chamfer_nearest_backward(x1, x2, idx1, idx2, g1, g2, need1, need2):
    """The backward kernel: the gradients (d x1 [N, 3] or None, d x2
    [M, 3] or None: ``need1``, ``need2``) of the distances of
    ``chamfer_nearest`` given theirs, g1 [N] and g2 [M]: g (2 (a - b)) to
    each valid query a and its negation to its neighbour b."""
    N, M = x1.shape[0], x2.shape[0]
    dev = x1.device
    g1, g2 = g1.contiguous(), g2.contiguous()
    dx1 = torch.empty(N, 3, dtype=torch.float32, device=dev) if need1 \
        else None
    dx2 = torch.empty(M, 3, dtype=torch.float32, device=dev) if need2 \
        else None
    if (need1 or need2) and N + M:
        launch("gslidar_chamfer_bwd", dev,
               x1.data_ptr(), N, *x1.stride(), x2.data_ptr(), M,
               *x2.stride(), idx1.data_ptr(), idx2.data_ptr(),
               g1.data_ptr(), g2.data_ptr(),
               None if dx1 is None else dx1.data_ptr(),
               None if dx2 is None else dx2.data_ptr())
        count("launches.chamfer_bwd")
    return dx1, dx2


class ChamferFn(torch.autograd.Function):
    """The nearest-neighbour pair of csrc/chamfer.cu as one differentiable
    op: (dist1, dist2) of two CUDA clouds and their masks; the indices
    stay inside."""

    @staticmethod
    def forward(ctx, x1, x2, mask1, mask2):
        dist1, idx1, dist2, idx2 = chamfer_nearest(x1, x2, mask1, mask2)
        ctx.save_for_backward(x1, x2, idx1, idx2)
        return dist1, dist2

    @staticmethod
    def backward(ctx, g1, g2):
        x1, x2, idx1, idx2 = ctx.saved_tensors
        dx1, dx2 = chamfer_nearest_backward(
            x1, x2, idx1, idx2, g1, g2, *ctx.needs_input_grad[:2])
        return dx1, dx2, None, None


def chamfer_distance(x1, x2, mask1=None, mask2=None, chunk: int = 4096):
    """Two-sided squared chamfer terms: ``ChamferFn`` on float32 CUDA
    tensors, ``chamfer_reference`` (its ``chunk``) on CPU tensors; any
    other device raises.

    Args:
        x1: [N, 3], x2: [M, 3]; mask*: boolean validity (None = all valid).
    Returns:
        (dist1 [N], dist2 [M], mean1, mean2): squared distances (0 at
        invalid points) and their means over the valid points
        (reference train.py:256-267).
    """
    if x1.device.type == "cpu":
        return chamfer_reference(x1, x2, mask1, mask2, chunk)
    if x1.device.type != "cuda" or x2.device != x1.device:
        raise ValueError(f"chamfer_distance runs on cpu or cuda tensors of "
                         f"one device, not {x1.device} and {x2.device}")
    mask1 = _all_valid(mask1, x1).contiguous()
    mask2 = _all_valid(mask2, x2).contiguous()
    _check_cloud("x1", x1, mask1)
    _check_cloud("x2", x2, mask2)
    d1, d2 = ChamferFn.apply(x1, x2, mask1, mask2)
    return d1, d2, *_means(d1, d2, mask1, mask2)


def fscore(dist1, dist2, mask1=None, mask2=None, threshold: float = 0.05):
    """F-score at ``threshold`` from ``chamfer_distance``'s squared
    distances (the threshold applies to squared distances, as in the
    reference's chamfer/fscore.py:4-18); 0 when both precisions are 0.
    Returns (fscore, precision_1, precision_2) as 0-d tensors."""
    if mask1 is None:
        mask1 = torch.ones(dist1.shape[0], dtype=torch.bool,
                           device=dist1.device)
    if mask2 is None:
        mask2 = torch.ones(dist2.shape[0], dtype=torch.bool,
                           device=dist2.device)
    n1 = torch.clamp_min(mask1.sum(), 1)
    n2 = torch.clamp_min(mask2.sum(), 1)
    precision_1 = ((dist1 < threshold) & mask1).sum() / n1
    precision_2 = ((dist2 < threshold) & mask2).sum() / n2
    f = 2 * precision_1 * precision_2 / (precision_1 + precision_2)
    return (torch.where(precision_1 + precision_2 > 0, f, 0.0),
            precision_1, precision_2)
