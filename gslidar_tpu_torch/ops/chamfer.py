"""Chamfer distance (port of gslidar_tpu/ops/chamfer.py, which replaces
the reference's chamfer3D CUDA extension, chamfer3D.cu).

Chunked brute force: each [chunk, M] block of squared distances comes
from |a|^2 + |b|^2 - 2 a.b (one matmul in full float32) and only picks
each point's nearest neighbour; the distance is then recomputed exactly
from the coordinate differences, so its gradient is the exact 2(a - b)
of the CUDA backward (chamfer3D.cu:167-196). The points come masked, as
fixed-size [H*W, 3] panorama clouds; only the valid ones are compared.
``fscore`` is the F-score the eval meters report (chamfer/fscore.py).

The boolean selections read each mask's count on the host, and so do
their gradients in the backward: ``chamfer_distance`` counts each as a
host sync (``utils/trace.py``: ``chamfer_mask``, ``chamfer_index_bwd``,
``chamfer_scatter_bwd``).
"""

from __future__ import annotations

import torch

from gslidar_tpu_torch.raster.preprocess import check_full_f32_matmul
from gslidar_tpu_torch.utils.trace import count_sync, host_sync


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


def chamfer_distance(x1, x2, mask1=None, mask2=None, chunk: int = 4096):
    """Two-sided squared chamfer terms.

    Args:
        x1: [N, 3], x2: [M, 3]; mask*: boolean validity (None = all valid).
    Returns:
        (dist1 [N], dist2 [M], mean1, mean2): squared distances (0 at
        invalid points) and their means over the valid points
        (reference train.py:256-267).
    """
    check_full_f32_matmul(x1.device)
    if mask1 is None:
        mask1 = torch.ones(x1.shape[0], dtype=torch.bool, device=x1.device)
    if mask2 is None:
        mask2 = torch.ones(x2.shape[0], dtype=torch.bool, device=x2.device)
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
    n1 = torch.clamp_min(mask1.sum(), 1)
    n2 = torch.clamp_min(mask2.sum(), 1)
    return d1, d2, d1.sum() / n1, d2.sum() / n2


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
