"""Nearest-neighbour initial scales (port of gslidar_tpu/ops/knn.py, which
replaces simple-knn's distCUDA2; reference scene/gaussian_model.py:253-254).

Exact and chunked: each [chunk, P] block of distances is computed from
coordinate differences (``torch.cdist`` without the matmul expansion), the
3 nearest other points are picked from it, and their squared distances are
recomputed from the coordinates.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def mean_sq_dist_knn3(points: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """[P, 3] float32 -> [P] mean squared distance to the 3 nearest
    neighbours (self excluded; zeros for fewer than 4 points)."""
    P = points.shape[0]
    out = points.new_zeros(P)
    if P < 4:
        return out
    for i in range(0, P, chunk):
        blk = points[i:i + chunk]
        d = torch.cdist(blk, points,
                        compute_mode="donot_use_mm_for_euclid_dist")
        rows = torch.arange(blk.shape[0], device=points.device)
        d[rows, i + rows] = float("inf")
        nn = torch.topk(d, 3, dim=1, largest=False).indices
        out[i:i + chunk] = torch.mean(
            torch.sum((blk[:, None, :] - points[nn]) ** 2, dim=-1), dim=1)
    return out
