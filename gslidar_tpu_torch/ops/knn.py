"""Nearest-neighbour initial scales (port of gslidar_tpu/ops/knn.py, which
replaces simple-knn's distCUDA2; reference scene/gaussian_model.py:253-254).

Exact. ``mean_sq_dist_knn3`` searches a spatial index, so its work grows
with P times the neighbourhood, not with P squared:

1. the points are sorted along a Morton curve (10 bits per axis) and cut
   into blocks of ``chunk`` consecutive points, each compact in space, and
   they are sorted a second time by the key of a uniform grid whose cells
   hold ~8 points on average;
2. each query's 3rd-nearest distance among the points of its own block,
   r_q, bounds its true one, so its 3 nearest neighbours lie in the
   block's bounding box grown by R = the largest r_q of the block; every
   point of the grid cells under that box is a candidate, and the 3
   nearest candidates by squared distance (coordinate differences) are
   the 3 nearest points. A query whose r_q is above 4 times its block's
   median (an outlier that would grow the box for all), and a block whose
   box spans over 2^20 columns of cells, are searched by brute force
   instead;
3. the squared distances of the 3 are recomputed from the coordinates.

``mean_sq_dist_knn3_brute`` is the plain version the tests hold it
against: chunked [chunk, P] blocks of distances and a top-3 per row. At
P = 3M it takes ~1.5 h on an H100 (``torch.cdist`` without the matmul
expansion: ~4 s per [2048, 3M] block, PERF.md §5), the spatial search
seconds.
"""

from __future__ import annotations

import torch

_MAX_BLOCK_ELEMENTS = 1 << 27       # [queries, candidates] floats per slice
_MAX_COLUMNS = 1 << 20              # (x, y) cell columns under one box


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[A, 3] x [B, 3] -> [A, B] squared distances from coordinate
    differences."""
    return torch.sum((a[:, None, :] - b[None, :, :]) ** 2, dim=-1)


def _top3(queries: torch.Tensor, q_idx: torch.Tensor, points: torch.Tensor,
          cand: torch.Tensor) -> torch.Tensor:
    """Indices (into ``points``) of the 3 nearest of the candidates
    ``cand`` to each query, the query itself (``q_idx``) left out; the
    queries are taken in slices so a block stays under
    _MAX_BLOCK_ELEMENTS."""
    pts = points[cand]
    out = []
    step = max(1, _MAX_BLOCK_ELEMENTS // max(1, cand.numel() * 3))
    for i in range(0, queries.shape[0], step):
        d = _sq_dist(queries[i:i + step], pts)
        d[q_idx[i:i + step, None] == cand[None, :]] = float("inf")
        out.append(cand[torch.topk(d, 3, dim=1, largest=False).indices])
    return torch.cat(out)


def _morton_order(points: torch.Tensor) -> torch.Tensor:
    lo = points.amin(0)
    span = torch.clamp_min((points.amax(0) - lo).max(), 1e-30)
    q = ((points - lo) / span * 1023).to(torch.int64).clamp_(0, 1023)
    code = torch.zeros(points.shape[0], dtype=torch.int64,
                       device=points.device)
    for axis in range(3):                     # spread 10 bits to every 3rd
        v = q[:, axis]
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        code |= v << axis
    return torch.argsort(code)


class _Grid:
    """The points sorted by the key of a uniform grid (x-major), and the
    points of the cells under a box."""

    def __init__(self, points: torch.Tensor, per_cell: float = 8.0):
        self.lo = points.amin(0)
        ext = points.amax(0) - self.lo
        # a flat cloud (lidar ground) counts as 1/1000 of its extent thick
        ext = torch.clamp_min(ext, max(float(ext.max()) * 1e-3, 1e-30))
        self.cell = (float(torch.prod(ext)) * per_cell
                     / points.shape[0]) ** (1 / 3)
        self.dims = (ext / self.cell).to(torch.int64) + 1
        keys, self.order = torch.sort(self._key(self._cells(points)))
        self.keys = keys

    def _cells(self, p):
        return torch.minimum(((p - self.lo) / self.cell).to(torch.int64)
                             .clamp_(min=0), self.dims - 1)

    def _key(self, c):
        return (c[..., 0] * self.dims[1] + c[..., 1]) * self.dims[2] \
            + c[..., 2]

    def points_in(self, box_lo, box_hi):
        """Indices of the points in every cell the box overlaps, or None
        when the box spans more than _MAX_COLUMNS columns of cells."""
        lo, hi = self._cells(box_lo), self._cells(box_hi)
        if int((hi[0] - lo[0] + 1) * (hi[1] - lo[1] + 1)) > _MAX_COLUMNS:
            return None
        dev = lo.device
        xs = torch.arange(int(lo[0]), int(hi[0]) + 1, device=dev)
        ys = torch.arange(int(lo[1]), int(hi[1]) + 1, device=dev)
        gx, gy = torch.meshgrid(xs, ys, indexing="ij")
        col = (gx.reshape(-1) * self.dims[1] + gy.reshape(-1)) * self.dims[2]
        start = torch.searchsorted(self.keys, col + lo[2])
        end = torch.searchsorted(self.keys, col + hi[2], right=True)
        counts = end - start
        total = int(counts.sum())
        first = torch.repeat_interleave(start - (torch.cumsum(counts, 0)
                                                 - counts), counts,
                                        output_size=total)
        return self.order[first + torch.arange(total, device=dev)]


@torch.no_grad()
def mean_sq_dist_knn3(points: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """[P, 3] float32 -> [P] mean squared distance to the 3 nearest
    neighbours (self excluded; zeros for fewer than 4 points)."""
    P = points.shape[0]
    if P < 4:
        return points.new_zeros(P)
    chunk = max(chunk, 8)                     # every block holds >= 4
    morton = _morton_order(points)
    grid = _Grid(points)
    nn = torch.empty(P, 3, dtype=torch.int64, device=points.device)
    n_blocks = -(-P // chunk)
    bounds = [P * b // n_blocks for b in range(n_blocks + 1)]
    left = []
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        idx = morton[b0:b1]
        q = points[idx]
        r2 = torch.topk(torch.where(torch.eye(len(idx), dtype=torch.bool,
                                              device=q.device),
                                    float("inf"), _sq_dist(q, q)),
                        3, dim=1, largest=False).values[:, 2]
        inner = r2 <= 16 * torch.median(r2)
        grow = torch.sqrt(r2[inner].max())
        cand = grid.points_in(q[inner].amin(0) - grow,
                              q[inner].amax(0) + grow)
        if cand is None:
            left.append(idx)
            continue
        left.append(idx[~inner])
        nn[idx[inner]] = _top3(q[inner], idx[inner], points, cand)
    left = torch.cat(left)
    if left.numel():
        nn[left] = _brute_top3(points, left, chunk)
    return torch.mean(torch.sum((points[:, None, :] - points[nn]) ** 2,
                                dim=-1), dim=1)


def _brute_top3(points, rows, chunk):
    """Indices of the 3 nearest other points of ``points[rows]`` among all
    of ``points``, by [chunk, P] blocks."""
    every = torch.arange(points.shape[0], device=points.device)
    step = max(1, min(chunk, _MAX_BLOCK_ELEMENTS // (3 * points.shape[0])))
    return torch.cat([_top3(points[rows[i:i + step]], rows[i:i + step],
                            points, every)
                      for i in range(0, rows.numel(), step)])


@torch.no_grad()
def mean_sq_dist_knn3_brute(points: torch.Tensor,
                            chunk: int = 2048) -> torch.Tensor:
    """The plain version: each [chunk, P] block of distances is computed
    from coordinate differences (``torch.cdist`` without the matmul
    expansion), the 3 nearest other points are picked from it, and their
    squared distances are recomputed from the coordinates."""
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
