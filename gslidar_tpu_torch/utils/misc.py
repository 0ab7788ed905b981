"""Scene-flow helpers: RANSAC ground plane, outlier removal, point lists
(the port's copy of gslidar_tpu/utils/misc.py).

Reference: utils/misc.py — used by the (config-disabled) scene-flow loss
path (lambda_flow_loss > 0, scene/__init__.py:75-77). Pure numpy/scipy —
no open3d dependency: statistical outlier removal is reimplemented with a
cKDTree.
"""

from __future__ import annotations

import numpy as np

from gslidar_tpu_torch.ops.pano import pano_to_lidar_np


def estimate_plane(xyz: np.ndarray, normalize: bool = True):
    """Plane (a,b,c,d) through 3 points; None if degenerate
    (reference utils/misc.py:29-60)."""
    v1 = xyz[1] - xyz[0]
    v2 = xyz[2] - xyz[0]
    if not np.all(v1):
        return None
    r = v2 / v1
    if not ((r[0] != r[1]) or (r[2] != r[1])):
        return None
    n = np.cross(v1, v2)
    if normalize:
        nn = np.linalg.norm(n)
        if nn < 1e-12:
            return None
        n = n / nn
    d = -np.dot(n, xyz[0])
    return np.array([n[0], n[1], n[2], d])


def my_ransac(points, distance_threshold=0.15, max_iterations=100,
              p=0.99, sample_size=3, rng=None):
    """RANSAC dominant-plane fit; returns (inlier_indices, coeffs)
    (reference utils/misc.py:65-124 semantics)."""
    rng = rng or np.random.default_rng(0)
    best_inliers = np.array([], dtype=np.int64)
    best_coeffs = None
    n = len(points)
    if n < sample_size:
        return best_inliers, best_coeffs
    i = 0
    max_iter = max_iterations
    while i < max_iter:
        i += 1
        sample = points[rng.choice(n, sample_size, replace=False)]
        coeffs = estimate_plane(sample)
        if coeffs is None:
            continue
        dist = np.abs(points @ coeffs[:3] + coeffs[3])
        inliers = np.where(dist <= distance_threshold)[0]
        if len(inliers) > len(best_inliers):
            best_inliers = inliers
            best_coeffs = coeffs
            ratio = len(inliers) / n
            if ratio > 1e-9:
                denom = np.log(max(1 - ratio ** sample_size, 1e-12))
                max_iter = min(max_iterations,
                               int(np.ceil(np.log(1 - p) / denom)) + 1)
    return best_inliers, best_coeffs


def remove_statistical_outliers(points, nb_neighbors=64, std_ratio=3.0):
    """open3d remove_statistical_outlier equivalent via cKDTree."""
    from scipy.spatial import cKDTree
    tree = cKDTree(points)
    dists, _ = tree.query(points, k=nb_neighbors + 1)
    mean_d = dists[:, 1:].mean(axis=1)
    thresh = mean_d.mean() + std_ratio * mean_d.std()
    keep = mean_d <= thresh
    return points[keep], np.where(keep)[0]


def range_filter(pcd, dist_min=1, dist_max=50, z_limit=(-2.5, 4)):
    dist = np.sqrt(np.sum(pcd[:, :3] ** 2, axis=1))
    mask = ((dist >= dist_min) & (dist <= dist_max)
            & (pcd[:, 2] > z_limit[0]) & (pcd[:, 2] < z_limit[1]))
    return pcd[mask]


def point_removal(pc_raw):
    """Ground removal pipeline: axis swap -> range filter -> outlier
    removal -> iterated RANSAC ground extraction (reference misc.py:135-165).
    Returns (pc_no_ground, pc_ground)."""
    pc = np.asarray(pc_raw) @ np.array([[1, 0, 0],
                                        [0, 0, -1],
                                        [0, 1, 0]], dtype=np.float64)
    pc = range_filter(pc)
    pc, _ = remove_statistical_outliers(pc[:, :3])

    index_total = np.array([], dtype=np.int64)
    for i in range(6):
        idx, _ = my_ransac(pc[:, :3], distance_threshold=0.15,
                           rng=np.random.default_rng(i))
        index_total = np.unique(np.concatenate([index_total, idx]))
    indices = index_total[pc[index_total, 2] < -1]
    pc_ground = pc[indices].copy()
    keep = np.ones(len(pc), bool)
    keep[indices] = False
    pc = pc[keep]
    pc, _ = remove_statistical_outliers(pc[:, :3])
    return pc, pc_ground


def load_point(args, camera):
    """Backproject a camera's GT pano to world points (misc.py:179-185)."""
    gt_lidar = pano_to_lidar_np(camera.pts_depth, args.vfov, args.hfov)
    return (gt_lidar - camera.T) @ camera.R.T


def point_list_from_cams(cameras, args):
    """Per-frame fused world clouds for the scene-flow loss
    (reference misc.py:168-176)."""
    point_list = {}
    for c in cameras:
        idx = c.colmap_id % args.frames
        pts = load_point(args, c)
        if idx not in point_list:
            point_list[idx] = pts
        else:
            point_list[idx] = np.concatenate([point_list[idx], pts])
    return point_list
