"""Procedural synthetic driving-scene loader for smoke tests and benches
(the port's copy of gslidar_tpu/data/synthetic.py).

Not present in the reference (which ships zero tests, SURVEY.md §4); this
generates a deterministic mini world — ground plane, walls, boxes — sweeps
a virtual LiDAR along a straight trajectory, and emits a SceneInfo in
exactly the same format as the KITTI-360 loader, so the full training
stack (projection, rasterizer, losses, densify, eval) runs end-to-end on
any machine.

Scene type name: ``Synthetic`` (scene_type in configs).
"""

from __future__ import annotations

import os

import numpy as np

from gslidar_tpu_torch.data.cameras import SceneInfo, get_nerfpp_norm
from gslidar_tpu_torch.data.kitti360 import (apply_pose_normalization,
                                             make_frame_cameras)
from gslidar_tpu_torch.utils.ply import fetch_points_ply, store_points_ply


def _world_surface_points(rng, n):
    """Sample points on ground + two walls + a few boxes, in world meters."""
    parts = []
    # ground strip along +x (travel direction), y lateral, z up
    g = np.stack([rng.uniform(-20, 60, n), rng.uniform(-10, 10, n),
                  np.zeros(n)], 1)
    parts.append(g)
    for wall_y in (-10.0, 10.0):
        w = np.stack([rng.uniform(-20, 60, n // 2),
                      np.full(n // 2, wall_y),
                      rng.uniform(0, 5, n // 2)], 1)
        parts.append(w)
    box_rng = np.random.default_rng(7)
    for _ in range(6):
        cx, cy = box_rng.uniform(0, 50), box_rng.uniform(-7, 7)
        sx, sy, sz = box_rng.uniform(1, 3, 3)
        b = np.stack([cx + rng.uniform(-sx, sx, n // 8),
                      cy + rng.uniform(-sy, sy, n // 8),
                      rng.uniform(0, 2 * sz, n // 8)], 1)
        parts.append(b)
    return np.concatenate(parts, 0)


def _simulate_sweep(world_pts, ego_xyz, vfov, hfov_full, n_az=1030, n_el=64,
                    max_range=80.0):
    """Pick the nearest world point per (azimuth, elevation) bin — a cheap
    spherical z-buffer standing in for ray casting."""
    rel = world_pts - ego_xyz
    # lidar frame: x fwd, y left, z up -> camera frame (x right, -y up, z fwd)
    r = np.linalg.norm(rel, axis=1)
    keep = (r > 2.5) & (r < max_range)
    rel, r = rel[keep], r[keep]
    az = np.arctan2(rel[:, 1], rel[:, 0])
    el = np.arcsin(np.clip(rel[:, 2] / r, -1, 1))
    el_lo, el_hi = np.deg2rad(vfov[0]), np.deg2rad(vfov[1])
    ok = (el > el_lo) & (el < el_hi)
    rel, r, az, el = rel[ok], r[ok], az[ok], el[ok]
    ai = np.clip(((az + np.pi) / (2 * np.pi) * n_az).astype(int), 0, n_az - 1)
    ei = np.clip(((el - el_lo) / (el_hi - el_lo) * n_el).astype(int), 0, n_el - 1)
    cell = ei * n_az + ai
    order = np.lexsort((r, cell))
    cell, rel, r = cell[order], rel[order], r[order]
    first = np.ones(len(cell), bool)
    first[1:] = cell[1:] != cell[:-1]
    pts = rel[first]
    inten = np.exp(-r[first] / 40.0).astype(np.float32)   # fake reflectance
    return pts.astype(np.float64), inten


def read_synthetic_info(args) -> SceneInfo:
    rng = np.random.default_rng(int(args.get("seed", 0)))
    frames = int(args.get("frames", 8))
    args.frames = frames
    time_duration = args.time_duration
    vfov, hfov = args.vfov, args.hfov

    world = _world_surface_points(rng, 60000)

    point_list, time_list, cam_infos = [], [], []
    for fi in range(frames):
        ego = np.array([fi * 4.0, 0.0, 1.8])
        sweep_lidar, intensity = _simulate_sweep(world, ego, vfov,
                                                 (-180, 180))
        # lidar->world: lidar axes == world axes here, offset by ego
        l2w = np.eye(4)
        l2w[:3, 3] = ego
        pts_world = sweep_lidar + ego

        timestamp = time_duration[0] + (time_duration[1] - time_duration[0]) \
            * fi / max(frames - 1, 1)
        point_list.append(pts_world)
        time_list.append(np.full((len(pts_world), 1), timestamp))

        front, back = make_frame_cameras(pts_world, intensity, l2w, fi,
                                         frames, timestamp, "synthetic")
        cam_infos += [front, back]

    pointcloud = np.concatenate(point_list, 0)
    pc_time = np.concatenate(time_list, 0)
    num_pts = min(int(args.num_pts), pointcloud.shape[0])
    sel = np.random.choice(pointcloud.shape[0], num_pts, replace=False)
    pointcloud, pc_time = pointcloud[sel], pc_time[sel]

    pointcloud, scale_factor = apply_pose_normalization(cam_infos, pointcloud,
                                                        args)
    args.scale_factor = scale_factor

    val = list(range(1, frames, 4))
    mod = args.cam_num
    if args.eval:
        train = [c for i, c in enumerate(cam_infos) if (i // mod) not in val]
        test = [c for i, c in enumerate(cam_infos) if (i // mod) in val]
    else:
        train = cam_infos
        test = [c for i, c in enumerate(cam_infos) if (i // mod) in val]

    norm = get_nerfpp_norm(train)
    norm["radius"] = 1

    ply_path = os.path.join(args.model_path, "points3d.ply")
    if not args.test_only:
        rgbs = (np.random.random((pointcloud.shape[0], 3)) * 255).astype(np.uint8)
        store_points_ply(ply_path, pointcloud, rgbs, pc_time)
    pts, colors, normals, time = fetch_points_ply(ply_path)

    return SceneInfo(point_cloud=(pts, colors, normals, time),
                     train_cameras=train, test_cameras=test,
                     nerf_normalization=norm, ply_path=ply_path,
                     time_interval=(time_duration[1] - time_duration[0])
                     / max(frames - 1, 1),
                     time_duration=tuple(time_duration))
