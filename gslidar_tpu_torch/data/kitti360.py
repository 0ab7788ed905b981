"""KITTI-360 runtime loader (the port's copy of
gslidar_tpu/data/kitti360.py).

Reference: scene/kitti360_loader.py. Reads per-frame velodyne sweeps,
transforms them to world via the preprocessed ``transforms_{seq}_all.json``,
builds two panoramic cameras per frame (forward + backward), PCA-normalizes
the pose trajectory, and returns a SceneInfo.
"""

from __future__ import annotations

import json
import os

import numpy as np

from gslidar_tpu_torch.data.cameras import (CameraInfo, SceneInfo,
                                            get_nerfpp_norm)
from gslidar_tpu_torch.utils.ply import fetch_points_ply, store_points_ply

SEQUENCE_NAME = "2013_05_28_drive_0000_sync"

# sequence windows + val frames (reference kitti360_loader.py:117-163)
SEQ_TABLE = {
    "1538": (1538, 1601, [1551, 1564, 1577, 1590]),
    "1728": (1728, 1791, [1741, 1754, 1767, 1780]),
    "1908": (1908, 1971, [1921, 1934, 1947, 1960]),
    "3353": (3353, 3416, [3366, 3379, 3392, 3405]),
    "2350": (2350, 2400, [2360, 2370, 2380, 2390]),
    "4950": (4950, 5000, [4960, 4970, 4980, 4990]),
    "8120": (8120, 8170, [8130, 8140, 8150, 8160]),
    "10200": (10200, 10250, [10210, 10220, 10230, 10240]),
    "10750": (10750, 10800, [10760, 10770, 10780, 10790]),
    "11400": (11400, 11450, [11410, 11420, 11430, 11440]),
}

# world->cam axis permutation for the forward pano camera
# (reference kitti360_loader.py:201-204)
W2L_AXES = np.array([0, -1, 0, 0,
                     0, 0, -1, 0,
                     1, 0, 0, 0,
                     0, 0, 0, 1], dtype=np.float64).reshape(4, 4)
BACK_FLIP_R = np.diag([-1.0, 1.0, -1.0])


def pad_poses(p):
    bottom = np.broadcast_to([0, 0, 0, 1.0], p[..., :1, :4].shape)
    return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def unpad_poses(p):
    return p[..., :3, :4]


def transform_poses_pca(poses, fix_scale_factor=True):
    """PCA pose normalization (reference kitti360_loader.py:60-101)."""
    t = poses[:, :3, 3]
    t_mean = t.mean(axis=0)
    t = t - t_mean
    eigval, eigvec = np.linalg.eig(t.T @ t)
    inds = np.argsort(eigval)[::-1]
    eigvec = eigvec[:, inds]
    rot = eigvec.T
    if np.linalg.det(rot) < 0:
        rot = np.diag(np.array([1, 1, -1])) @ rot
    transform = np.concatenate([rot, rot @ -t_mean[:, None]], -1)
    poses_recentered = unpad_poses(transform @ pad_poses(poses))
    transform = np.concatenate([transform, np.eye(4)[3:]], axis=0)
    if poses_recentered.mean(axis=0)[2, 1] < 0:
        poses_recentered = np.diag(np.array([1, -1, -1])) @ poses_recentered
        transform = np.diag(np.array([1, -1, -1, 1])) @ transform
    if fix_scale_factor:
        scale_factor = 1 / 10
    else:
        scale_factor = 1.0 / (np.max(np.abs(poses_recentered[:, :3, 3])) + 1e-5)
        scale_factor = min(1 / 10, scale_factor)
    poses_recentered[:, :3, 3] *= scale_factor
    transform = np.diag(np.array([scale_factor] * 3 + [1])) @ transform
    return poses_recentered, transform, scale_factor


def make_frame_cameras(points_world, intensity, lidar2world, frame_uid,
                       n_frames, timestamp, sequence_id="default"):
    """Two pano cameras (forward/backward) for one sweep
    (reference kitti360_loader.py:200-222)."""
    w2l = W2L_AXES @ np.linalg.inv(lidar2world)
    R = np.transpose(w2l[:3, :3])
    T = w2l[:3, 3]
    pts_cam = points_world @ R + T
    front = CameraInfo(uid=frame_uid, R=R.copy(), T=T.copy(),
                       timestamp=timestamp, pointcloud_camera=pts_cam,
                       intensity=intensity, towards="forward",
                       sequence_id=sequence_id)
    R_back = R @ BACK_FLIP_R
    T_back = T * np.array([-1, 1, -1])
    pts_cam_back = points_world @ R_back + T_back
    back = CameraInfo(uid=frame_uid + n_frames, R=R_back, T=T_back,
                      timestamp=timestamp, pointcloud_camera=pts_cam_back,
                      intensity=intensity, towards="backward",
                      sequence_id=sequence_id)
    return front, back


def apply_pose_normalization(cam_infos, pointcloud, args):
    """PCA-normalize all camera poses + the point cloud in place; returns
    scale_factor (persisted like the reference, kitti360_loader.py:236-263)."""
    w2cs = np.zeros((len(cam_infos), 4, 4))
    Rs = np.stack([c.R for c in cam_infos], axis=0)
    Ts = np.stack([c.T for c in cam_infos], axis=0)
    w2cs[:, :3, :3] = Rs.transpose((0, 2, 1))
    w2cs[:, :3, 3] = Ts
    w2cs[:, 3, 3] = 1
    c2ws = unpad_poses(np.linalg.inv(w2cs))

    npz_path = os.path.join(args.model_path, "transform_poses_pca.npz")
    if not args.test_only:
        c2ws, transform, scale_factor = transform_poses_pca(c2ws, args.dynamic)
        np.savez(npz_path, transform=transform, scale_factor=scale_factor)
        c2ws = pad_poses(c2ws)
    else:
        data = np.load(npz_path)
        transform = data["transform"]
        scale_factor = data["scale_factor"].item()
        c2ws = np.diag([1 / scale_factor] * 3 + [1]) @ transform @ pad_poses(c2ws)
        c2ws[:, :3, 3] *= scale_factor

    for idx, cam in enumerate(cam_infos):
        w2c = np.linalg.inv(c2ws[idx])
        cam.R[:] = np.transpose(w2c[:3, :3])
        cam.T[:] = w2c[:3, 3]
        cam.pointcloud_camera[:] *= scale_factor

    pointcloud = (np.pad(pointcloud, ((0, 0), (0, 1)), constant_values=1)
                  @ transform.T)[:, :3]
    return pointcloud, float(scale_factor)


def read_kitti360_info(args) -> SceneInfo:
    path = args.source_path
    num_pts = args.num_pts
    time_duration = args.time_duration
    assert args.vfov is not None and args.hfov is not None

    sequence_id = str(args.sequence_id)
    if sequence_id not in SEQ_TABLE:
        raise ValueError(f"Invalid sequence id: {sequence_id}")
    s_frame, e_frame, val_frames = SEQ_TABLE[sequence_id]

    with open(os.path.join(path, sequence_id,
                           f"transforms_{sequence_id}_all.json")) as f:
        poses = json.load(f)["frames"]

    frames = e_frame + 1 - s_frame
    args.frames = frames
    lidar_dir = os.path.join(path, "KITTI-360", "data_3d_raw", SEQUENCE_NAME,
                             "velodyne_points", "data")

    from gslidar_tpu_torch.native import get_native
    nat = get_native()

    point_list, points_time, cam_infos = [], [], []
    for frame_idx in range(frames):
        lidar_idx = frame_idx + s_frame
        bin_path = os.path.join(lidar_dir, "%010d.bin" % lidar_idx)
        if nat is not None:
            raw = nat.read_velodyne(bin_path)
        else:
            raw = np.fromfile(bin_path, dtype=np.float32).reshape(-1, 4)
        intensity = raw[:, 3]
        points = raw[:, :3]
        keep = np.linalg.norm(points, axis=1) > 2.5   # drop ego returns
        points, intensity = points[keep], intensity[keep]

        lidar2world = np.array(poses[frame_idx]["lidar2world"])
        points_h = np.concatenate([points, np.ones_like(points[:, :1])], -1)
        points_w = (points_h @ lidar2world.T)[:, :3]
        point_list.append(points_w)

        timestamp = time_duration[0] + (time_duration[1] - time_duration[0]) \
            * frame_idx / (frames - 1)
        points_time.append(np.full_like(points_w[:, :1], timestamp))

        front, back = make_frame_cameras(points_w, intensity, lidar2world,
                                         frame_idx, frames, timestamp)
        cam_infos += [front, back]

        if args.debug_cuda and frame_idx >= 15:
            break

    pointcloud = np.concatenate(point_list, axis=0)
    pc_time = np.concatenate(points_time, axis=0)
    num_pts = min(num_pts, pointcloud.shape[0])
    sel = np.random.choice(pointcloud.shape[0], num_pts, replace=False)
    pointcloud, pc_time = pointcloud[sel], pc_time[sel]

    pointcloud, scale_factor = apply_pose_normalization(cam_infos, pointcloud,
                                                        args)
    args.scale_factor = scale_factor

    mod = args.cam_num
    if args.eval:
        train = [c for i, c in enumerate(cam_infos)
                 if (i // mod + s_frame) not in val_frames]
        test = [c for i, c in enumerate(cam_infos)
                if (i // mod + s_frame) in val_frames]
    else:
        train = cam_infos
        test = [c for i, c in enumerate(cam_infos)
                if (i // mod + s_frame) in val_frames]

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
                     / (frames - 1),
                     time_duration=tuple(time_duration))
