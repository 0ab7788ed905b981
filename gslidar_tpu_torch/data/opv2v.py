"""OPV2V multi-vehicle loader + spoof-attack variant (the port's copy of
gslidar_tpu/data/opv2v.py, same names and semantics).

Reference: scene/opv2v_loader.py. Two entry points:

* ``read_opv2v_info`` — reads per-vehicle sweeps + transforms json; the
  wildcard sequence_id ("all"/"*") merges every vehicle's sweeps and
  cameras (multi-agent scene).
* ``read_opv2v_info_spoof_remove`` — pulls per-attack point clouds from
  the external ``AdvCollaborativePerception.GeneralAttacker`` sibling repo
  with per-attack-id XY offsets; the external import is optional and
  resolved lazily exactly like the reference
  (scene/opv2v_loader.py:24-26,134-174).
"""

from __future__ import annotations

import glob
import json
import os
import sys

import numpy as np

from gslidar_tpu_torch.data.cameras import SceneInfo, get_nerfpp_norm
from gslidar_tpu_torch.data.kitti360 import (apply_pose_normalization,
                                             make_frame_cameras)
from gslidar_tpu_torch.utils.ply import fetch_points_ply, store_points_ply


def rotation_matrix(roll, yaw, pitch):
    """Euler (roll, yaw, pitch) -> R (reference opv2v_loader.py:29-38)."""
    return np.array([
        [np.cos(yaw) * np.cos(pitch),
         np.cos(yaw) * np.sin(pitch) * np.sin(roll) - np.sin(yaw) * np.cos(roll),
         np.cos(yaw) * np.sin(pitch) * np.cos(roll) + np.sin(yaw) * np.sin(roll)],
        [np.sin(yaw) * np.cos(pitch),
         np.sin(yaw) * np.sin(pitch) * np.sin(roll) + np.cos(yaw) * np.cos(roll),
         np.sin(yaw) * np.sin(pitch) * np.cos(roll) - np.cos(yaw) * np.sin(roll)],
        [-np.sin(pitch),
         np.cos(pitch) * np.sin(roll),
         np.cos(pitch) * np.cos(roll)]])


def get_c2w_matrix(calib):
    """lidar_pose [x y z roll yaw pitch] (deg) -> 4x4 lidar->world
    (reference opv2v_loader.py:41-51)."""
    R = rotation_matrix(*(np.array(calib["lidar_pose"][3:]) * np.pi / 180))
    c2w = np.eye(4)
    c2w[:3, :3] = R
    c2w[:3, 3] = np.array(calib["lidar_pose"][:3])
    return c2w


def subsample_pointcloud(points, M, alpha=0.0005, rng=None):
    """Grid-uniform density subsample (reference utils/camera_utils.py:17-95),
    vectorized: bucket points into alpha*diameter cells, take ~M/num_cells
    per cell via per-cell random ranking."""
    if points.shape[0] <= M:
        return np.arange(points.shape[0])
    rng = rng or np.random.default_rng(0)
    mins = points.min(0)
    maxs = points.max(0)
    diameter = np.linalg.norm(maxs - mins)
    cell = alpha * diameter
    idx3 = np.floor((points - mins) / cell).astype(np.int64)
    dims = idx3.max(0) + 1
    flat = (idx3[:, 0] * dims[1] + idx3[:, 1]) * dims[2] + idx3[:, 2]
    # rank within cell by random priority: sort by (cell, random)
    pri = rng.random(points.shape[0])
    order = np.lexsort((pri, flat))
    flat_s = flat[order]
    first = np.ones(len(flat_s), bool)
    first[1:] = flat_s[1:] != flat_s[:-1]
    cell_start_of = np.maximum.accumulate(np.where(first, np.arange(len(flat_s)), 0))
    rank = np.arange(len(flat_s)) - cell_start_of
    num_cells = int(first.sum())
    per_cell = max(1, int(np.ceil(M / num_cells)))
    keep_sorted = order[rank < per_cell]
    if len(keep_sorted) > M:
        keep_sorted = rng.choice(keep_sorted, M, replace=False)
    return keep_sorted


def _parse_one_car_files(path, mode, mode_transform, scenario, sequence_id,
                         s_frame, stride, frames, time_duration,
                         debug_cuda=False):
    """Per-vehicle sweep parsing from .bin files
    (reference opv2v_loader.py:372-447)."""
    with open(os.path.join(path, mode_transform, scenario,
                           f"transforms_{scenario}_{sequence_id}.json")) as f:
        poses = json.load(f)["frames"]
    lidar_dir = os.path.join(path, mode, scenario, sequence_id)

    point_list, points_time, cam_infos = [], [], []
    for frame_idx in range(frames):
        lidar_idx = frame_idx * stride + s_frame
        raw = np.fromfile(os.path.join(lidar_dir, "%06d.bin" % lidar_idx),
                          dtype=np.float32).reshape(-1, 4)
        intensity = raw[:, 3]
        points = raw[:, :3]
        keep = np.linalg.norm(points, axis=1) > 2.5
        points, intensity = points[keep], intensity[keep]

        l2w = np.array(poses[frame_idx]["lidar2world"])
        pts_w = (np.concatenate([points, np.ones_like(points[:, :1])], -1)
                 @ l2w.T)[:, :3]
        point_list.append(pts_w)
        timestamp = time_duration[0] + (time_duration[1] - time_duration[0]) \
            * frame_idx / (frames - 1)
        points_time.append(np.full_like(pts_w[:, :1], timestamp))
        front, back = make_frame_cameras(pts_w, intensity, l2w, frame_idx,
                                         frames, timestamp, str(sequence_id))
        cam_infos += [front, back]
        if debug_cuda and frame_idx >= 15:
            break
    return (np.concatenate(point_list, 0), np.concatenate(points_time, 0),
            cam_infos)


def _finalize_scene(args, pointcloud, pc_time, cam_infos, s_frame,
                    frames, time_duration):
    """Shared tail: subsample, PCA-normalize, split, persist
    (reference opv2v_loader.py:477-535)."""
    num_pts = min(args.num_pts, pointcloud.shape[0])
    sel = subsample_pointcloud(pointcloud, num_pts)
    pointcloud, pc_time = pointcloud[sel], pc_time[sel]

    pointcloud, scale_factor = apply_pose_normalization(cam_infos, pointcloud,
                                                        args)
    args.scale_factor = scale_factor

    mod = args.cam_num
    val_frames = list(args.val_frames)
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
                     / max(frames - 1, 1),
                     time_duration=tuple(time_duration))


WILD_CARDS = ("*", "all")


def read_opv2v_info(args) -> SceneInfo:
    """Reference readOPV2VInfo (opv2v_loader.py:347-535)."""
    path = args.source_path
    time_duration = args.time_duration
    mode, mode_transform = "test", "test_transform"
    assert args.vfov is not None and args.hfov is not None
    scenario = args.scenario
    assert scenario is not None, "Please specify the scenario name."
    sequence_id = args.sequence_id
    assert sequence_id is not None, "Please specify the sequence id."

    s_frame, e_frame = args.frame_start, args.frame_end
    stride = args.frame_stride
    frames = (e_frame - s_frame) // stride + 1
    args.frames = frames

    if str(sequence_id) not in WILD_CARDS:
        pc, pt, cams = _parse_one_car_files(
            path, mode, mode_transform, scenario, sequence_id, s_frame,
            stride, frames, time_duration, args.debug_cuda)
        pcs, pts_t, cam_infos = [pc], [pt], cams
    else:
        pcs, pts_t, cam_infos = [], [], []
        for sub in sorted(glob.glob(os.path.join(path, mode, scenario, "*"))):
            if not os.path.isdir(sub):
                continue
            pc, pt, cams = _parse_one_car_files(
                path, mode, mode_transform, scenario, os.path.basename(sub),
                s_frame, stride, frames, time_duration, args.debug_cuda)
            pcs.append(pc)
            pts_t.append(pt)
            cam_infos.extend(cams)
    pointcloud = np.concatenate(pcs, 0)
    pc_time = np.concatenate(pts_t, 0)
    return _finalize_scene(args, pointcloud, pc_time, cam_infos, s_frame,
                           frames, time_duration)


def load_spoof_offsets(offset_file, attack_id):
    """Per-attack XY offset lookup (reference opv2v_loader.py:137-160)."""
    try:
        arr = np.load(offset_file)
        if arr.shape != (300, 2):
            arr = np.zeros((300, 2))
    except Exception:
        arr = np.zeros((300, 2))
    if not (0 <= attack_id < 300):
        return [0.0, 0.0]
    return arr[attack_id].tolist()


def get_general_attacker():
    """Import the external AdvCollaborativePerception sibling repo
    (reference opv2v_loader.py:24-26)."""
    sys.path.append(os.path.abspath(os.path.join(
        os.path.dirname(__file__), "..", "..", "..",
        "AdvCollaborativePerception")))
    from attack import GeneralAttacker   # external dependency
    return GeneralAttacker()


def read_opv2v_info_spoof_remove(args) -> SceneInfo:
    """Reference readOPV2VInfo_Spoof_Remove (opv2v_loader.py:134-344):
    scene data comes from the attack generator instead of disk."""
    ga = get_general_attacker()
    current_offset = load_spoof_offsets(args.spoof_offset, args.attack_id)
    print(f"Using offset for attack {args.attack_id}: "
          f"[{current_offset[0]:.2f}, {current_offset[1]:.2f}]")

    time_duration = args.time_duration
    normal_lidar, attack_lidar, general_info, attack_info = ga.attack(
        attacker_type=args.attacker_type,
        dense=args.dense,
        sync=args.sync,
        advshape=args.advshape,
        attack_id=args.attack_id,
        attack_frame_ids=args.attack_frame_ids,
        offset=current_offset)

    assert args.vfov is not None and args.hfov is not None
    frame_ids = general_info["frame_ids"]
    frames = len(frame_ids)
    s_frame = frame_ids[0]
    args.frame_start = s_frame
    args.frames = frames
    cars = general_info["vehicle_ids"]

    def parse_one_car(sequence_id):
        point_list, points_time, cam_infos = [], [], []
        for frame_idx in range(frames):
            rec = attack_lidar[frame_idx][sequence_id]
            points = rec["lidar"]
            points[:, 3] = 1.0           # default intensity (reference :404)
            intensity = points[:, 3]
            points = points[:, :3]
            keep = np.linalg.norm(points, axis=1) > 2.5
            points, intensity = points[keep], intensity[keep]
            l2w = get_c2w_matrix(rec)
            pts_w = (np.concatenate([points, np.ones_like(points[:, :1])], -1)
                     @ l2w.T)[:, :3]
            point_list.append(pts_w)
            timestamp = time_duration[0] + (time_duration[1] - time_duration[0]) \
                * frame_idx / (frames - 1)
            points_time.append(np.full_like(pts_w[:, :1], timestamp))
            front, back = make_frame_cameras(pts_w, intensity, l2w, frame_idx,
                                             frames, timestamp,
                                             str(sequence_id))
            cam_infos += [front, back]
        return (np.concatenate(point_list, 0), np.concatenate(points_time, 0),
                cam_infos)

    if str(args.sequence_id) not in WILD_CARDS:
        pc, pt, cam_infos = parse_one_car(args.sequence_id)
        pcs, pts_t = [pc], [pt]
    else:
        pcs, pts_t, cam_infos = [], [], []
        for sequence_id in cars:
            pc, pt, cams = parse_one_car(sequence_id)
            pcs.append(pc)
            pts_t.append(pt)
            cam_infos.extend(cams)
    pointcloud = np.concatenate(pcs, 0)
    pc_time = np.concatenate(pts_t, 0)
    return _finalize_scene(args, pointcloud, pc_time, cam_infos, s_frame,
                           frames, time_duration)
