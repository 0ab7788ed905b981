#!/usr/bin/env python
"""Offline KITTI-360 preprocessing: emit transforms_{seq}_all.json (the
port's copy of gslidar_tpu/data/preprocess/kitti360_to_gs.py).

Reference: preprocess/kitti360_to_gs.py + preprocess/kitti360_loader.py
(KITTI360Loader.load_lidars). Reads the raw KITTI-360 calibration + pose
files and composes per-frame velodyne->world matrices:

    velo_to_world = imu_to_world @ cam00_to_imu @ inv(cam00_to_velo)

Frames absent from poses.txt reuse the most recent earlier pose
(preprocess/kitti360_loader.py:316-322). Pure numpy (no camtools).

Usage: python -m gslidar_tpu_torch.data.preprocess.kitti360_to_gs --seq 1908 \
           --kitti_root data/kitti360/KITTI-360 --out data/kitti360
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from gslidar_tpu_torch.data.kitti360 import SEQ_TABLE, SEQUENCE_NAME


def pad_0001(m):
    out = np.eye(4)
    out[:3, :4] = m[:3, :4]
    return out


def read_named_matrix(path, name, rows, cols):
    """Read 'name: v v v ...' lines (calib_cam_to_pose.txt format,
    kitti360 devkit loadCalibration convention)."""
    with open(path) as f:
        for line in f:
            if line.startswith(name):
                vals = [float(x) for x in line.split(":", 1)[1].split()]
                return np.array(vals).reshape(rows, cols)
    raise KeyError(f"{name} not found in {path}")


def load_velo_to_world(kitti_root, sequence_name, frame_ids):
    data_poses = os.path.join(kitti_root, "data_poses", f"{sequence_name}_sync")
    calib_dir = os.path.join(kitti_root, "calibration")

    imu_to_world = {}
    ordered = []
    for line in np.loadtxt(os.path.join(data_poses, "poses.txt")):
        fid = int(line[0])
        ordered.append(fid)
        imu_to_world[fid] = line[1:].reshape(3, 4)

    cam00_to_imu = pad_0001(read_named_matrix(
        os.path.join(calib_dir, "calib_cam_to_pose.txt"), "image_00", 3, 4))
    with open(os.path.join(calib_dir, "calib_cam_to_velo.txt")) as f:
        cam00_to_velo = pad_0001(
            np.array([float(x) for x in f.readline().split()]).reshape(3, 4))

    velo_to_world = {}
    for fid in ordered:
        cam00_to_world_unrec = pad_0001(imu_to_world[fid]) @ cam00_to_imu
        velo_to_world[fid] = cam00_to_world_unrec @ np.linalg.inv(cam00_to_velo)

    out = []
    last = None
    for fid in frame_ids:
        if fid in velo_to_world:
            last = velo_to_world[fid]
        if last is None:
            # frame before the first pose: borrow the first available
            last = velo_to_world[ordered[0]]
        out.append(last)
    return out


def main(seq, kitti_root, out_dir):
    if seq not in SEQ_TABLE:
        raise ValueError(f"Invalid sequence id: {seq}")
    s_frame, e_frame, _val = SEQ_TABLE[seq]
    frame_ids = list(range(s_frame, e_frame + 1))

    mats = load_velo_to_world(kitti_root, SEQUENCE_NAME.replace("_sync", ""),
                              frame_ids)
    json_dict = {
        "w_lidar": 1030,
        "h_lidar": 66,
        "aabb_scale": 2,
        "frames": [{"idx": fid, "lidar2world": m.tolist()}
                   for fid, m in zip(frame_ids, mats)],
    }
    os.makedirs(os.path.join(out_dir, seq), exist_ok=True)
    path = os.path.join(out_dir, seq, f"transforms_{seq}_all.json")
    with open(path, "w") as f:
        json.dump(json_dict, f, indent=2)
    print(f"Saved {path}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--seq", type=str, default="1908")
    p.add_argument("--kitti_root", type=str,
                   default="data/kitti360/KITTI-360")
    p.add_argument("--out", type=str, default="data/kitti360")
    a = p.parse_args()
    main(a.seq, a.kitti_root, a.out)
