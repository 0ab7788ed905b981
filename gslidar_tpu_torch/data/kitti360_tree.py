"""A seeded raw KITTI-360 tree, for the parity tests and the on-card smoke
test (no real KITTI-360 sweeps are in the repository).

``write_kitti360_tree`` writes what ``data/preprocess/kitti360_to_gs.py``
and ``data/kitti360.py::read_kitti360_info`` read:

    <root>/KITTI-360/calibration/calib_cam_to_pose.txt   image_00/01: 3x4
    <root>/KITTI-360/calibration/calib_cam_to_velo.txt   3x4
    <root>/KITTI-360/data_poses/<seq>/poses.txt          fid + imu->world 3x4
    <root>/KITTI-360/data_3d_raw/<seq>/velodyne_points/data/%010d.bin
                                    float32 [x, y, z, intensity], sensor frame

The vehicle drives 1.5 m per frame along x with a slow yaw. Each sweep is
``pts_per_sweep`` returns drawn uniformly over the full azimuth, the
elevations -24 to 1.5 degrees and ranges 3 to 50 m, from one seeded stream
(``default_rng(0)``) in frame order. With ``skip_poses`` the frame ids with
``fid % 7 == 3`` have no pose line, so the converter carries the previous
pose forward (preprocess/kitti360_loader.py:316-322 of the reference).

At 2,500 points and with the skips the files are byte for byte those of
the JAX package's raw-format test fixture; at 120,000 points (an HDL-64E
sweep's density) and without them, those of its production-density one.
A 64-frame tree (kitti360_nvs_1908) then holds 7.68M points, a 51-frame
one (kitti360_nvs_10750) 6.12M.

    python -m gslidar_tpu_torch.data.kitti360_tree --seq 1908 --out <root> \\
        [--points 120000] [--no-skips]
    python -m gslidar_tpu_torch.data.preprocess.kitti360_to_gs --seq 1908 \\
        --kitti_root <root>/KITTI-360 --out <root>
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from gslidar_tpu_torch.data.kitti360 import SEQ_TABLE, SEQUENCE_NAME

CAM_TO_POSE = np.array([[1, 0, 0, 0.8],
                        [0, 0, -1, 0.3],
                        [0, 1, 0, -0.7]], float)
CAM_TO_VELO = np.array([[0, 0, 1, 0.26],
                        [-1, 0, 0, 0.11],
                        [0, -1, 0, -0.83]], float)


def sweep(rng, n):
    """``n`` returns in the sensor frame (x forward, z up): full azimuth,
    within the lidar's vertical fov."""
    az = rng.uniform(-np.pi, np.pi, n)
    el = rng.uniform(np.radians(-24.0), np.radians(1.5), n)
    r = rng.uniform(3.0, 50.0, n)
    pts = np.zeros((n, 4), np.float32)
    pts[:, 0] = r * np.cos(el) * np.cos(az)
    pts[:, 1] = r * np.cos(el) * np.sin(az)
    pts[:, 2] = r * np.sin(el)
    pts[:, 3] = rng.uniform(0, 1, n)
    return pts


def write_kitti360_tree(root, s_frame, e_frame, pts_per_sweep=2500,
                        skip_poses=True):
    """Write the raw tree for frames ``s_frame`` .. ``e_frame`` under
    ``root``; returns (the KITTI-360 directory, the points written)."""
    rng = np.random.default_rng(0)
    kitti = os.path.join(str(root), "KITTI-360")
    calib = os.path.join(kitti, "calibration")
    poses_dir = os.path.join(kitti, "data_poses", SEQUENCE_NAME)
    lidar_dir = os.path.join(kitti, "data_3d_raw", SEQUENCE_NAME,
                             "velodyne_points", "data")
    for d in (calib, poses_dir, lidar_dir):
        os.makedirs(d, exist_ok=True)

    with open(os.path.join(calib, "calib_cam_to_pose.txt"), "w") as f:
        for cam in ("image_00", "image_01"):
            f.write(cam + ": " + " ".join(map(str, CAM_TO_POSE.ravel()))
                    + "\n")
    with open(os.path.join(calib, "calib_cam_to_velo.txt"), "w") as f:
        f.write(" ".join(map(str, CAM_TO_VELO.ravel())) + "\n")

    with open(os.path.join(poses_dir, "poses.txt"), "w") as f:
        for i, fid in enumerate(range(s_frame, e_frame + 1)):
            if skip_poses and fid % 7 == 3:
                continue
            yaw = 0.004 * i
            c, s = np.cos(yaw), np.sin(yaw)
            m = np.array([[c, -s, 0, 1.5 * i],
                          [s, c, 0, 0.05 * i],
                          [0, 0, 1, 0.0]], float)
            f.write(str(fid) + " " + " ".join(map(str, m.ravel())) + "\n")

    for fid in range(s_frame, e_frame + 1):
        sweep(rng, pts_per_sweep).tofile(
            os.path.join(lidar_dir, "%010d.bin" % fid))
    return kitti, pts_per_sweep * (e_frame + 1 - s_frame)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seq", default="1908", choices=sorted(SEQ_TABLE))
    p.add_argument("--out", required=True)
    p.add_argument("--points", type=int, default=2500,
                   help="returns per sweep (120000 for an HDL-64E's)")
    p.add_argument("--no-skips", action="store_true",
                   help="a pose line for every frame id")
    a = p.parse_args(argv)
    s_frame, e_frame, _ = SEQ_TABLE[a.seq]
    kitti, n = write_kitti360_tree(a.out, s_frame, e_frame, a.points,
                                   not a.no_skips)
    print(f"wrote {n} points in {e_frame + 1 - s_frame} sweeps under "
          f"{kitti}")


if __name__ == "__main__":
    main()
