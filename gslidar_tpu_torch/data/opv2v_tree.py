"""A seeded synthetic OPV2V tree, for the parity tests and the on-card
smoke test (no real OPV2V sweeps are in the repository).

``write_opv2v_tree`` writes what ``data/opv2v.py::_parse_one_car_files``
and ``data/preprocess/opv2v_to_gs.py`` read:

    <root>/test/<scenario>/<vehicle>/%06d.bin   float32 [x, y, z, intensity]
                                                in the vehicle's lidar frame
    <root>/test/<scenario>/<vehicle>/%06d.yaml  lidar_pose: [x, y, z, roll,
                                                yaw, pitch] (meters, degrees)

Each vehicle drives its own path through ``data/synthetic.py``'s
procedural street (ground, two walls, six boxes). Its sweep at a frame is
``_simulate_sweep``'s nearest return per (azimuth, elevation) bin, over the
street and the other vehicles' bodies where they are at that frame, so the
scene is dynamic, with Gaussian range noise (a real sensor's ~2 cm). Then
``opv2v_to_gs.main(root)`` makes the transforms JSONs the loader reads.

The full-width tree (3 vehicles x 17 frames, 128 x 2048 rays over
opv2v_dynamic_2's vfov) holds ~7.7M points, of which the loader's grid
subsample (``subsample_pointcloud``: at most ceil(M / cells) per cell of
1/2000 of the cloud's diameter) keeps the config's 3,000,000. At 64 x
2048 rays, or without the noise, the returns lie on too few cells and
it keeps ~2.3M.
"""

from __future__ import annotations

import os

import numpy as np

from gslidar_tpu_torch.data.synthetic import (_simulate_sweep,
                                              _world_surface_points)

SCENARIO = "2021_08_18_19_48_05"      # configs/opv2v_dynamic_2.yaml
VEHICLES = ("641", "650", "659")
LIDAR_Z = 1.8
BODY = (4.5, 2.0, 1.6)                # a car's length, width, height (m)


def vehicle_pose(k: int, i: int):
    """lidar_pose [x, y, z, roll, yaw, pitch] (degrees) of vehicle ``k``
    at its ``i``-th frame: three lanes of the street, the middle one
    driven the other way, the third weaving."""
    lane = k % 3
    if lane == 0:
        return [2.0 * i, -5.0, LIDAR_Z, 0.0, 0.0, 0.0]
    if lane == 1:
        return [40.0 - 2.0 * i, 5.0, LIDAR_Z, 0.0, 180.0, 0.0]
    return [-10.0 + 1.5 * i, 0.5 * np.sin(0.4 * i), LIDAR_Z, 0.0,
            8.0 * np.cos(0.4 * i), 0.0]


def _body_points(rng, pose, n):
    """``n`` points on the surface of a car's box at ``pose`` (its lidar
    on the roof's center)."""
    L, W, H = BODY
    u = rng.uniform(-0.5, 0.5, (n, 3)) * [L, W, H]
    face = rng.integers(0, 3, n)
    u[np.arange(n), face] = np.sign(u[np.arange(n), face]) * \
        np.array([L, W, H])[face] / 2
    yaw = np.deg2rad(pose[4])
    c, s = np.cos(yaw), np.sin(yaw)
    x = pose[0] + c * u[:, 0] - s * u[:, 1]
    y = pose[1] + s * u[:, 0] + c * u[:, 1]
    return np.stack([x, y, u[:, 2] + H / 2], 1)


def write_opv2v_tree(root, frame_ids, vehicles=VEHICLES, scenario=SCENARIO,
                     n_el=128, n_az=2048, vfov=(-25.0, 2.0),
                     world_n=600_000, body_n=20_000, range_noise=0.02,
                     seed=0) -> int:
    """Write the tree of ``vehicles`` over ``frame_ids`` under ``root``;
    returns the points written (all beyond the loader's 2.5 m cut)."""
    from gslidar_tpu_torch.data.opv2v import rotation_matrix
    rng = np.random.default_rng(seed)
    street = _world_surface_points(rng, world_n)
    poses = {(k, i): vehicle_pose(k, i) for k in range(len(vehicles))
             for i in range(len(frame_ids))}
    bodies = {key: _body_points(rng, pose, body_n)
              for key, pose in poses.items()}
    total = 0
    for k, veh in enumerate(vehicles):
        veh_dir = os.path.join(root, "test", scenario, veh)
        os.makedirs(veh_dir, exist_ok=True)
        for i, fid in enumerate(frame_ids):
            pose = poses[(k, i)]
            others = [bodies[(j, i)] for j in range(len(vehicles)) if j != k]
            rel, inten = _simulate_sweep(np.concatenate([street, *others]),
                                         np.asarray(pose[:3]), vfov,
                                         (-180, 180), n_az=n_az, n_el=n_el)
            r = np.linalg.norm(rel, axis=1, keepdims=True)
            rel = rel * (1 + range_noise * rng.standard_normal(r.shape) / r)
            keep = np.linalg.norm(rel, axis=1) > 2.5
            R = rotation_matrix(*np.deg2rad(pose[3:]))
            sweep = np.concatenate([rel[keep] @ R, inten[keep, None]], 1)
            sweep.astype(np.float32).tofile(
                os.path.join(veh_dir, "%06d.bin" % fid))
            with open(os.path.join(veh_dir, "%06d.yaml" % fid), "w") as f:
                f.write("lidar_pose: [" + ", ".join(
                    repr(float(v)) for v in pose) + "]\n")
            total += len(sweep)
    return total
