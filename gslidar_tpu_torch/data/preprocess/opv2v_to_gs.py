#!/usr/bin/env python
"""Offline OPV2V preprocessing: per-vehicle yaml lidar_pose -> transforms json
(the port's copy of gslidar_tpu/data/preprocess/opv2v_to_gs.py).

Reference: preprocess/opv2v_to_gs.py. Walks {base}/test/{scenario}/{vehicle}
frame yamls and writes {base}/test_transform/{scenario}/
transforms_{scenario}_{vehicle}.json with 4x4 lidar2world per frame.

Usage: python -m gslidar_tpu_torch.data.preprocess.opv2v_to_gs --base data/opv2v
"""

from __future__ import annotations

import argparse
import json
import os
import re

import yaml

from gslidar_tpu_torch.data.opv2v import get_c2w_matrix


def main(base_dir, mode="test", mode_transform="test_transform"):
    os.makedirs(os.path.join(base_dir, mode_transform), exist_ok=True)
    for scenario in os.listdir(os.path.join(base_dir, mode)):
        scen_dir = os.path.join(base_dir, mode, scenario)
        if not os.path.isdir(scen_dir):
            continue
        os.makedirs(os.path.join(base_dir, mode_transform, scenario),
                    exist_ok=True)
        for vehicle in os.listdir(scen_dir):
            veh_dir = os.path.join(scen_dir, vehicle)
            if vehicle.endswith(".yaml") or not os.path.isdir(veh_dir):
                continue
            frames = []
            names = sorted(
                (n for n in os.listdir(veh_dir) if n.endswith(".yaml")),
                key=lambda x: int(re.search(r"\d+", x).group()))
            for name in names:
                with open(os.path.join(veh_dir, name)) as f:
                    calib = yaml.safe_load(f)
                frames.append({
                    "idx": int(name.replace(".yaml", "")),
                    "lidar2world": get_c2w_matrix(calib).tolist(),
                })
            path = os.path.join(base_dir, mode_transform, scenario,
                                f"transforms_{scenario}_{vehicle}.json")
            with open(path, "w") as f:
                json.dump({"frames": frames}, f, indent=2)
            print(f"Saved {path}")
        print(f"Processed scene {scenario}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--base", type=str, default="data/opv2v")
    a = p.parse_args()
    main(a.base)
