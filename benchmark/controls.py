"""The controls of the correctness check: the reference put in the
program's place, run wrong on purpose, and read against the reference.

``bf16`` computes the reference with its parameters and the compositor's
rows in bfloat16, the nearest precision below the configuration's
float32 (a tempting step: the JAX package had a bfloat16 payload switch).
``half_view`` leaves the lower half of each view out of the
losses, whose masked means are then taken over the rest. Each prints the
numbers the cell compares; a limit must lie below what they read.
"""

from __future__ import annotations

import itertools

import torch

from benchmark import checks
from benchmark import traffic as TR


def run_control(spec, workload: str, seed: int, control: str, device):
    from benchmark.run import load_json
    cellspec = next(w for w in spec["workloads"] if w["name"] == workload)
    config = load_json("configs", f"{cellspec['config']}.json")
    traffic = load_json("traffic", f"{cellspec['traffic']}.json")
    lowered = torch.bfloat16 if control == "bf16" else None
    fault = "half_view" if control == "half_view" else None
    first, last = config["frames"]
    n_cams = 2 * (last - first + 1 - len(config["val_frames"]))
    calls = list(itertools.islice(
        TR.train_stream(traffic, config, seed, n_cams),
        int(traffic["checked_steps"])))
    ref = checks.reference_train(config, traffic, seed, calls, device)
    low = checks.reference_train(config, traffic, seed, calls, device,
                                 lowered=lowered, fault=fault)
    per_group = {}
    numbers = checks.train_numbers(low, ref, device, per_group)
    numbers["loss_gap_of_each_step"] = checks.step_loss_gaps(low, ref)
    numbers["descent_gap_of_each_group"] = per_group
    return {"control": control, "workload": workload, "seed": seed,
            "numbers": numbers, "limits": {
                k: v["limit"] for k, v in
                load_json("limits", f"{workload}.json")["limits"].items()}}
