"""The controls of the correctness check: the reference put in the
program's place, run wrong on purpose, and read against the reference.

Each kind names its controls (``CONTROLS`` in ``kinds/<kind>.py``) and
runs them (``control``). Each prints the numbers the cell compares; a
limit must lie below what they read.
"""

from __future__ import annotations


def run_control(spec, workload: str, seed: int, control: str, device):
    from benchmark.run import load_json, load_kind
    cellspec = next(w for w in spec["workloads"] if w["name"] == workload)
    config = load_json("configs", f"{cellspec['config']}.json")
    traffic = load_json("traffic", f"{cellspec['traffic']}.json")
    kind = load_kind(traffic["kind"])
    if control not in kind.CONTROLS:
        raise ValueError(f"the {traffic['kind']!r} kind has no control "
                         f"{control!r}; its controls: {kind.CONTROLS}")
    return {"control": control, "workload": workload, "seed": seed,
            "numbers": kind.control(control, config, traffic, seed, device),
            "limits": {
                k: v["limit"] for k, v in
                load_json("limits", f"{workload}.json")["limits"].items()}}
