"""BENCHMARK.json names only what the harness can find: every cell's
configuration, traffic mix, limits and its traffic's kind, and every
metric's reader."""

import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def test_every_name_has_its_file():
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert json.load(open(os.path.join(ROOT, c["file"])))["reduced"] \
            == c["reduced"]
    for w in spec["workloads"]:
        for sub, name in (("configs", w["config"]),
                          ("traffic", w["traffic"]),
                          ("limits", w["name"])):
            assert os.path.exists(os.path.join(BENCH, sub, f"{name}.json"))
        kind = json.load(open(os.path.join(
            BENCH, "traffic", f"{w['traffic']}.json")))["kind"]
        assert os.path.exists(os.path.join(BENCH, "kinds", f"{kind}.py"))
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           f"{m['name']}.py"))
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
