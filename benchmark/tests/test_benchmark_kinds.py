"""A cell's kind is files: ``kinds/<kind>.py``, found by the traffic
mix's ``kind`` through the same directory as the data. A toy kind added
as files of its own runs through the harness unchanged, and the train
kind, moved out of the harness, reads what the harness read before."""

import os
import re

import numpy as np
import pytest
import torch

from tiny_cell import SEED, TOY, run_tiny, tiny_spec

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("correct", "attempted", "failed", "metrics", "device", "checks")


def test_a_kind_added_as_files_runs_through_the_harness(monkeypatch):
    from benchmark import run
    from benchmark.controls import run_control
    assert not os.path.exists(os.path.join(BENCH, "kinds", "toy.py"))
    rc, line = run_tiny("toy_conv", monkeypatch, data=TOY)
    assert run.load_kind("toy").__file__ == os.path.join(TOY, "kinds",
                                                         "toy.py")
    assert rc == 0
    assert list(line) == list(KEYS)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"train_steps_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert list(line["checks"]) == ["loss_gap", "change_gap", "same_inputs"]
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    out = run_control(tiny_spec(TOY), "toy_conv", SEED, "bf16",
                      torch.device("cpu"))
    assert any(out["numbers"][k] > out["limits"][k] for k in out["limits"])


def left_out(numbers, extras):
    numbers.pop("change_gap")
    return numbers, extras


def replaces_calls(numbers, extras):
    return numbers, dict(extras, calls=10 ** 6)


@pytest.mark.parametrize("fault,words", [
    (left_out, "left out ['change_gap']"),
    (replaces_calls, "would replace ['calls']")])
def test_a_kind_whose_check_strays_is_refused(fault, words, monkeypatch):
    """A check that leaves out a number its limits name, or whose extras
    replace what the harness measured, ends the run without a result."""
    import types

    from benchmark import run
    load = run.load_kind

    def strayed(name):
        kind = load(name)

        def check(*a):
            numbers, lines, extras = kind.check(*a)
            numbers, extras = fault(numbers, extras)
            return numbers, lines, extras
        return types.SimpleNamespace(**{**vars(kind), "check": check})
    monkeypatch.setattr(run, "load_kind", strayed)
    with pytest.raises(ValueError, match=re.escape(words)):
        run_tiny("toy_conv", monkeypatch, data=TOY)


def parent_run_cell(spec, workload, seed, seconds, device):
    """A train cell's run as ``run_cell`` made it before the kinds, trace
    off: the cell, the window and the check inline, and the result as the
    parent's readers gave it (a train cell's steps per second and set-up;
    no peak on the CPU). Returns (result, work, the bound's ms)."""
    import time

    from benchmark import checks, run
    from benchmark.counts import composite_bound_ms, step_work
    cellspec = next(w for w in spec["workloads"] if w["name"] == workload)
    config = run.load_json("configs", f"{cellspec['config']}.json")
    traffic = run.load_json("traffic", f"{cellspec['traffic']}.json")
    limits = {k: v["limit"] for k, v in run.load_json(
        "limits", f"{workload}.json")["limits"].items()}
    cell = run.load_kind("train").Cell(config, traffic, seed, device)
    cell.first_steps()
    for _ in range(int(traffic["warmup_steps"])):
        cell.call()
    setup_s = time.perf_counter() - run.T_START
    n, window_s, _ = run.run_window(cell, seconds, device)
    prog_record = cell.record
    cell.free()
    sink = []
    ref = checks.reference_train(config, traffic, seed, prog_record["calls"],
                                 device, sink=sink)
    numbers = checks.train_numbers(prog_record, ref, device, {})
    same = checks.same_params(prog_record["params0"], ref["params0"])
    h, w = config["run"]["hw"]
    work = step_work(prog_record["P"], prog_record["floats_per_gaussian"],
                     h * 2 * w, sink, 16, 16, 4, 4)
    bound_ms = composite_bound_ms(sink, 4, 4, True)
    checked = {k: {"value": v, "limit": limits[k]} for k, v in
               numbers.items()}
    correct = (same and all(np.isfinite(c["value"])
                            and c["value"] <= c["limit"]
                            for c in checked.values()))
    checked["same_inputs"] = {"value": 0 if same else 1, "limit": 0}
    result = {"correct": correct, "attempted": n, "failed": 0,
              "metrics": {"train_steps_per_s": n / window_s,
                          "setup_s": setup_s},
              "device": {"platform": "cpu", "kind": "cpu", "count": 1,
                         "memory_peak_bytes": 0},
              "checks": checked}
    return result, work, bound_ms


def test_the_train_kind_reads_as_the_harness_did_before(monkeypatch):
    from benchmark import run
    from tiny_cell import TINY
    monkeypatch.setattr(run, "DATA_DIR", TINY)
    before, work, bound_ms = parent_run_cell(
        tiny_spec(), "tiny_train", SEED, 0.5, torch.device("cpu"))
    seen = []

    class Seen(run.Context):
        def __init__(self, **kw):
            super().__init__(**kw)
            seen.append(self)
    monkeypatch.setattr(run, "Context", Seen)
    rc, after = run_tiny("tiny_train", monkeypatch)
    assert rc == 0
    assert list(after) == list(before)
    assert set(after["metrics"]) == set(before["metrics"])
    assert after["device"].keys() == before["device"].keys()
    assert after["correct"] is before["correct"] is True
    assert after["checks"] == before["checks"]
    assert seen[0].work == work
    assert seen[0].composite_bwd_bound_ms == bound_ms
