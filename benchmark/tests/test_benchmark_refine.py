"""The ``refine`` kind on the CPU: a cell of 3 panoramas of 16x128
(``refine_tiny/``, data files only: the kind is ``kinds/refine.py``) run
through ``run_cell``, ``report`` and ``run_control``; the work counts
against ``torch.utils.flop_counter``; the reference and the counts load
with the port and JAX blocked. On an H100 (``-m cuda``), a short run of
``refine_1908_60``."""

import json
import os
import subprocess
import sys

import pytest
import torch

from tiny_cell import HERE, SEED, run_tiny, tiny_spec

REFINE = os.path.join(HERE, "refine_tiny")
ROOT = os.path.dirname(os.path.dirname(HERE))
CHECKS = ["loss_gap", "grad_gap", "bn_stat_gap", "change_gap",
          "descent_gap", "same_inputs"]
SPAN_METRICS = {"refine.fwd_ms.refine", "refine.bwd_ms.refine",
                "refine.adam_ms.refine"}


def test_a_tiny_refine_cell_runs_through_the_harness(monkeypatch):
    """Trace off: ``correct``, each check beside its limit, the epochs
    per second and the set-up. Trace on: the epoch's share of the peak
    and the host syncs per epoch read numbers, and the stretch holds the
    three spans the device-time readers read (no device runs here, so
    those three are silent on the CPU)."""
    from benchmark import run
    rc, line = run_tiny("tiny_refine", monkeypatch, data=REFINE)
    assert rc == 0 and line["correct"] is True
    assert list(line["checks"]) == CHECKS
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    assert line["checks"]["same_inputs"]["value"] == 0
    assert set(line["metrics"]) == {"train_steps_per_s", "setup_s"}

    seen = []

    class Seen(run.Context):
        def __init__(self, **kw):
            super().__init__(**kw)
            seen.append(self)
    monkeypatch.setattr(run, "Context", Seen)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    # the counters are the process's: a run of the command starts with
    # none, where this one follows other tests' steps
    from gslidar_tpu_torch.utils import trace
    saved = trace.counters()
    trace.reset_counters()
    try:
        result = run.run_cell(tiny_spec(REFINE), "tiny_refine", SEED, 0.5,
                              True, torch.device("cpu"))
    finally:
        trace.reset_counters()
        for k, v in saved.items():
            trace.count(k, v)
    metrics = result["metrics"]
    assert set(metrics) == {"refine.epoch_mfu", "refine.host_syncs.refine"}
    assert metrics["refine.host_syncs.refine"]["value"] == 1.0
    assert 0 < metrics["refine.epoch_mfu"]["value"] < 100
    spans = {n for n, _, _ in seen[0].profile.spans}
    assert {"refine.forward", "refine.backward", "refine.adam"} <= spans
    assert seen[0].profile.units == 3


def test_the_controls_of_the_refine_kind(monkeypatch):
    """``eval_bn`` fails a limit of the tiny cell; ``tf32`` reads finite
    numbers (a CPU has no TF32, so it reads as float32 there)."""
    from benchmark import run
    from benchmark.controls import run_control
    monkeypatch.setattr(run, "DATA_DIR", REFINE)
    spec = tiny_spec(REFINE)
    out = run_control(spec, "tiny_refine", SEED, "eval_bn",
                      torch.device("cpu"))
    assert out["numbers"]["bn_stat_gap"] == 1.0
    assert any(out["numbers"][k] > out["limits"][k] for k in out["limits"])
    out = run_control(spec, "tiny_refine", SEED, "tf32", torch.device("cpu"))
    assert all(torch.isfinite(torch.tensor(out["numbers"][k]))
               for k in out["limits"])


def test_the_counts_are_the_flop_counters():
    """The operations of an epoch equal FlopCounterMode's over the
    reference at a small size (odd sizes, so each max pool floors), come
    to 96.6 GFLOP a 66x1030 panorama, and the parameters are the
    reference's."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark import refine_counts as RC
    from benchmark.reference import unet as R
    b, h, w = 2, 33, 130
    g = torch.Generator().manual_seed(3)
    x = torch.rand(b, 3, h, w, generator=g)
    y = (torch.rand(b, 1, h, w, generator=g) < 0.3).float()
    ref = R.Run(x, y, seed=4, epochs=1000, dtype=torch.float32)
    with FlopCounterMode(display=False) as fc:
        ref.epoch()
    assert fc.get_total_flops() == RC.epoch_flops(b, h, w)
    assert RC.epoch_flops(1, 66, 1030) / 1e9 == pytest.approx(96.6, abs=0.05)
    assert RC.parameters() == sum(v.numel() for v in R.init_params(0)[0]
                                  .values()) == 6535969
    work = RC.epoch_work(60, 66, 1030)
    assert work.fp32 == pytest.approx(RC.epoch_flops(60, 66, 1030) / 2,
                                      rel=1e-3)


def test_refine_reference_loads_with_the_port_and_jax_blocked():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                'gslidar_tpu', 'gslidar_tpu_torch'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import benchmark.reference.unet, benchmark.refine_counts\n"
        "print('ok')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "ok"


@pytest.mark.cuda
def test_a_short_run_of_the_refine_cell():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "refine_1908_60", "--seed", "2147483659",
                        "--seconds", "2", "--trace", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(line["metrics"]) >= SPAN_METRICS | {
        "refine.epoch_mfu", "refine.host_syncs.refine"}
