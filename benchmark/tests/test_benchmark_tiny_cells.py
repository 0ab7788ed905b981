"""The tiny CPU cell runs end to end through the port's plain versions and
print a well-formed last line; without a card the command refuses."""

import os
import subprocess
import sys
import types

import pytest

from tiny_cell import run_tiny, run_tiny_raw

KEYS = ("correct", "attempted", "failed", "metrics", "device", "checks")


@pytest.mark.parametrize("workload,metrics", [
    ("tiny_train", {"train_steps_per_s", "setup_s"}),
])
def test_tiny_cell_runs_and_is_correct(workload, metrics, monkeypatch):
    rc, line = run_tiny(workload, monkeypatch)
    assert rc == 0
    assert list(line) == list(KEYS)
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == metrics
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_the_command_refuses_without_a_card():
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "train_1908_1M", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.parametrize("where", ["reader", "check"])
def test_no_result_when_jax_is_loaded_after_the_window(where, monkeypatch):
    """A module named ``jax`` loaded after the look that follows the
    window, in a metric's reader or in the reference check, still stops
    the result line: the look is made again just before it is printed."""
    from benchmark import checks, run

    def load_jax():
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    if where == "reader":
        load = run.load_reader

        def loader(name):
            reader = load(name)
            if name != "setup_s":
                return reader

            def read(ctx):
                load_jax()
                return reader.read(ctx)
            return types.SimpleNamespace(read=read)
        monkeypatch.setattr(run, "load_reader", loader)
    else:
        ref = checks.reference_train

        def reference(*a, **k):
            load_jax()
            return ref(*a, **k)
        monkeypatch.setattr(checks, "reference_train", reference)
    rc, out = run_tiny_raw("tiny_train", monkeypatch)
    assert rc == 4
    assert out.strip() == ""
