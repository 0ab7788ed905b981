"""The CPU cells of the tests. ``tiny/`` holds a BENCHMARK.json of one
cell of a cut kitti360_nvs_10750 (3,000 gaussians, 16x64 halves, 6
frames), its configuration, its traffic and its limits, as data files;
``toy/`` one cell of a toy kind, with that kind's module in
``toy/kinds/``."""

import contextlib
import io
import json
import os

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
TINY = os.path.join(HERE, "tiny")
TOY = os.path.join(HERE, "toy")
SEED = 2 ** 31 + 12345


def tiny_spec(data=TINY):
    with open(os.path.join(data, "BENCHMARK.json")) as f:
        return json.load(f)


def run_tiny_raw(workload, monkeypatch, seconds=0.5, seed=SEED, data=TINY):
    """One run of a cell of the test directory ``data`` on the CPU, the
    look for a card skipped: (exit code, standard output)."""
    from benchmark import run
    monkeypatch.setattr(run, "DATA_DIR", data)
    result = run.run_cell(tiny_spec(data), workload, seed, seconds, False,
                          torch.device("cpu"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.report(result)
    return rc, out.getvalue()


def run_tiny(workload, monkeypatch, seconds=0.5, seed=SEED, data=TINY):
    """(exit code, the last line of standard output parsed)."""
    rc, out = run_tiny_raw(workload, monkeypatch, seconds, seed, data)
    return rc, json.loads(out.strip().splitlines()[-1])
