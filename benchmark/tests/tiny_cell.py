"""The tiny CPU cell of the tests: ``tiny/`` holds a BENCHMARK.json of
one cell of a cut kitti360_nvs_10750 (3,000 gaussians, 16x64 halves, 6
frames), its configuration, its traffic and its limits, as data files."""

import contextlib
import io
import json
import os

import torch

TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny")
SEED = 2 ** 31 + 12345


def tiny_spec():
    with open(os.path.join(TINY, "BENCHMARK.json")) as f:
        return json.load(f)


def run_tiny_raw(workload, monkeypatch, seconds=0.5, seed=SEED):
    """One run of a tiny cell on the CPU, the look for a card skipped:
    (exit code, standard output)."""
    from benchmark import run
    monkeypatch.setattr(run, "DATA_DIR", TINY)
    result = run.run_cell(tiny_spec(), workload, seed, seconds, False,
                          torch.device("cpu"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.report(result)
    return rc, out.getvalue()


def run_tiny(workload, monkeypatch, seconds=0.5, seed=SEED):
    """(exit code, the last line of standard output parsed)."""
    rc, out = run_tiny_raw(workload, monkeypatch, seconds, seed)
    return rc, json.loads(out.strip().splitlines()[-1])
