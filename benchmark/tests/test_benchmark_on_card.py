"""On an H100 (``python -m pytest benchmark/tests -m cuda``): a short run
of a real cell prints a correct, well-formed result line, and a checkout
holding only BENCHMARK.json and benchmark/ refuses to run."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def run(cwd, *args):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=900)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_short_run_of_a_cell(trace):
    need_card()
    p = run(ROOT, "--workload", "train_1908_1M", "--seed", "2147483659",
            "--seconds", "2", "--trace", trace)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"


@pytest.mark.cuda
def test_the_benchmark_alone_refuses(tmp_path):
    need_card()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark")
    p = run(tmp_path, "--workload", "train_1908_1M", "--seed", "1",
            "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert p.stdout.strip() == ""
