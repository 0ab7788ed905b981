"""The benchmark's CPU tests (``python -m pytest benchmark/tests``) and its
card tests (``-m cuda``, on a machine with an H100)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")
