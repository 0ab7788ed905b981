"""System utilities: iteration discovery, timing, ply export (the port's
copy of gslidar_tpu/utils/system.py).

Reference: utils/system_utils.py. The Timing context manager reports
device wall time by synchronizing the CUDA device around the block, as the
reference's paired CUDA events do (utils/system_utils.py:19-41); on a
machine without a card it times the host.
"""

from __future__ import annotations

import os
import time

import torch


def search_for_max_iteration(folder: str):
    """Reference utils/system_utils.py:14-16."""
    saved = [int("".join(c for c in f if c.isdigit()))
             for f in os.listdir(folder)]
    return max(saved) if saved else None


class Timing:
    """with Timing("name"): ... — prints device-synchronized elapsed ms."""

    def __init__(self, name: str = "", enabled: bool = True):
        self.name = name
        self.enabled = enabled

    def __enter__(self):
        if self.enabled:
            self._sync()
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            self._sync()
            self.elapsed_ms = (time.perf_counter() - self.t0) * 1000
            print(f"[timing] {self.name}: {self.elapsed_ms:.2f} ms")
        return False

    @staticmethod
    def _sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def save_ply(points, path) -> None:
    import numpy as np
    from gslidar_tpu_torch.utils.ply import save_xyz_ply
    save_xyz_ply(np.asarray(points), path)
