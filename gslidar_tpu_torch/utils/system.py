"""System utilities: iteration discovery and ply export (the port's copy
of gslidar_tpu/utils/system.py; reference utils/system_utils.py)."""

from __future__ import annotations

import os


def search_for_max_iteration(folder: str):
    """Reference utils/system_utils.py:14-16."""
    saved = [int("".join(c for c in f if c.isdigit()))
             for f in os.listdir(folder)]
    return max(saved) if saved else None


def save_ply(points, path) -> None:
    import numpy as np
    from gslidar_tpu_torch.utils.ply import save_xyz_ply
    save_xyz_ply(np.asarray(points), path)
