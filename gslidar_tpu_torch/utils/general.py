"""Seeding and the camera-pair shuffle (the port's copy of
gslidar_tpu/utils/general.py::seed_everything and ::shuffle_by_pairs;
reference utils/general_utils.py)."""

from __future__ import annotations

import os
import random

import numpy as np


def seed_everything(seed: int) -> None:
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)


def shuffle_by_pairs(lst) -> None:
    """In-place shuffle preserving (front, back) camera adjacency
    (reference: utils/general_utils.py:160-164)."""
    paired = [(lst[i], lst[i + 1]) for i in range(0, len(lst), 2)]
    random.shuffle(paired)
    lst[:] = [item for pair in paired for item in pair]
