"""The one traffic generator: a traffic mix's data file and the seed in,
the stream of calls out.

``train`` mixes give (camera index, time shift, iteration) per step, by
the training loop's camera rule (``gslidar_tpu_torch/train.py``'s
``pick_camera``, root train.py:285-299): a camera popped at random off a
stack of the training cameras, refilled when empty, and with probability
``lambda_self_supervision`` a time shift of 3 (u - 0.5) times the frame
interval; iterations count on from ``first_iteration``.

The same seed gives the same stream; every seed gives the same cameras,
in another order.
"""

from __future__ import annotations

import numpy as np


def rng_of(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def train_stream(traffic, config, seed: int, n_cameras: int):
    run = config["run"]
    first, last = config["frames"]
    t0, t1 = run["time_duration"]
    interval = (t1 - t0) / (last - first)
    rng = rng_of(seed, 1)
    stack = []
    it = int(traffic["first_iteration"])
    while True:
        if not stack:
            stack = list(range(n_cameras))
        cam = stack.pop(int(rng.integers(len(stack))))
        shift = 0.0
        if rng.random() < run["lambda_self_supervision"]:
            shift = 3 * (rng.random() - 0.5) * interval
        yield cam, float(shift), it
        it += 1
