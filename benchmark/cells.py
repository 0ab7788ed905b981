"""The system under test, driven as a cell's traffic drives it.

``TrainCell`` holds one training state of ``gslidar_tpu_torch`` and takes
``make_train_step``'s steps from it. It is built from the cell's
configuration and seed (``scene.py``) and fed by ``traffic.py``'s stream;
``call(i)`` is one timed call of the window. ``CELLS`` maps a traffic
mix's ``kind`` to its cell. What the correctness check needs of the program's own run is kept
in ``record``.

The program is imported inside the constructors: nothing of it is loaded
until a cell is built.
"""

from __future__ import annotations

import torch

from benchmark import scene as S
from benchmark import traffic as TR


class AttrDict(dict):
    """The run's configuration, read as the program reads its Config."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e


def run_args(config) -> AttrDict:
    return AttrDict(config["run"])


def bg_of(args, device) -> torch.Tensor:
    return torch.tensor([1.0, 1.0, 1.0, 1.0] if args.get("white_background")
                        else [0.0, 0.0, 0.0, 1.0], device=device)


def fingerprint(params) -> dict:
    """Per group, the float64 sum and sum of squares: enough to tell two
    draws of the parameters apart."""
    return {k: (float(v.double().sum()), float((v.double() ** 2).sum()))
            for k, v in params.items()}


def leaf_norms(tensors) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


class TrainCell:
    kind = "train"

    def __init__(self, config, traffic, seed: int, device):
        from gslidar_tpu_torch.engine.train import (init_train_state,
                                                    make_train_step)
        from gslidar_tpu_torch.models.gaussians import GaussianAux
        from gslidar_tpu_torch.models.raydrop_prior import init_raydrop_prior
        from gslidar_tpu_torch.render import gaussian_config, raster_settings

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.args = args = run_args(config)
        h, w = args.hw
        scene = S.make_scene(config, device)
        params = S.make_params(config, scene, seed)
        self.cams = S.train_cameras(config, scene)
        del scene
        self.P = params["xyz"].shape[0]
        self.floats_per_gaussian = sum(v[0].numel() for v in params.values())
        self.record = {"params0": fingerprint(params)}
        # the loop has flipped its time split by iteration 20,001
        self.cfg = gaussian_config(args, no_time_split=False)
        self.settings = raster_settings(args, h, w)
        self.bg = bg_of(args, device)
        self.step_fn = make_train_step(args, self.cfg, self.settings, self.bg)
        self.state = init_train_state(params, GaussianAux.zeros(
            self.P, device), init_raydrop_prior(h, w, device))
        self.stream = TR.train_stream(traffic, config, seed, len(self.cams))
        self.calls = []

    def sh_degree(self, iteration: int) -> int:
        a = self.args
        return min(iteration // a.sh_increase_interval, a.sh_degree)

    def call(self, i=None):
        cam, shift, it = next(self.stream)
        self.calls.append((cam, shift, it))
        self.state, loss, self.log, _ = self.step_fn(
            self.state, self.cams[cam], it, self.sh_degree(it), shift,
            bool(self.traffic["stats_on"]),
            bool(self.traffic["apply_update"]))
        return loss

    def first_steps(self):
        """The checked steps, through ``call``: each step's loss, the first
        gradient's norm per group as Adam holds it after one step, and the
        parameters after the last, on the host."""
        n = int(self.traffic["checked_steps"])
        losses, terms = [], []
        for k in range(n):
            losses.append(float(self.call()))
            terms.append({key: float(v) for key, v in self.log.items()
                          if key.startswith("loss_")})
            if k == 0:
                mu = dict(self.state.opt.mu)
                mu["prior"] = self.state.prior_opt[0]
                b1 = 0.9
                self.record["grad1"] = {key: v / (1 - b1) for key, v in
                                        leaf_norms(mu).items()}
        self.record["losses"] = losses
        self.record["terms"] = terms
        self.record["params_end"] = {
            k: v.detach().cpu() for k, v in self.state.params.items()}
        self.record["prior_end"] = self.state.prior.detach().cpu()
        self.record["calls"] = list(self.calls[:n])

    def free(self):
        self.state = self.step_fn = self.log = None
        self.cams = None


CELLS = {"train": TrainCell}
