"""The ``train`` kind: ``gslidar_tpu_torch``'s training steps from one
state, checked against the reference's same steps.

``Cell`` holds one training state of the port and takes
``make_train_step``'s steps from it. It is built from the cell's
configuration and seed (``scene.py``) and fed by ``traffic.py``'s stream;
``call(i)`` is one timed call of the window. What the check needs of the
program's own run is kept in ``record``.

``check`` runs the reference (``checks.reference_train``) over the same
first steps once the program's state is freed, and gives the numbers
``checks.py`` compares, the lines that show where a gap comes from, and
the work counts the readers take a step's least time and the backward
compositor's bound from (``counts.py``).

``control`` puts the reference in the program's place, run wrong on
purpose: ``bf16`` computes it with its parameters and the compositor's
rows in bfloat16, the nearest precision below the configuration's
float32 (a tempting step: the JAX package had a bfloat16 payload
switch); ``half_view`` leaves the lower half of each view out of the
losses, whose masked means are then taken over the rest.

The program is imported inside the constructor: nothing of it is loaded
until a cell is built.
"""

from __future__ import annotations

import itertools

import torch

from benchmark import checks
from benchmark import counts
from benchmark import scene as S
from benchmark import traffic as TR
from benchmark.checks import fingerprint, leaf_norms, run_args

CONTROLS = ("bf16", "half_view")


def bg_of(args, device) -> torch.Tensor:
    return torch.tensor([1.0, 1.0, 1.0, 1.0] if args.get("white_background")
                        else [0.0, 0.0, 0.0, 1.0], device=device)


class Cell:
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
        P = params["xyz"].shape[0]
        self.record = {
            "params0": fingerprint(params), "P": P,
            "floats_per_gaussian": sum(v[0].numel()
                                       for v in params.values())}
        # the loop has flipped its time split by iteration 20,001
        self.cfg = gaussian_config(args, no_time_split=False)
        self.settings = raster_settings(args, h, w)
        self.bg = bg_of(args, device)
        self.step_fn = make_train_step(args, self.cfg, self.settings, self.bg)
        self.state = init_train_state(params, GaussianAux.zeros(
            P, device), init_raydrop_prior(h, w, device))
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

    @property
    def traced_calls(self) -> int:
        return 2 * len(self.record["calls"])

    def again(self, i):
        """Call ``i`` of the traced stretch: the checked steps' views
        again, in turn, from the state the window left, so that the
        roofline's bound counts the pairs of the views that are timed."""
        first = self.record["calls"]
        self.stream = iter([first[i % len(first)]])
        return self.call()

    def free(self):
        self.state = self.step_fn = self.log = None
        self.cams = None


def check(config, traffic, seed: int, record, device):
    """(numbers, lines, extras): the numbers compared, lines for standard
    error, and the work counts ``work`` and ``composite_bwd_bound_ms``."""
    sink = []
    ref = checks.reference_train(config, traffic, seed, record["calls"],
                                 device, sink=sink)
    per_group = {}
    numbers = checks.train_numbers(record, ref, device, per_group)
    lines = ["descent_gap of each group: " + ", ".join(
        f"{k} {v:.3g}" for k, v in sorted(per_group.items()))]
    lines += [f"loss term {k}: relative gap {v:.3g}"
              for k, v in sorted(checks.term_gaps(record, ref).items())]
    lines.append("loss gap of each step: " + ", ".join(
        f"{v:.3g}" for v in checks.step_loss_gaps(record, ref)))
    numbers["same_inputs"] = 0 if checks.same_params(
        record["params0"], ref["params0"]) else 1
    h, w = config["run"]["hw"]
    extras = {
        "work": counts.step_work(record["P"], record["floats_per_gaussian"],
                                 h * 2 * w, sink, 16, 16, 4, 4),
        "composite_bwd_bound_ms": counts.composite_bound_ms(sink, 4, 4,
                                                            True)}
    return numbers, lines, extras


def control(name: str, config, traffic, seed: int, device) -> dict:
    """The numbers the control ``name`` reads against the reference."""
    lowered = torch.bfloat16 if name == "bf16" else None
    fault = "half_view" if name == "half_view" else None
    first, last = config["frames"]
    n_cams = 2 * (last - first + 1 - len(config["val_frames"]))
    calls = list(itertools.islice(
        TR.train_stream(traffic, config, seed, n_cams),
        int(traffic["checked_steps"])))
    ref = checks.reference_train(config, traffic, seed, calls, device)
    low = checks.reference_train(config, traffic, seed, calls, device,
                                 lowered=lowered, fault=fault)
    per_group = {}
    numbers = checks.train_numbers(low, ref, device, per_group)
    numbers["loss_gap_of_each_step"] = checks.step_loss_gaps(low, ref)
    numbers["descent_gap_of_each_group"] = per_group
    return numbers
