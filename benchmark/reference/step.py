"""The reference's training step, assembled from the plain versions
beside this file.

``train_step`` is one step of the program's ``make_train_step`` at a
cell's settings (statistics off, Adam applied): the render, the losses,
autograd back through the plain backward compositor, preprocess and the
activations, per-group Adam and the prior's Adam.

``lowered`` set to a dtype runs the control: the parameters and the
compositor's rows rounded to that precision (``raster.PAYLOAD_DTYPE``),
as a lower-precision model would store them. ``fault="half_view"``
plants the fault of half the batch left out: the lower half of the
view's rows lose their GT, so every masked loss is the mean over the
rest.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import raster
from benchmark.reference.geometry import RasterSettings
from benchmark.reference.losses import compute_losses
from benchmark.reference.model import get_opacity, render
from benchmark.reference.optim import (AdamState, PriorAdam, adam_step,
                                       group_lrs, init_raydrop_prior)


class Model(NamedTuple):
    """The run's settings as the reference reads them."""
    args: object
    cycle: float
    velocity_decay: float
    settings: RasterSettings      # the half panorama
    bg: torch.Tensor

    @property
    def sf(self) -> float:
        return float(self.args.scale_factor)


def model_of(args, device) -> Model:
    h, w = args.hw
    return Model(args=args, cycle=float(args.cycle),
                 velocity_decay=float(args.velocity_decay),
                 settings=RasterSettings(
                     height=h, width=w, vfov=tuple(args.vfov),
                     hfov=tuple(args.hfov), num_extra_features=4,
                     tight_rects=bool(args.get("raster_tight_rects", True))),
                 bg=torch.tensor([1.0, 1.0, 1.0, 1.0]
                                 if args.get("white_background")
                                 else [0.0, 0.0, 0.0, 1.0], device=device))


class TrainState(NamedTuple):
    params: dict
    opt: AdamState
    prior: torch.Tensor
    prior_opt: tuple


def init_state(params, model: Model) -> TrainState:
    h, w = model.args.hw
    dev = params["xyz"].device
    prior = init_raydrop_prior(h, w, dev)
    return TrainState(
        params=params,
        opt=AdamState(mu={k: torch.zeros_like(v) for k, v in params.items()},
                      nu={k: torch.zeros_like(v) for k, v in params.items()},
                      count=0),
        prior=prior, prior_opt=PriorAdam.init(prior))


def _lower(x, dtype):
    return x if dtype is None else x.to(dtype).to(torch.float32)


def train_step(state: TrainState, cam, iteration: int, sh_degree: int,
               time_shift: float, model: Model, lowered=None, fault=None):
    """One step; returns (new state, loss as a float, each loss term as a
    float)."""
    args = model.args
    params = {k: v.detach().requires_grad_(True)
              for k, v in state.params.items()}
    prior = state.prior.detach().requires_grad_(True)
    used = {k: _lower(v, lowered) for k, v in params.items()}
    alive = torch.ones(params["xyz"].shape[0], dtype=torch.bool,
                       device=prior.device)
    gt_d, gt_i = cam.pts_depth, cam.pts_intensity
    if fault == "half_view":
        half = gt_d.shape[-2] // 2
        gt_d, gt_i = gt_d.clone(), gt_i.clone()
        gt_d[..., half:, :] = 0.0
        gt_i[..., half:, :] = 0.0
    raster.PAYLOAD_DTYPE = lowered
    try:
        pkg = render(used, alive, cam.viewmat, cam.campos, cam.timestamp,
                     cam.towards_idx, prior, model.bg, sh_degree, model.sf,
                     model, model.settings, dynamic=bool(args.dynamic),
                     median_depth=bool(args.get("median_depth", False)),
                     time_shift=time_shift)
    finally:
        raster.PAYLOAD_DTYPE = None
    opa = get_opacity(used)[:, 0]
    loss, log = compute_losses(pkg, gt_d, gt_i, iteration, args, opa,
                               alive.to(torch.float32))
    keys = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in keys] + [prior],
                                allow_unused=True)
    gp = {k: torch.zeros_like(params[k]) if g is None else g
          for k, g in zip(keys, grads)}
    with torch.no_grad():
        new_params, new_opt = adam_step(state.params, gp, state.opt,
                                        group_lrs(args, iteration))
        new_prior, new_prior_opt = PriorAdam.step(
            state.prior, grads[-1], state.prior_opt, args.raydrop_prior_lr)
    return (TrainState(new_params, new_opt, new_prior, new_prior_opt),
            float(loss.detach()), loss_terms(log))


def loss_terms(log) -> dict:
    return {k: float(v.detach()) if torch.is_tensor(v) else float(v)
            for k, v in log.items() if k.startswith("loss_")}
