"""The training step, densify and the opacity reset (port of
gslidar_tpu/engine/train.py; reference train.py:150-375).

One step renders one camera through the kernels, assembles the losses,
runs autograd back through the backward compositing kernel, preprocess,
SH and the model activations, accumulates the densification statistics
off a zero T tap while they are on, and applies Adam to the gaussians
(``adam_step``: one kernel launch over every group on the card) and the
prior's own Adam. The state is a ``TrainState`` of exact-size tensors.
``state_to_numpy`` and ``state_from_numpy`` carry it to and from the
layout of gslidar_tpu's TrainState.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from gslidar_tpu_torch.engine.losses import compute_losses
from gslidar_tpu_torch.engine.render import render
from gslidar_tpu_torch.models import gaussians as G
from gslidar_tpu_torch.models.densify import (add_densification_stats,
                                              densify_and_prune,
                                              reset_opacity)
from gslidar_tpu_torch.models.optim import (AdamState, adam_from_numpy,
                                            adam_step, group_lrs, init_adam)
from gslidar_tpu_torch.models.raydrop_prior import PriorAdam
from gslidar_tpu_torch.raster.preprocess import build_transmat
from gslidar_tpu_torch.raster.rasterize import densify_grads_from_T_tap
from gslidar_tpu_torch.raster.settings import RasterSettings
from gslidar_tpu_torch.utils.trace import (backward_begins, backward_boundary,
                                           count, span)


class CameraBatch(NamedTuple):
    """Tensor view of one camera."""
    viewmat: torch.Tensor        # [4, 4] world->camera, row-major
    campos: torch.Tensor         # [3]
    timestamp: float
    towards_idx: int             # 0 = forward, 1 = backward
    pts_depth: torch.Tensor      # [1, h, w] GT range (empty if none)
    pts_intensity: torch.Tensor  # [1, h, w] GT intensity (empty if none)


def camera_to_batch(cam, device) -> CameraBatch:
    def t(x):
        x = np.zeros((1, 0, 0), np.float32) if x is None else x
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    return CameraBatch(
        viewmat=t(cam.world_view_transform),
        campos=t(cam.camera_center),
        timestamp=float(cam.timestamp),
        towards_idx=0 if cam.towards == "forward" else 1,
        pts_depth=t(cam.pts_depth),
        pts_intensity=t(cam.pts_intensity))


class TrainState(NamedTuple):
    params: G.Params
    aux: G.GaussianAux
    opt: AdamState
    prior: torch.Tensor
    prior_opt: tuple


def init_train_state(params, aux, prior) -> TrainState:
    return TrainState(params=params, aux=aux, opt=init_adam(params),
                      prior=prior, prior_opt=PriorAdam.init(prior))


def state_from_numpy(state, device) -> TrainState:
    """A gslidar_tpu TrainState with numpy leaves -> this package's, cut to
    its ``alive`` rows."""
    keep = np.asarray(state.aux.alive)
    return TrainState(
        params=G.params_from_numpy(state.params, device, keep),
        aux=G.GaussianAux.from_numpy(state.aux, device),
        opt=adam_from_numpy(state.opt.mu, state.opt.nu, state.opt.count,
                            device, keep),
        prior=torch.tensor(np.asarray(state.prior, np.float32),
                           device=device),
        prior_opt=PriorAdam.from_numpy(
            [np.asarray(x) for x in state.prior_opt], device))


def state_to_numpy(state: TrainState) -> TrainState:
    """This package's TrainState -> the same structure with numpy leaves
    in the layout of gslidar_tpu's: ``alive`` all True, float32 arrays,
    the Adam step counts as int32 scalars. ``state_from_numpy`` inverts
    it."""
    def np32(x):
        return x.detach().cpu().numpy().astype(np.float32, copy=False)
    mu, nu, count = state.prior_opt
    return TrainState(
        params={k: np32(v) for k, v in state.params.items()},
        aux=G.GaussianAux(**{f.name: getattr(state.aux, f.name).cpu().numpy()
                             for f in dataclasses.fields(state.aux)}),
        opt=AdamState(mu={k: np32(v) for k, v in state.opt.mu.items()},
                      nu={k: np32(v) for k, v in state.opt.nu.items()},
                      count=np.asarray(state.opt.count, np.int32)),
        prior=np32(state.prior),
        prior_opt=(np32(mu), np32(nu), np.asarray(count, np.int32)))


def make_train_step(args, cfg: G.GaussianConfig, settings: RasterSettings,
                    bg):
    """The train step for one resolution: ``train_step(state, cam,
    iteration, sh_degree, time_shift, stats_on, apply_update=True)`` ->
    (new state, loss, log, grads), where grads holds each param group's
    gradient and the prior's (``"prior"``). ``stats_on`` gates the
    densification statistics; ``apply_update=False`` skips the gaussians'
    Adam (the reference's densify iterations, train.py:356-375); the prior
    always steps.

    Each step counts ``train_steps``. Its spans: ``step``, and inside it
    ``step.render``, ``step.losses``, ``step.backward`` (the
    ``torch.autograd.grad`` call; beneath it, on autograd's thread,
    ``bwd.losses``, ``bwd.render`` and ``bwd.activations``),
    ``step.stats``, ``step.adam`` and ``step.prior_adam``. With
    ``stats_on`` False the step makes no T tap and computes neither the
    statistics' splat frame nor their viewspace gradient."""
    dynamic = bool(args.dynamic)
    median_depth = bool(args.get("median_depth", False))
    sf = float(args.scale_factor)

    @span("step")
    def train_step(state: TrainState, cam: CameraBatch, iteration,
                   sh_degree, time_shift, stats_on, apply_update=True):
        count("train_steps")
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        prior = state.prior.detach().requires_grad_(True)
        # the splat frame's zero tap, whose gradient the statistics read;
        # none while they are off
        T_tap = torch.zeros(state.aux.alive.shape[0], 3, 3,
                            device=prior.device,
                            requires_grad=True) if stats_on else None
        with span("step.render"):
            pkg = render(params, state.aux.alive, cam.viewmat, cam.campos,
                         cam.timestamp, cam.towards_idx, prior, bg, sh_degree,
                         sf, cfg, settings, dynamic=dynamic,
                         median_depth=median_depth, time_shift=time_shift,
                         T_tap=T_tap)
        with span("step.losses"):
            opa = G.get_opacity(params)[:, 0]
            loss, log = compute_losses(pkg, cam.pts_depth, cam.pts_intensity,
                                       iteration, args, opa,
                                       state.aux.alive.to(torch.float32))
        keys = list(params)
        # the backward by layer, while a profiler records: the losses, the
        # render from its outputs, the activations from the rasterizer's
        # inputs (``render``) to the end
        backward_begins(loss, "bwd.losses")
        backward_boundary(pkg, "bwd.render")
        with span("step.backward"):
            grads = torch.autograd.grad(
                loss, [params[k] for k in keys] + [prior]
                + ([T_tap] if stats_on else []), allow_unused=True)
        gp = {k: torch.zeros_like(params[k]) if g is None else g
              for k, g in zip(keys, grads)}
        gprior = grads[len(keys)]

        with torch.no_grad():
            # densification statistics (reference train.py:356-362)
            with span("step.stats"):
                aux = state.aux
                if stats_on:
                    vs_grad = densify_grads_from_T_tap(
                        grads[-1], _transmat_for_stats(
                            state.params, cam.viewmat, cfg, cam.timestamp,
                            time_shift), settings)
                    aux = add_densification_stats(aux, vs_grad, gp["t"],
                                                  pkg.radii, pkg.visibility)
            with span("step.adam"):
                if apply_update:
                    new_params, new_opt = adam_step(
                        state.params, gp, state.opt,
                        group_lrs(args, iteration))
                else:
                    new_params, new_opt = state.params, state.opt
            with span("step.prior_adam"):
                new_prior, new_prior_opt = PriorAdam.step(
                    state.prior, gprior, state.prior_opt,
                    args.raydrop_prior_lr)
        log = {k: v.detach() if torch.is_tensor(v) else v
               for k, v in log.items()}
        log["num_pairs"] = pkg.num_pairs
        return (TrainState(new_params, aux, new_opt, new_prior,
                           new_prior_opt), loss.detach(), log,
                {**gp, "prior": gprior})

    return train_step


def make_densify_fn(args, cfg: G.GaussianConfig):
    """``densify_fn(state, generator, extent, size_threshold)`` -> (new
    TrainState, counts): densify and prune at
    the config's thresholds (gslidar_tpu's make_densify_fn), the split
    offsets drawn from ``generator``; ``size_threshold`` None turns the
    world-size prune off."""
    @torch.no_grad()
    def densify_fn(state: TrainState, generator, extent, size_threshold):
        out = densify_and_prune(
            state.params, state.aux, state.opt, cfg,
            max_grad=args.densify_grad_threshold,
            max_grad_t=args.densify_grad_t_threshold,
            min_opacity=args.thresh_opa_prune, extent=extent,
            size_threshold=size_threshold, generator=generator)
        return state._replace(params=out.params, aux=out.aux,
                              opt=out.opt_state), out.counts
    return densify_fn


@torch.no_grad()
def reset_opacity_state(state: TrainState, cfg) -> TrainState:
    p, opt = reset_opacity(state.params, state.opt, cfg)
    return state._replace(params=p, opt=opt)


@torch.no_grad()
def _transmat_for_stats(params, viewmat, cfg, timestamp, time_shift):
    """The splat frame T of the forward's means, for the viewspace-gradient
    conversion of the densification statistics."""
    ts = timestamp - time_shift
    means3D = G.get_xyz_shm(params, ts, cfg)
    means3D = means3D + G.get_inst_velocity(params, cfg) * time_shift
    T, _ = build_transmat(means3D, G.get_scaling(params), params["rotation"],
                          viewmat)
    return T
