"""The training step, densify and the opacity reset (port of
gslidar_tpu/engine/train.py; reference train.py:150-375).

A step is two functions, shared by ``make_train_step`` (one camera) and
``parallel.shard.make_parallel_train_step`` (B cameras over a group).
``grad_pass`` renders its cameras through the kernels, assembles the
losses and runs autograd back through the backward compositing kernel,
preprocess, SH and the model activations, with the densification
statistics off a zero T tap per camera while they are on. ``update``
accumulates those statistics and applies Adam to the gaussians
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
    always steps. The step is ``grad_pass`` of one camera, then ``update``.

    Each step counts ``train_steps``. Its spans: ``step``, and inside it
    ``step.render``, ``step.losses``, ``step.backward`` (the
    ``torch.autograd.grad`` call; beneath it, on autograd's thread,
    ``bwd.losses``, ``bwd.render`` and ``bwd.activations``),
    ``step.stats``, ``step.adam`` and ``step.prior_adam``."""
    @span("step")
    def train_step(state: TrainState, cam: CameraBatch, iteration,
                   sh_degree, time_shift, stats_on, apply_update=True):
        count("train_steps")
        g = grad_pass(args, cfg, settings, bg, state, [cam], [time_shift],
                      iteration, sh_degree, stats_on)
        return (update(args, state, g.params, g.prior, g.stats, iteration,
                       apply_update), g.loss,
                {**g.logs[0], "num_pairs": g.num_pairs},
                {**g.params, "prior": g.prior})

    return train_step


class StepGrads(NamedTuple):
    """What ``grad_pass`` gives ``update`` and the data-parallel step."""
    params: dict                # each param group's gradient
    prior: torch.Tensor         # the prior's gradient
    stats: list                 # per camera (viewspace gradient [P, 2], t
                                # gradient [P, 1], radii, visible), or []
    loss: torch.Tensor          # the cameras' summed loss over ``scale``
    logs: list                  # each camera's loss terms
    num_pairs: int              # the largest instance count


def grad_pass(args, cfg: G.GaussianConfig, settings: RasterSettings, bg,
              state: TrainState, cams, time_shifts, iteration, sh_degree,
              stats_on, scale=1) -> StepGrads:
    """Render each camera of ``cams`` at its shift and assemble its losses;
    one ``torch.autograd.grad`` of their sum over ``scale`` gives the
    gaussians' and the prior's gradients and, only while ``stats_on``,
    each camera's densification statistics, from a zero T tap on its splat
    frame (reference train.py:356-362), its gradients times ``scale``.

    A camera's t gradient is that of a zero t tap of its own when several
    cameras share the backward, and the parameter's own with one. With
    the statistics off no tap is made, and neither the statistics' splat
    frame nor their viewspace gradient is computed."""
    params = {k: v.detach().requires_grad_(True)
              for k, v in state.params.items()}
    prior = state.prior.detach().requires_grad_(True)
    P, dev = state.aux.alive.shape[0], prior.device
    split_t = stats_on and len(cams) > 1
    T_taps, t_taps, pkgs, logs, loss = [], [], [], [], None
    for cam, shift in zip(cams, time_shifts):
        pc = params
        if stats_on:
            T_taps.append(torch.zeros(P, 3, 3, device=dev,
                                      requires_grad=True))
        if split_t:
            t_taps.append(torch.zeros(P, 1, device=dev, requires_grad=True))
            pc = {**params, "t": params["t"] + t_taps[-1]}
        with span("step.render"):
            pkg = render(pc, state.aux.alive, cam.viewmat, cam.campos,
                         cam.timestamp, cam.towards_idx, prior, bg, sh_degree,
                         float(args.scale_factor), cfg, settings,
                         dynamic=bool(args.dynamic),
                         median_depth=bool(args.get("median_depth", False)),
                         time_shift=shift,
                         T_tap=T_taps[-1] if stats_on else None)
        with span("step.losses"):
            opa = G.get_opacity(pc)[:, 0]
            l, log = compute_losses(pkg, cam.pts_depth, cam.pts_intensity,
                                    iteration, args, opa,
                                    state.aux.alive.to(torch.float32))
        loss = l if loss is None else loss + l
        pkgs.append(pkg)
        logs.append({k: v.detach() if torch.is_tensor(v) else v
                     for k, v in log.items()})
    if scale != 1:
        loss = loss / scale
    # the backward by layer, while a profiler records: the losses, the
    # render from its outputs, the activations from the rasterizer's
    # inputs (``render``) to the end
    backward_begins(loss, "bwd.losses")
    backward_boundary([t for pkg in pkgs for t in pkg], "bwd.render")
    inputs = [*params.values(), prior, *T_taps, *t_taps]
    with span("step.backward"):
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(inputs, grads)]
    gp = dict(zip(params, grads))
    stats, n = [], len(params) + 1
    if stats_on:
        with torch.no_grad(), span("step.stats"):
            for j, (cam, shift, pkg) in enumerate(zip(cams, time_shifts,
                                                      pkgs)):
                gT = grads[n + j]
                gt = grads[n + len(cams) + j] if split_t else gp["t"]
                if scale != 1:
                    gT, gt = gT * scale, gt * scale
                vs = densify_grads_from_T_tap(gT, _transmat_for_stats(
                    state.params, cam.viewmat, cfg, cam.timestamp, shift),
                    settings)
                stats.append((vs, gt, pkg.radii, pkg.visibility))
    return StepGrads(gp, grads[n - 1], stats, loss.detach(), logs,
                     max(pkg.num_pairs for pkg in pkgs))


def update(args, state: TrainState, grads: dict, grad_prior, stats,
           iteration, apply_update=True) -> TrainState:
    """The new state: ``stats`` (``StepGrads.stats``) added to the
    densification statistics in camera order, Adam on the gaussians'
    ``grads`` if ``apply_update``, and the prior's Adam on ``grad_prior``.
    With no statistics the state's ``aux`` is returned as it was."""
    with torch.no_grad():
        with span("step.stats"):
            aux = state.aux
            for s in stats:
                aux = add_densification_stats(aux, *s)
        with span("step.adam"):
            if apply_update:
                new_params, new_opt = adam_step(
                    state.params, grads, state.opt,
                    group_lrs(args, iteration))
            else:
                new_params, new_opt = state.params, state.opt
        with span("step.prior_adam"):
            new_prior, new_prior_opt = PriorAdam.step(
                state.prior, grad_prior, state.prior_opt,
                args.raydrop_prior_lr)
    return TrainState(new_params, aux, new_opt, new_prior, new_prior_opt)


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
