"""Densification: statistics, clone / split / prune and the opacity reset
(port of gslidar_tpu/models/densify.py; reference
scene/gaussian_model.py:451-614).

The JAX package keeps a fixed capacity and writes new gaussians into free
slots; here the tensors are sized exactly, as in the reference, so a
densify cuts and appends rows:

* the selection is the JAX package's (``densify.py:81-110``): the
  never-visible rows (``max_radii2D < 0.707``) are cut and never selected;
  clone small high-gradient gaussians, split large ones, and under
  ``t_grad`` clone / split on the time gradient too;
* the new rows follow in the JAX package's emission order: sources in
  ascending row order, each emitting its clone copy first (when cloned),
  then its ``N`` split copies (``N = 2`` under ``no_time_split``, else 3);
* the result holds the surviving old rows in their order (split
  originals removed), then the new rows; then the opacity prune and the
  world-size prune, evaluated over all of them, cut rows again;
* the Adam moments are cut with their rows, and new rows get zero
  moments (``optim.cut_and_append_moments``); the step count stays.

Quirk preserved: the reference zeroes max_radii2D before its screen-size
prune, so only the world-size prune acts (gaussian_model.py:449,599-602),
and only when a size threshold is given.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import torch

from gslidar_tpu_torch.models.gaussians import (GaussianAux, GaussianConfig,
                                                Params, get_inst_velocity,
                                                get_opacity, get_scaling,
                                                get_scaling_t)
from gslidar_tpu_torch.models.optim import (AdamState,
                                            cut_and_append_moments,
                                            zero_moments_at)
from gslidar_tpu_torch.raster.preprocess import quat_to_rotmat

SPLIT_N = 2                       # reference densify_and_split N=2
RADII_PRUNE = 0.707               # gaussian_model.py:571


class DensifyOut(NamedTuple):
    params: Params
    aux: GaussianAux
    opt_state: AdamState
    counts: Dict[str, int]        # rows before / after, new rows, prunes


def inverse_sigmoid(x):
    return torch.log(x / (1 - x))


def add_densification_stats(aux: GaussianAux, viewspace_grad, t_grad,
                            radii, visible) -> GaussianAux:
    """Accumulate the per-gaussian gradient statistics of one view:
    ``viewspace_grad`` [P, 2], ``t_grad`` [P, 1], ``radii`` [P],
    ``visible`` [P] bool."""
    gnorm = torch.linalg.norm(viewspace_grad[:, :2], dim=-1)
    return dataclasses.replace(
        aux,
        max_radii2D=torch.where(visible,
                                torch.maximum(aux.max_radii2D, radii),
                                aux.max_radii2D),
        xyz_gradient_accum=aux.xyz_gradient_accum
        + torch.where(visible, gnorm, 0.0),
        t_gradient_accum=aux.t_gradient_accum
        + torch.where(visible, t_grad[:, 0], 0.0),
        denom=aux.denom + visible.to(aux.denom.dtype))


def _contract_scale_factor(xyz, extent, contract: bool):
    """Contracted-space scale threshold factor
    (gaussian_model.py:459-463,537-541)."""
    if contract:
        sf = torch.linalg.norm(xyz, dim=-1) * extent - 1.0
        return torch.where(sf <= 1.0, 1.0, sf) / extent
    return torch.ones(xyz.shape[0], dtype=xyz.dtype, device=xyz.device) \
        / extent


def selection(params: Params, aux: GaussianAux, cfg: GaussianConfig, *,
              max_grad, max_grad_t, extent, prune_only=False):
    """The JAX package's masks over the rows (``densify.py:81-110``):
    (visible, clone, split, split_keep_scale, split_keep_scale_t)."""
    visible = aux.alive & (aux.max_radii2D >= RADII_PRUNE)
    if prune_only:
        none = torch.zeros_like(visible)
        return visible, none, none, none, none
    denom = aux.denom
    grads = torch.where(denom > 0, aux.xyz_gradient_accum / denom, 0.0)
    grads_t = torch.where(denom > 0, aux.t_gradient_accum / denom, 0.0)
    max_scale = torch.amax(get_scaling(params), dim=-1)
    scaling_t = get_scaling_t(params)[:, 0]
    pd_thresh = cfg.percent_dense * extent * _contract_scale_factor(
        params["xyz"], extent, cfg.contract)
    big_grad = visible & (grads.abs() >= max_grad)
    clone = big_grad & (max_scale <= pd_thresh)
    split = big_grad & (max_scale > pd_thresh)
    if cfg.t_grad:
        big_t = visible & (grads_t.abs() >= max_grad_t)
        clone = clone | (big_t & (scaling_t <= cfg.percent_dense))
        split = split | (big_t & (scaling_t > cfg.percent_dense))
    # time-selected splits with a small spatial scale keep it
    # (gaussian_model.py:514-517); the same for a small temporal scale
    keep_scale = split & (max_scale < pd_thresh)
    keep_scale_t = split & (scaling_t < cfg.percent_dense)
    return visible, clone, split, keep_scale, keep_scale_t


def densify_and_prune(params: Params, aux: GaussianAux,
                      opt_state: AdamState, cfg: GaussianConfig, *,
                      max_grad, max_grad_t, min_opacity, extent,
                      size_threshold, prune_only: bool = False,
                      z_xyz=None, z_t=None,
                      generator: torch.Generator | None = None
                      ) -> DensifyOut:
    """Clone, split and prune on exact-size tensors.

    ``z_xyz`` [n_new, 3] and ``z_t`` [n_new, 1] are the standard normal
    split offsets, one row per new gaussian in emission order (a clone
    copy's row is drawn and unused, as in the JAX package's
    ``samples[slot k]``); when absent they are drawn from ``generator``.
    ``size_threshold`` None turns the world-size prune off. Returns the
    new params, zeroed aux, the cut moments and the counts: ``before``,
    ``never_visible``, ``clones``, ``splits`` (split sources, whose
    originals are cut), ``new`` (rows requested and appended),
    ``opacity_pruned``, ``world_size_pruned`` (not already cut by
    opacity), ``after`` and ``old_kept``: the rows after it are the new
    ones that stayed.
    """
    n = aux.alive.shape[0]
    dev = aux.alive.device
    N = SPLIT_N if cfg.no_time_split else SPLIT_N + 1
    decay = SPLIT_N * 0.8                                  # 1.6, pre-increment
    visible, clone, split, keep_scale, keep_scale_t = selection(
        params, aux, cfg, max_grad=max_grad, max_grad_t=max_grad_t,
        extent=extent, prune_only=prune_only)

    # ---- emission: the k-th new row -> (source row, copy index) ----------
    n_new_per = clone.to(torch.int64) + split.to(torch.int64) * N
    src = torch.repeat_interleave(torch.arange(n, device=dev), n_new_per)
    n_new = src.shape[0]                                   # host sync
    offs = torch.cumsum(n_new_per, 0) - n_new_per
    j = torch.arange(n_new, device=dev) - offs[src]
    is_clone_copy = (clone[src] & (j == 0))[:, None]

    if z_xyz is None:
        z_xyz = torch.randn(n_new, 3, device=dev, generator=generator)
    if z_t is None:
        z_t = torch.randn(n_new, 1, device=dev, generator=generator)

    scaling = get_scaling(params)[src]
    scaling_t = get_scaling_t(params)[src]
    R = quat_to_rotmat(params["rotation"][src])
    offset_xyz = torch.einsum("kij,kj->ki", R, z_xyz * scaling)
    samples_t = z_t * scaling_t
    inst_v = get_inst_velocity(params, cfg)[src]
    p = {k: v[src] for k, v in params.items()}

    split_scaling = torch.where(keep_scale[src][:, None], p["scaling"],
                                torch.log(scaling / decay))
    if cfg.no_time_split:
        split_scaling_t = p["scaling_t"]
    else:
        split_scaling_t = torch.where(keep_scale_t[src][:, None],
                                      p["scaling_t"],
                                      torch.log(scaling_t / decay))
    new_vals = dict(p)
    new_vals["xyz"] = torch.where(is_clone_copy, p["xyz"],
                                  p["xyz"] + offset_xyz + inst_v * samples_t)
    new_vals["scaling"] = torch.where(is_clone_copy, p["scaling"],
                                      split_scaling)
    new_vals["t"] = torch.where(is_clone_copy, p["t"], p["t"] + samples_t)
    new_vals["scaling_t"] = torch.where(is_clone_copy, p["scaling_t"],
                                        split_scaling_t)

    # ---- the old rows that stay, then the new rows --------------------------
    keep_old = torch.nonzero(visible & ~split)[:, 0]
    grown = {k: torch.cat([v[keep_old], new_vals[k]])
             for k, v in params.items()}

    # ---- opacity and world-size prune over every row ------------------------
    low_opacity = get_opacity(grown)[:, 0] < min_opacity
    big_ws = torch.zeros_like(low_opacity)
    if size_threshold is not None:
        # max_radii2D was just zeroed (the reference's postfix), so only
        # the world-size prune acts
        big_ws = torch.amax(get_scaling(grown), dim=-1) \
            > cfg.big_point_threshold * extent * _contract_scale_factor(
                grown["xyz"], extent, cfg.contract)
    stay = torch.nonzero(~(low_opacity | big_ws))[:, 0]
    new_params = {k: v[stay] for k, v in grown.items()}
    opt = cut_and_append_moments(
        cut_and_append_moments(opt_state, keep_old, n_new), stay)

    n_visible, n_clone, n_split, n_low, n_big, n_old = torch.stack([
        visible.sum(), clone.sum(), split.sum(), low_opacity.sum(),
        (big_ws & ~low_opacity).sum(),
        (stay < keep_old.shape[0]).sum()]).tolist()
    counts = dict(before=n, never_visible=n - n_visible, clones=n_clone,
                  splits=n_split, new=n_new,
                  opacity_pruned=n_low, world_size_pruned=n_big,
                  after=int(stay.shape[0]), old_kept=n_old)
    return DensifyOut(params=new_params,
                      aux=GaussianAux.zeros(counts["after"], dev),
                      opt_state=opt, counts=counts)


def reset_opacity(params: Params, opt_state: AdamState,
                  cfg: GaussianConfig) -> tuple[Params, AdamState]:
    """Clamp opacity to the init level and zero its Adam moments
    (reference gaussian_model.py:323-341)."""
    o = get_opacity(params)
    params = dict(params)
    params["opacity"] = inverse_sigmoid(torch.clamp_max(o, cfg.init_opacity))
    opt_state = zero_moments_at(
        opt_state, torch.ones(o.shape[0], dtype=torch.bool, device=o.device),
        ("opacity",))
    return params, opt_state
