"""Densification statistics (port of
gslidar_tpu/models/densify.py::add_densification_stats; reference
train.py:360-362, gaussian_model.py:608-614). Clone, split and prune are
not ported yet."""

from __future__ import annotations

import dataclasses

import torch

from gslidar_tpu_torch.models.gaussians import GaussianAux


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
