"""The gaussians' activations and the render of one panorama.

A frozen copy of the port's plain PyTorch version (models/gaussians.py,
engine/render.py), held here so that a change to the program cannot move
the reference it is judged by. It imports nothing of the program."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference.geometry import RasterSettings
from benchmark.reference.raster import RasterOut, rasterize

Params = dict

PARAM_KEYS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation",
              "t", "scaling_t", "velocity", "intensity")


# ----------------------------- activations --------------------------------
def get_scaling(params: Params) -> torch.Tensor:
    return torch.exp(params["scaling"])


def get_scaling_t(params: Params) -> torch.Tensor:
    return torch.exp(params["scaling_t"])


def get_opacity(params: Params) -> torch.Tensor:
    return torch.sigmoid(params["opacity"])


def get_features(params: Params) -> torch.Tensor:
    """[N, K, C] SH coefficients (dc + rest)."""
    return torch.cat([params["f_dc"], params["f_rest"]], dim=1)


def get_xyz_shm(params: Params, timestamp, cfg):
    """Simple-harmonic displacement x(t) = x + v sin((t - t0) a) / a,
    a = 2 pi / cycle (gaussian_model.py:151-153)."""
    a = 1.0 / cfg.cycle * math.pi * 2
    return params["xyz"] + params["velocity"] * torch.sin(
        (timestamp - params["t"]) * a) / a


def get_inst_velocity(params: Params, cfg) -> torch.Tensor:
    """Velocity with temporal-extent decay (gaussian_model.py:156-157)."""
    return params["velocity"] * torch.exp(
        -get_scaling_t(params) / cfg.cycle / 2 * cfg.velocity_decay)


def get_marginal_t(params: Params, timestamp) -> torch.Tensor:
    """Temporal opacity marginal (gaussian_model.py:185-186)."""
    st = get_scaling_t(params)
    return torch.exp(-0.5 * (params["t"] - timestamp) ** 2 / (st * st))


class RenderPkg(NamedTuple):
    depth: torch.Tensor          # [1, H, W] (mean or median per median_depth)
    depth_mean: torch.Tensor
    depth_median: torch.Tensor
    distortion: torch.Tensor
    depth_square: torch.Tensor
    alpha: torch.Tensor
    feature: torch.Tensor        # [S, H, W] extra channels
    normal: torch.Tensor         # [3, H, W] normalized
    intensity_sh: torch.Tensor   # [1, H, W]
    raydrop: torch.Tensor        # [1, H, W] prior-composed, clamped
    radii: torch.Tensor          # [P]
    visibility: torch.Tensor     # [P] bool
    contrib: torch.Tensor
    num_dropped: int
    num_pairs: int
    tile_need: int


def render(params: Params, alive: torch.Tensor, viewmat, campos, timestamp,
           towards_idx, prior_param, bg, sh_degree, scale_factor,
           cfg, settings: RasterSettings, *,
           dynamic: bool, median_depth: bool = False, time_shift=0.0,
           T_tap=None, use_prior: bool = True) -> RenderPkg:
    """One panorama render.

    Args:
        towards_idx: 0 = forward, 1 = backward (selects the prior half).
        prior_param: [1, h, 2w] raydrop prior logits (or None).
        time_shift: scalar self-supervision shift.
        T_tap: optional [P, 3, 3] zero tap on the splat frame (rasterize).
    """
    opacity = get_opacity(params)[:, 0]
    ts = timestamp - time_shift
    means3D = get_xyz_shm(params, ts, cfg)
    means3D = means3D + get_inst_velocity(params, cfg) * time_shift
    marginal = get_marginal_t(params, ts)[:, 0]
    if dynamic:
        opacity = opacity * marginal

    scales = get_scaling(params)
    rotations = params["rotation"]
    shs = get_features(params)

    t_scale = torch.clamp_max(get_scaling_t(params), 2.0)
    v = get_inst_velocity(params, cfg)
    features = torch.cat([t_scale, v], dim=1)               # S = 4

    mask = alive & (opacity > 1.0 / 255.0)
    if dynamic:
        mask = mask & (marginal > 0.05)

    out: RasterOut = rasterize(
        means3D, scales, rotations, opacity, shs, features, mask,
        viewmat, campos, bg, sh_degree, scale_factor, settings,
        T_tap=T_tap)

    intensity_sh = out.color[2:3]
    raydrop = out.color[3:4]
    S = features.shape[-1]
    rendered_other = out.feature[:S]
    normal = out.feature[S:S + 3]
    normal = normal / torch.sqrt(
        torch.sum(normal * normal, dim=0, keepdim=True) + 1e-16)

    if use_prior and prior_param is not None:
        w = prior_param.shape[-1] // 2
        start = int(towards_idx) * w
        prior = torch.sigmoid(prior_param[..., start:start + w])
        raydrop = prior + (1.0 - prior) * raydrop

    depth_mean = out.depth[0:1]
    depth_median = out.depth[1:2]
    depth = depth_median if median_depth else depth_mean

    return RenderPkg(
        depth=depth, depth_mean=depth_mean, depth_median=depth_median,
        distortion=out.depth[2:3], depth_square=out.depth[3:4],
        alpha=out.alpha, feature=rendered_other, normal=normal,
        intensity_sh=intensity_sh, raydrop=torch.clamp(raydrop, 0.0, 1.0),
        radii=out.radii, visibility=out.radii > 0, contrib=out.contrib,
        num_dropped=out.num_dropped, num_pairs=out.num_pairs,
        tile_need=out.tile_need)

