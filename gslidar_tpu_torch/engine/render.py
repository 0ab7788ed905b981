"""High-level render API: gaussian model + camera -> panorama package
(port of gslidar_tpu/engine/render.py; reference
gaussian_renderer/__init__.py:16-155)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from gslidar_tpu_torch.models import gaussians as G
from gslidar_tpu_torch.raster.rasterize import RasterOut, rasterize
from gslidar_tpu_torch.raster.settings import RasterSettings
from gslidar_tpu_torch.utils.trace import backward_boundary, span


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


def render(params: G.Params, alive: torch.Tensor, viewmat, campos, timestamp,
           towards_idx, prior_param, bg, sh_degree, scale_factor,
           cfg: G.GaussianConfig, settings: RasterSettings, *,
           dynamic: bool, median_depth: bool = False, time_shift=0.0,
           T_tap=None, use_prior: bool = True,
           full360: bool = False) -> RenderPkg:
    """One panorama render: the model's activations (span
    ``render.activations``), ``rasterize``, the ray-drop prior
    (``render.prior``).

    Args:
        towards_idx: 0 = forward, 1 = backward (selects the prior half).
        prior_param: [1, h, 2w] raydrop prior logits (or None).
        time_shift: scalar self-supervision shift.
        T_tap: optional [P, 3, 3] zero tap on the splat frame (rasterize).
        full360: the render covers the full stitched 360 panorama in one
            pass (settings must be the wrap_x full-width config); the prior
            is re-laid-out to the stitched break order (0, w/2, 3w/2, 2w)
            instead of half-sliced, and towards_idx is ignored.
    """
    with span("render.activations"):
        opacity = G.get_opacity(params)[:, 0]
        ts = timestamp - time_shift
        means3D = G.get_xyz_shm(params, ts, cfg)
        means3D = means3D + G.get_inst_velocity(params, cfg) * time_shift
        marginal = G.get_marginal_t(params, ts)[:, 0]
        if dynamic:
            opacity = opacity * marginal

        scales = G.get_scaling(params)
        rotations = params["rotation"]
        shs = (params["f_dc"], params["f_rest"])     # read where they lie

        t_scale = torch.clamp_max(G.get_scaling_t(params), 2.0)
        v = G.get_inst_velocity(params, cfg)
        features = torch.cat([t_scale, v], dim=1)               # S = 4

        mask = alive & (opacity > 1.0 / 255.0)
        if dynamic:
            mask = mask & (marginal > 0.05)
    backward_boundary((means3D, scales, rotations, opacity, *shs, features),
                      "bwd.activations")

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
        with span("render.prior"):
            w = prior_param.shape[-1] // 2
            if full360:
                # stitched layout (breaks 0, w//2, w//2 + w, 2w): the back
                # half splits at w - w//2 (not w//2: the two differ for odd
                # w, such as KITTI's 515)
                front = prior_param[..., :w]
                back = prior_param[..., w:]
                split = w - w // 2
                prior = torch.sigmoid(torch.cat(
                    [back[..., split:], front, back[..., :split]], dim=-1))
            else:
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
