"""Top-level differentiable panoramic rasterizer
(port of gslidar_tpu/raster/rasterize.py).

Pipeline: preprocess -> bin -> forward compositing kernel, the
counterpart of CudaRasterizer::Rasterizer::forward
(rasterizer_impl.cu:212-385) and of the JAX package's pallas path
(``pallas_op.rasterize_pallas``). Bin and composite run inside
``composite_op.CompositeOp``, whose backward is the backward compositing
kernel and the per-gaussian reduction; autograd carries the gradient on
through preprocess, SH and the model activations.

Gradient tap: pass ``T_tap`` (zeros [P, 3, 3] that require grad) to
receive dL/dT for the densification statistics, as the JAX package does
(the reference reads the same information off the retained
screenspace_points gradient, gaussian_renderer/__init__.py:25-29). The
kernels derive each splat's centre pixel and range from the p_cam column
of T, so dL/dT_tap holds the 2d low-pass branch's centre gradient too;
``densify_grads_from_T_tap`` converts it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gslidar_tpu_torch.raster.composite_fwd import make_params, pack_payload
from gslidar_tpu_torch.raster.composite_op import CompositeOp
from gslidar_tpu_torch.raster.preprocess import preprocess
from gslidar_tpu_torch.raster.settings import RasterSettings


class RasterOut(NamedTuple):
    color: torch.Tensor        # [C, H, W]
    feature: torch.Tensor      # [S+3, H, W]
    depth: torch.Tensor        # [4, H, W]
    alpha: torch.Tensor        # [1, H, W]
    contrib: torch.Tensor      # [2, H, W]
    final_T: torch.Tensor      # [1, H, W]
    radii: torch.Tensor        # [P]
    num_pairs: int             # instances composited
    num_dropped: int           # always 0: instance lists are sized exactly
    tile_need: int             # always 0: there is no per-tile cap


def rasterize(means3D, scales, rotations, opacity, shs, features, mask,
              viewmat, campos, bg, sh_degree, scale_factor,
              settings: RasterSettings, scale_modifier=1.0,
              colors_precomp=None, T_tap=None, angle_bounds=None,
              cull_bounds=None) -> RasterOut:
    """Render one panorama.

    Args:
        means3D: [P, 3]; scales: [P, >=2] activated; rotations: [P, 4] raw
            quats; opacity: [P] activated (optionally * marginal_t);
        shs: [P, K, C] SH coefficients (or None with colors_precomp [P, C]);
        features: [P, S] extra channels; mask: [P] bool prefilter;
        viewmat: [4, 4] world->camera row-major; campos: [3] camera center;
        bg: [C]; sh_degree: int; scale_factor: float;
        T_tap: optional [P, 3, 3] zeros added to the splat frame.
    """
    prep = preprocess(means3D, scales, rotations, opacity, shs, mask,
                      viewmat, campos, sh_degree, scale_factor, settings,
                      scale_modifier, colors_precomp, angle_bounds,
                      cull_bounds)
    if T_tap is not None:
        prep = prep._replace(T=prep.T + T_tap)
    if features is None or features.shape[-1] == 0:
        features = means3D.new_zeros((means3D.shape[0], 0))
    C = prep.color.shape[-1]
    S = features.shape[-1]

    info = {}
    color, feature, depth, misc = CompositeOp.apply(
        pack_payload(prep, opacity, features), prep.rect_min, prep.rect_max,
        prep.depth.detach(), prep.tiles_touched, scale_factor,
        make_params(scale_factor, settings, angle_bounds), settings, C, S,
        info)
    T_fin = misc[0:1]
    return RasterOut(
        color=color + T_fin * bg[:, None, None],
        feature=feature, depth=depth, alpha=1.0 - T_fin,
        contrib=misc[1:3], final_T=T_fin, radii=prep.radius,
        num_pairs=info["num_pairs"], num_dropped=0, tile_need=0)


def densify_grads_from_T_tap(dL_dT, T, settings: RasterSettings):
    """dL/dT -> the reference's phi/theta-space viewspace gradient of the
    densification statistics (backward.cu:684-711).

    Args:
        dL_dT: [P, 3, 3] gradient w.r.t. the splat frame (rows u_cam,
            v_cam, p_cam).
        T: [P, 3, 3] the frame itself.
    Returns:
        [P, 2] gradient whose norm feeds xyz_gradient_accum
        (scene/gaussian_model.py:608-614).
    """
    VFOV_min, VFOV_max, HFOV_min, HFOV_max = settings.angle_bounds
    u, v, w = T[:, 2, 0], T[:, 2, 1], T[:, 2, 2]          # p_cam
    dL_du, dL_dv, dL_dw = dL_dT[:, 2, 0], dL_dT[:, 2, 1], dL_dT[:, 2, 2]
    phi = torch.atan2(u, w)
    # du/dphi = w, dw/dphi = -u
    gx = (dL_du * w - dL_dw * u) * 0.5 * (HFOV_max - HFOV_min)
    r_uw = torch.sqrt(u * u + w * w)
    gy = ((dL_du * (-v * torch.sin(phi)) + dL_dv * r_uw
           + dL_dw * (-v * torch.cos(phi)))
          * 0.5 * (VFOV_max - VFOV_min) * settings.width / settings.height)
    return torch.stack([gx, gy], dim=-1)
