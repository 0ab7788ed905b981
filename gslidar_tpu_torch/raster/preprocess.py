"""Per-gaussian preprocessing: projection, splat frame, AABB, culling
(port of gslidar_tpu/raster/preprocess.py; reference forward.cu:174-287).

Batched torch ops over the gaussian axis; culled gaussians carry
valid=False and zero tiles.

Frame convention: ``T`` is [P, 3, 3] with ROWS (u_cam, v_cam, p_cam) —
the two scaled tangent axes of the splat and its center, in camera
coordinates. The compositing kernel's Tu/Tv/Tw vectors are the COLUMNS of
this matrix (forward.cu:73-113).
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch

from gslidar_tpu_torch.ops.sh import eval_sh
from gslidar_tpu_torch.raster.settings import (FILTER_INV_SQUARE,
                                               FRUSTUM_MARGIN, NEAR_N,
                                               RasterSettings)


def check_full_f32_matmul(device) -> None:
    """The splat geometry needs full-f32 products (the JAX package pins
    ``Precision.HIGHEST``): refuse to run on a card with TF32 matmuls."""
    if torch.device(device).type == "cuda" and \
            torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is True; "
                           "the splat geometry needs full f32 matmuls")


@contextlib.contextmanager
def full_f32():
    """Full-f32 convolutions and matmuls on a card inside the block: TF32
    off for cuDNN and cuBLAS (PyTorch's default runs float32 convs in TF32,
    where the JAX package pins ``Precision.HIGHEST`` or runs float32 on
    the CPU); the settings are restored on exit."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[P, 4] (w, x, y, z) quaternions -> [P, 3, 3] rotation matrices
    (normalized internally; auxiliary.h:206-228)."""
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-24)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def build_transmat(means3D, scales, quats, viewmat, scale_modifier=1.0):
    """Splat-to-camera frame T [P, 3, 3] (rows u_cam, v_cam, p_cam) and the
    camera-facing normal [P, 3] (dual-visible flip, forward.cu:108-112).
    ``viewmat`` is the [4, 4] row-major world->camera matrix."""
    check_full_f32_matmul(means3D.device)
    R = quat_to_rotmat(quats)                       # [P,3,3] columns = axes
    Rw2c = viewmat[:3, :3]
    u_world = R[..., :, 0] * (scales[..., 0:1] * scale_modifier)
    v_world = R[..., :, 1] * (scales[..., 1:2] * scale_modifier)
    n_world = R[..., :, 2]
    u_cam = u_world @ Rw2c.T
    v_cam = v_world @ Rw2c.T
    p_cam = means3D @ Rw2c.T + viewmat[:3, 3]
    normal = n_world @ Rw2c.T
    flip = torch.where(torch.sum(normal * p_cam, dim=-1, keepdim=True) < 0,
                       1.0, -1.0)
    normal = normal * flip
    T = torch.stack([u_cam, v_cam, p_cam], dim=-2)
    return T, normal


def wrap_col_rect(cx_pix, rad_lo, rad_hi, W, tw, gx):
    """Tile-column rect of a circular-pano splat: first covered column and
    exclusive end col_a + wt, with the run walked mod gx by binning.
    The pixel span wraps at W while the tile grid wraps at gx (they differ
    when the last tile column is partial); see the JAX docstring for why
    a single mod(col_b - col_a, gx) + 1 is wrong."""
    span = rad_lo + rad_hi
    a = torch.remainder(cx_pix - rad_lo, W)
    b = torch.remainder(cx_pix + rad_hi, W)
    col_a = torch.clamp((a / tw).to(torch.int32), 0, gx - 1)
    col_b = torch.clamp((b / tw).to(torch.int32), 0, gx - 1)
    wrapped = (a + span) >= W
    wt = torch.where(wrapped,
                     torch.clamp_max(gx - col_a + col_b + 1, gx),
                     col_b - col_a + 1)
    wt = torch.where(span >= W, torch.full_like(wt, gx), wt)
    return col_a, col_a + wt


def _pano_angles(p_cam):
    """(phi, theta, r) of camera-space points, guarding atan2(0, 0) for
    points exactly at the camera origin."""
    x, y, z = p_cam[:, 0], p_cam[:, 1], p_cam[:, 2]
    degen = (x * x + z * z) < 1e-20
    x_s = torch.where(degen, 0.0, x)
    z_s = torch.where(degen, 1.0, z)
    phi = torch.atan2(x_s, z_s)
    theta = torch.atan2(torch.sqrt(x_s * x_s + z_s * z_s), -y)
    r = torch.sqrt(torch.sum(p_cam * p_cam, dim=-1) + 1e-24)
    return phi, theta, r


def center_projection(T, bounds, settings: RasterSettings):
    """Pixel coordinates and spherical range of the splat centers from the
    frame's p_cam row: (xy [P, 2], r [P])."""
    VFOV_min, VFOV_max, HFOV_min, HFOV_max = bounds
    phi, theta, r = _pano_angles(T[:, 2, :])
    cx = (phi - HFOV_min) * settings.width / (HFOV_max - HFOV_min)
    cy = (theta - VFOV_min) * settings.height / (VFOV_max - VFOV_min)
    return torch.stack([cx, cy], -1), r


def _frustum_ok(phi, theta, r, bounds, scale_factor):
    """Panoramic frustum cull with a fixed 1.3x margin (auxiliary.h:
    182-204): near-plane reject + angular window."""
    vmin, vmax, hmin, hmax = bounds
    center_v = 0.5 * (vmax + vmin)
    half_v = 0.5 * (vmax - vmin)
    center_h = 0.5 * (hmax + hmin)
    half_h = 0.5 * (hmax - hmin)
    return ((r > NEAR_N * scale_factor)
            & (torch.abs((theta - center_v) / half_v) <= FRUSTUM_MARGIN)
            & (torch.abs((phi - center_h) / half_h) <= FRUSTUM_MARGIN))


def mark_visible(means3D, viewmat, scale_factor,
                 settings: RasterSettings, angle_bounds=None):
    """Frustum visibility without a render (the reference's markVisible,
    rasterizer_impl.cu:145-157). Returns [P] bool."""
    check_full_f32_matmul(means3D.device)
    bounds = (angle_bounds if angle_bounds is not None
              else settings.angle_bounds)
    p_cam = means3D @ viewmat[:3, :3].T + viewmat[:3, 3]
    phi, theta, r = _pano_angles(p_cam)
    return _frustum_ok(phi, theta, r, bounds, scale_factor)


class PreprocessOut(NamedTuple):
    T: torch.Tensor             # [P, 3, 3]
    xy: torch.Tensor            # [P, 2] pixel coords of the center (x=width)
    depth: torch.Tensor         # [P] spherical range of the center
    normal: torch.Tensor        # [P, 3]
    color: torch.Tensor         # [P, C] SH-evaluated channels
    radius: torch.Tensor        # [P] float conservative pixel radius
    rect_min: torch.Tensor      # [P, 2] int32 (tx, ty) inclusive
    rect_max: torch.Tensor      # [P, 2] int32 exclusive
    tiles_touched: torch.Tensor  # [P] int32
    valid: torch.Tensor         # [P] bool


_AABB_SAMPLES = 12


def preprocess(means3D, scales, quats, opacity, shs, mask, viewmat, campos,
               sh_degree, scale_factor, settings: RasterSettings,
               scale_modifier=1.0, colors_precomp=None,
               angle_bounds=None, cull_bounds=None) -> PreprocessOut:
    """Full preprocess pass (reference forward.cu:174-287).

    opacity: [P] activated opacity; shs: [P, K, C] (or None with
    colors_precomp [P, C]); mask: [P] bool prefilter. angle_bounds
    overrides the pixel-mapping window, cull_bounds the cull window.
    """
    VFOV_min, VFOV_max, HFOV_min, HFOV_max = (
        angle_bounds if angle_bounds is not None else settings.angle_bounds)
    cull = (cull_bounds if cull_bounds is not None
            else (angle_bounds if angle_bounds is not None
                  else settings.angle_bounds))
    H, W = settings.height, settings.width

    T, normal = build_transmat(means3D, scales, quats, viewmat, scale_modifier)
    p_cam = T[:, 2, :]
    phi, theta, r = _pano_angles(p_cam)
    valid = mask & _frustum_ok(phi, theta, r, cull, scale_factor)

    # AABB by sampling the cutoff ellipse (forward.cu:129-171,243)
    cutoff = torch.sqrt(torch.clamp_min(
        9.0 + 2.0 * torch.log(torch.clamp_min(opacity, 1e-30)), 1e-6))
    ang = (2.0 * math.pi
           * torch.arange(_AABB_SAMPLES, dtype=torch.float32,
                          device=means3D.device) / _AABB_SAMPLES)
    sa, ca = torch.sin(ang), torch.cos(ang)
    sample = (cutoff[:, None, None] * (sa[None, :, None] * T[:, None, 0, :]
                                       + ca[None, :, None] * T[:, None, 1, :])
              + p_cam[:, None, :])                       # [P, 12, 3]
    s_degen = (sample[..., 0] ** 2 + sample[..., 2] ** 2) < 1e-20
    s_x = torch.where(s_degen, 0.0, sample[..., 0])
    s_z = torch.where(s_degen, 1.0, sample[..., 2])
    s_phi = torch.atan2(s_x, s_z)
    if settings.wrap_x:
        # unwrap the sample angles around the center phi so a splat on
        # the +-pi seam gets a local pixel AABB, not a full-width one
        dphi = s_phi - phi[:, None]
        dphi = dphi - 2.0 * math.pi * torch.round(dphi / (2.0 * math.pi))
        s_phi = phi[:, None] + dphi
    s_theta = torch.atan2(torch.sqrt(s_x * s_x + s_z * s_z), -sample[..., 1])
    sx_pix = (s_phi - HFOV_min) * W / (HFOV_max - HFOV_min)
    sy_pix = (s_theta - VFOV_min) * H / (VFOV_max - VFOV_min)

    cx_pix = (phi - HFOV_min) * W / (HFOV_max - HFOV_min)
    cy_pix = (theta - VFOV_min) * H / (VFOV_max - VFOV_min)
    ex_hi = torch.amax(sx_pix, 1) - cx_pix          # per-axis ring extents
    ex_lo = cx_pix - torch.amin(sx_pix, 1)
    ey_hi = torch.amax(sy_pix, 1) - cy_pix
    ey_lo = cy_pix - torch.amin(sy_pix, 1)
    radius = torch.maximum(torch.maximum(ex_hi, ex_lo),
                           torch.maximum(ey_hi, ey_lo))
    valid = valid & (radius >= 0.3)                  # forward.cu:257-258
    rad_i = torch.ceil(radius)

    if settings.tight_rects:
        # output-preserving per-axis rect: tiles wholly outside the
        # alpha >= 1/255 support (rho <= 2 ln(255 op)) are culled, unioned
        # with the rho2d low-pass disk and intersected with the reference
        # square (see the JAX module for the derivation)
        rho_eps = torch.clamp_min(
            2.0 * torch.log(255.0 * torch.clamp_min(opacity, 1e-30)), 1e-6)
        ratio = torch.sqrt(rho_eps) / cutoff * 1.10
        disk = torch.sqrt(rho_eps / FILTER_INV_SQUARE) + 1.0
        small = radius <= 48.0

        def _side(ext):
            tight = torch.ceil(torch.maximum(ratio * ext, disk) + 1.0)
            return torch.minimum(rad_i, torch.where(small, tight, rad_i))

        rx_lo, rx_hi = _side(ex_lo), _side(ex_hi)
        ry_lo, ry_hi = _side(ey_lo), _side(ey_hi)
    else:
        rx_lo = rx_hi = ry_lo = ry_hi = rad_i

    gx, gy = settings.tiles_x, settings.tiles_y
    tw, th = settings.tile_w, settings.tile_h
    rect_min_y = torch.clamp(((cy_pix - ry_lo) / th).to(torch.int32), 0, gy)
    rect_max_y = torch.clamp(((cy_pix + ry_hi + th - 1) / th).to(torch.int32),
                             0, gy)
    if settings.wrap_x:
        rect_min_x, rect_max_x = wrap_col_rect(cx_pix, rx_lo, rx_hi, W, tw,
                                               gx)
    else:
        rect_min_x = torch.clamp(((cx_pix - rx_lo) / tw).to(torch.int32),
                                 0, gx)
        rect_max_x = torch.clamp(
            ((cx_pix + rx_hi + tw - 1) / tw).to(torch.int32), 0, gx)
    area = (rect_max_x - rect_min_x) * (rect_max_y - rect_min_y)
    valid = valid & (area > 0)
    tiles_touched = torch.where(valid, area, 0).to(torch.int32)

    if colors_precomp is not None:
        color = colors_precomp
    else:
        dirs = means3D - campos[None, :]
        dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True)
                                 + 1e-24)
        color, _ = eval_sh(sh_degree, shs, dirs)

    return PreprocessOut(
        T=T,
        xy=torch.stack([cx_pix, cy_pix], -1),
        depth=r,
        normal=normal,
        color=color,
        radius=torch.where(valid, rad_i, 0.0),
        rect_min=torch.stack([rect_min_x, rect_min_y], -1),
        rect_max=torch.stack([rect_max_x, rect_max_y], -1),
        tiles_touched=tiles_touched,
        valid=valid,
    )
