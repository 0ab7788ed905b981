"""The per-gaussian preprocess pass: splat frame, cull, AABB, rects, SH.

A frozen copy of the port's plain PyTorch version
(raster/preprocess.py), held here so that a change to the program cannot
move the reference it is judged by. It imports nothing of the program."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference.geometry import (FILTER_INV_SQUARE, FRUSTUM_MARGIN,
                                          NEAR_N, RasterSettings)
from benchmark.reference.sh import eval_sh

def _sumsq(v: torch.Tensor) -> torch.Tensor:
    """[..., n] -> [...]: ((v_0^2 + v_1^2) + ...), summed in order (as
    csrc/preprocess.cu sums)."""
    out = v[..., 0] * v[..., 0]
    for i in range(1, v.shape[-1]):
        out = out + v[..., i] * v[..., i]
    return out


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[P, 4] (w, x, y, z) quaternions -> [P, 3, 3] rotation matrices
    (normalized internally; auxiliary.h:206-228)."""
    q = q / torch.sqrt(_sumsq(q)[..., None] + 1e-24)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _dot(a, b):
    """Row-wise dot product of [P, 3] tensors, summed in order."""
    return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]


def _rotate(v, M):
    """[P, 3] rows times M^T, written out: out_i = (v_0 M_i0 + v_1 M_i1)
    + v_2 M_i2, as the kernel sums (a matmul on the card sums in cuBLAS's
    order, which can move a tile rect's floor by one)."""
    return v[:, 0:1] * M[:, 0] + v[:, 1:2] * M[:, 1] + v[:, 2:3] * M[:, 2]


def build_transmat(means3D, scales, quats, viewmat, scale_modifier=1.0):
    """Splat-to-camera frame T [P, 3, 3] (rows u_cam, v_cam, p_cam) and the
    camera-facing normal [P, 3] (dual-visible flip, forward.cu:108-112).
    ``viewmat`` is the [4, 4] row-major world->camera matrix. Its 3x3
    products are written out as sums in a fixed order (``_rotate``), as
    the preprocess kernel sums them."""
    R = quat_to_rotmat(quats)                       # [P,3,3] columns = axes
    M = viewmat[:3, :3]
    u_cam = _rotate(R[:, :, 0] * (scales[:, 0:1] * scale_modifier), M)
    v_cam = _rotate(R[:, :, 1] * (scales[:, 1:2] * scale_modifier), M)
    p_cam = _rotate(means3D, M) + viewmat[:3, 3]
    normal = _rotate(R[:, :, 2], M)
    flip = torch.where(_dot(normal, p_cam)[:, None] < 0, 1.0, -1.0)
    return torch.stack([u_cam, v_cam, p_cam], dim=-2), normal * flip


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
    r = torch.sqrt(_sumsq(p_cam) + 1e-24)
    return phi, theta, r


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


def _view_dirs(means3D, campos):
    """Unit directions from the camera centre to the means, and their
    lengths before the normalisation, [P, 1]."""
    d = means3D - campos[None, :]
    n = torch.sqrt(_sumsq(d) + 1e-24)[:, None]
    return d / n, n


def _windows(settings: RasterSettings, angle_bounds, cull_bounds):
    """(the pixel-mapping window, the cull window): each (VFOV_min,
    VFOV_max, HFOV_min, HFOV_max)."""
    bounds = angle_bounds if angle_bounds is not None \
        else settings.angle_bounds
    return bounds, cull_bounds if cull_bounds is not None else bounds


def _preprocess_plain(means3D, scales, quats, opacity, shs, mask, viewmat,
                      campos, sh_degree, scale_factor,
                      settings: RasterSettings, scale_modifier=1.0,
                      colors_precomp=None, angle_bounds=None,
                      cull_bounds=None, edges=None):
    """The preprocess pass (reference forward.cu:174-287) and the SH clamp
    mask [P, C] (None with ``colors_precomp``). With a list ``edges``, it
    appends [P] tensors: how far each gaussian's arguments of its integer
    decisions lie from where the decision flips (the floors and ceilings from an integer, the
    comparisons from their thresholds), so that a caller can tell a flip
    at an edge from a fault."""
    (VFOV_min, VFOV_max, HFOV_min, HFOV_max), cull = _windows(
        settings, angle_bounds, cull_bounds)
    H, W = settings.height, settings.width

    T, normal = build_transmat(means3D, scales, quats, viewmat,
                               scale_modifier)
    p_cam = T[:, 2, :]
    phi, theta, r = _pano_angles(p_cam)
    valid = mask & _frustum_ok(phi, theta, r, cull, scale_factor)
    if edges is not None:
        vmin, vmax, hmin, hmax = cull
        edges += [(r - NEAR_N * scale_factor).abs(),
                  (torch.abs((theta - 0.5 * (vmax + vmin))
                             / (0.5 * (vmax - vmin))) - FRUSTUM_MARGIN).abs(),
                  (torch.abs((phi - 0.5 * (hmax + hmin))
                             / (0.5 * (hmax - hmin))) - FRUSTUM_MARGIN).abs()]

    # AABB by sampling the cutoff ellipse (forward.cu:129-171,243)
    cutoff = torch.sqrt(torch.clamp_min(
        9.0 + 2.0 * torch.log(torch.clamp_min(opacity, 1e-30)), 1e-6))
    sa, ca = _sample_angles(means3D.device)
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
    if edges is not None:
        edges += [(radius - 0.3).abs(), (radius - 48.0).abs(),
                  _from_int(radius)]

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
            arg = torch.maximum(ratio * ext, disk) + 1.0
            if edges is not None:
                edges.append(_from_int(arg))
            return torch.minimum(rad_i, torch.where(small, torch.ceil(arg),
                                                    rad_i))

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
    if edges is not None:
        edges += [_from_int((cy_pix - ry_lo) / th),
                  _from_int((cy_pix + ry_hi + th - 1) / th)]
        if settings.wrap_x:
            edges += [_from_int(torch.remainder(cx_pix - rx_lo, W) / tw),
                      _from_int(torch.remainder(cx_pix + rx_hi, W) / tw),
                      (torch.remainder(cx_pix - rx_lo, W) + rx_lo + rx_hi
                       - W).abs()]
        else:
            edges += [_from_int((cx_pix - rx_lo) / tw),
                      _from_int((cx_pix + rx_hi + tw - 1) / tw)]
    area = (rect_max_x - rect_min_x) * (rect_max_y - rect_min_y)
    valid = valid & (area > 0)
    tiles_touched = torch.where(valid, area, 0).to(torch.int32)

    clamped = None
    if colors_precomp is not None:
        color = colors_precomp
    else:
        color, clamped = eval_sh(sh_degree, shs,
                                 _view_dirs(means3D, campos)[0])

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
    ), clamped


def _from_int(x):
    """How far x lies from the nearest integer."""
    return (x - torch.round(x)).abs()


_SAMPLE_ANGLES = {}


def _sample_angles(device):
    """(sin, cos) of the 12 AABB sample angles, [12] float32 each, made
    on ``device`` by its own sin and cos (once per device): the kernel
    reads them rather than calling sinf and cosf, so both versions sample
    the ellipse at the same points."""
    key = torch.device(device)
    if key not in _SAMPLE_ANGLES:
        ang = (2.0 * math.pi
               * torch.arange(_AABB_SAMPLES, dtype=torch.float32,
                              device=device) / _AABB_SAMPLES)
        _SAMPLE_ANGLES[key] = (torch.sin(ang), torch.cos(ang))
    return _SAMPLE_ANGLES[key]


