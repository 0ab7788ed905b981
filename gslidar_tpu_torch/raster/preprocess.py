"""Per-gaussian preprocessing: projection, splat frame, AABB, culling
(port of gslidar_tpu/raster/preprocess.py; reference forward.cu:174-287).

``preprocess`` is ``PreprocessFn``: on a card its forward and backward
are the kernels of csrc/preprocess.cu, one thread per gaussian; on the
CPU they are the plain versions, ``preprocess_reference`` (batched torch
ops over the gaussian axis, differentiable by autograd, any float dtype)
and ``preprocess_backward_reference`` (the gradient written out). Only
``T`` and ``color`` carry a gradient. Culled gaussians carry valid=False
and zero tiles.

Frame convention: ``T`` is [P, 3, 3] with ROWS (u_cam, v_cam, p_cam) —
the two scaled tangent axes of the splat and its center, in camera
coordinates. The compositing kernel's Tu/Tv/Tw vectors are the COLUMNS of
this matrix (forward.cu:73-113).
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import NamedTuple

import torch

from gslidar_tpu_torch.ops.sh import active_coeffs, eval_sh, eval_sh_backward
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


def _rotate_t(v, M):
    """[P, 3] rows times M, written out (the gradient of ``_rotate``)."""
    return v[:, 0:1] * M[0] + v[:, 1:2] * M[1] + v[:, 2:3] * M[2]


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
    """``preprocess_reference`` and the SH clamp mask [P, C] (None with
    ``colors_precomp``). With a list ``edges``, it appends [P] tensors: how
    far each gaussian's arguments of its integer decisions lie from where
    the decision flips (the floors and ceilings from an integer, the
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


def preprocess_reference(means3D, scales, quats, opacity, shs, mask, viewmat,
                         campos, sh_degree, scale_factor,
                         settings: RasterSettings, scale_modifier=1.0,
                         colors_precomp=None, angle_bounds=None,
                         cull_bounds=None) -> PreprocessOut:
    """The plain version of the preprocess pass (reference
    forward.cu:174-287), in any float dtype and differentiable by
    autograd (the dense oracle differentiates its xy, depth and normal).

    opacity: [P] activated opacity; shs: [P, K, C] (or None with
    colors_precomp [P, C]); mask: [P] bool prefilter. angle_bounds
    overrides the pixel-mapping window, cull_bounds the cull window.
    """
    return _preprocess_plain(means3D, scales, quats, opacity, shs, mask,
                             viewmat, campos, sh_degree, scale_factor,
                             settings, scale_modifier, colors_precomp,
                             angle_bounds, cull_bounds)[0]


def preprocess_backward_reference(means3D, scales, quats, shs, viewmat,
                                  campos, sh_degree, clamped, dT, dcolor,
                                  scale_modifier=1.0):
    """The plain backward of the preprocess pass, written out: from the
    cotangents of ``T`` [P, 3, 3] and ``color`` [P, C] (and the forward's
    SH clamp mask ``clamped`` [P, C]) to the gradients of means3D [P, 3],
    scales (its shape; the first two columns, the rest 0), quats [P, 4]
    and shs [P, K, C] (None when ``shs`` is None: the colors were given).
    The other outputs are piecewise constant (the rects, the flip of the
    normal) or carry no gradient in the port (xy, depth, normal)."""
    M = viewmat[:3, :3]
    n = torch.sqrt(_sumsq(quats) + 1e-24)[:, None]
    q = quats / n
    R = quat_to_rotmat(quats)
    du = _rotate_t(dT[:, 0], M)            # d u_world, d v_world
    dv = _rotate_t(dT[:, 1], M)
    dmeans = _rotate_t(dT[:, 2], M)
    dscales = torch.zeros_like(scales)
    dscales[:, 0] = _dot(du, R[:, :, 0]) * scale_modifier
    dscales[:, 1] = _dot(dv, R[:, :, 1]) * scale_modifier
    # d R's first two columns, then through the rotation's polynomial
    g0 = du * (scales[:, 0:1] * scale_modifier)
    g1 = dv * (scales[:, 1:2] * scale_modifier)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    dq = torch.stack([
        2.0 * (z * g0[:, 1] - y * g0[:, 2] - z * g1[:, 0] + x * g1[:, 2]),
        2.0 * (y * g0[:, 1] + z * g0[:, 2] + y * g1[:, 0]
               - 2.0 * x * g1[:, 1] + w * g1[:, 2]),
        2.0 * (-2.0 * y * g0[:, 0] + x * g0[:, 1] - w * g0[:, 2]
               + x * g1[:, 0] + z * g1[:, 2]),
        2.0 * (-2.0 * z * g0[:, 0] + w * g0[:, 1] + x * g0[:, 2]
               - w * g1[:, 0] - 2.0 * z * g1[:, 1] + y * g1[:, 2]),
    ], -1)
    # through the normalisation q / sqrt(|q|^2 + 1e-24)
    dquats = (dq - q * torch.sum(q * dq, -1, keepdim=True)) / n
    dshs = None
    if shs is not None:
        dirs, dn = _view_dirs(means3D, campos)
        dshs, ddirs = eval_sh_backward(sh_degree, shs, dirs, clamped, dcolor)
        dmeans = dmeans + (ddirs - dirs * _dot(dirs, ddirs)[:, None]) / dn
    return dmeans, dscales, dquats, dshs


MAX_CHANNELS = 16      # C the kernels take (csrc/preprocess.cu)


class _KernelParams(ctypes.Structure):
    """csrc/preprocess.cu's ``PrepParams``, field for field. The floats
    are the plain version's Python scalars as the card's torch applies
    them: cast to float32, and a division by one a multiplication by the
    reciprocal torch takes (``_reciprocal``)."""
    _fields_ = ([(f, ctypes.c_int) for f in (
        "P", "K", "C", "n_sh", "width", "height", "tile_w", "tile_h",
        "tiles_x", "tiles_y", "wrap_x", "tight", "scale_stride",
        "scale_cols")]
        + [(f, ctypes.c_float) for f in (
            "scale_modifier", "hmin", "vmin", "fW", "fH", "hrange",
            "vrange", "inv_hrange", "inv_vrange", "cv", "ch", "half_v",
            "half_h", "inv_half_v", "inv_half_h", "near", "two_pi",
            "inv_two_pi", "fTW", "fTH", "inv_tw", "inv_th")])


_RECIPROCALS = {}


def _reciprocal(b, device) -> float:
    """The float32 factor by which torch on ``device`` multiplies a tensor
    that it divides by the Python scalar ``b`` (on a card it divides by a
    scalar as a product with a reciprocal), read from torch once per
    device and value."""
    key = (device, float(b))
    if key not in _RECIPROCALS:
        _RECIPROCALS[key] = float(torch.ones(1, device=device) / float(b))
    return _RECIPROCALS[key]


def _kernel_params(P, scales, shs, C, opts: _Options) -> _KernelParams:
    s = opts.settings
    (vmin, vmax, hmin, hmax), (cvmin, cvmax, chmin, chmax) = _windows(
        s, opts.angle_bounds, opts.cull_bounds)

    def inv(x):
        return _reciprocal(x, scales.device)
    vmin, vmax, hmin, hmax = (float(v) for v in (vmin, vmax, hmin, hmax))
    cvmin, cvmax, chmin, chmax = (float(v) for v in (cvmin, cvmax, chmin,
                                                     chmax))
    half_v, half_h = 0.5 * (cvmax - cvmin), 0.5 * (chmax - chmin)
    K = 0 if shs is None else shs.shape[1]
    return _KernelParams(
        P=P, K=K, C=C, n_sh=0 if shs is None else active_coeffs(
            opts.sh_degree, K),
        width=s.width, height=s.height, tile_w=s.tile_w, tile_h=s.tile_h,
        tiles_x=s.tiles_x, tiles_y=s.tiles_y, wrap_x=int(s.wrap_x),
        tight=int(s.tight_rects), scale_stride=scales.stride(0),
        scale_cols=scales.shape[1], scale_modifier=opts.scale_modifier,
        hmin=hmin, vmin=vmin, fW=s.width, fH=s.height,
        hrange=hmax - hmin, vrange=vmax - vmin,
        inv_hrange=inv(hmax - hmin), inv_vrange=inv(vmax - vmin),
        cv=0.5 * (cvmax + cvmin), ch=0.5 * (chmax + chmin),
        half_v=half_v, half_h=half_h, inv_half_v=inv(half_v),
        inv_half_h=inv(half_h), near=NEAR_N * opts.scale_factor,
        two_pi=2.0 * math.pi, inv_two_pi=inv(2.0 * math.pi),
        fTW=s.tile_w, fTH=s.tile_h, inv_tw=inv(s.tile_w),
        inv_th=inv(s.tile_h))


def _float_rows(name, x, P, cols):
    """x as a contiguous float32 [P, cols] tensor (raises otherwise)."""
    if x.dtype != torch.float32 or x.shape[0] != P or \
            x[0].numel() != cols:
        raise TypeError(f"{name} must be float32 with {P} rows of {cols}, "
                        f"got {x.dtype} {tuple(x.shape)}")
    return x.contiguous()


def _kernel_inputs(means3D, scales, quats, shs, viewmat, campos):
    """The inputs both kernels read, checked: (means, scales, quats, shs,
    viewmat, campos). ``scales`` keeps its row stride when its columns
    are contiguous."""
    P = means3D.shape[0]
    dev = means3D.device
    for name, x in (("scales", scales), ("quats", quats), ("shs", shs),
                    ("viewmat", viewmat), ("campos", campos)):
        if x is not None and x.device != dev:
            raise ValueError(f"{name} on {x.device}, means3D on {dev}")
    if scales.dim() != 2 or scales.shape[1] < 2 or \
            scales.shape[0] != P or scales.dtype != torch.float32:
        raise TypeError(f"scales must be float32 [{P}, >= 2], got "
                        f"{scales.dtype} {tuple(scales.shape)}")
    if scales.stride(1) != 1:
        scales = scales.contiguous()
    if shs is not None and (shs.dim() != 3 or shs.shape[1] > 16):
        raise TypeError(f"shs must be [P, K <= 16, C], got "
                        f"{tuple(shs.shape)}")
    return (_float_rows("means3D", means3D, P, 3), scales,
            _float_rows("quats", quats, P, 4),
            None if shs is None else _float_rows(
                "shs", shs, P, shs.shape[1] * shs.shape[2]),
            _float_rows("viewmat", viewmat, 4, 4),
            _float_rows("campos", campos[None], 1, 3))


def _launch(name, dev, *args):
    from gslidar_tpu_torch.kernels import load_library
    lib = load_library()
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    with torch.cuda.device(index):
        err = getattr(lib, name)(index, *args,
                                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _preprocess_kernel(means3D, scales, quats, opacity, shs, colors_precomp,
                       mask, viewmat, campos, opts: _Options):
    """The forward kernel: (PreprocessOut, the SH clamp mask [P, C] or
    None)."""
    P = means3D.shape[0]
    dev = means3D.device
    means3D, scales, quats, shs, viewmat, campos = _kernel_inputs(
        means3D, scales, quats, shs, viewmat, campos)
    opacity = _float_rows("opacity", opacity, P, 1)
    if mask.dtype != torch.bool or mask.shape != (P,) or mask.device != dev:
        raise TypeError(f"mask must be bool [{P}] on {dev}")
    mask = mask.contiguous()
    if colors_precomp is None and shs is None:
        raise ValueError("preprocess needs shs or colors_precomp")
    C = colors_precomp.shape[1] if shs is None else shs.shape[2]
    if C > MAX_CHANNELS:
        raise ValueError(f"{C} color channels, the kernel takes at most "
                         f"{MAX_CHANNELS}")
    params = _kernel_params(P, scales, shs, C, opts)
    sa, ca = _sample_angles(dev)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = PreprocessOut(
        T=torch.empty(P, 3, 3, **f32), xy=torch.empty(P, 2, **f32),
        depth=torch.empty(P, **f32), normal=torch.empty(P, 3, **f32),
        color=(colors_precomp if shs is None
               else torch.empty(P, C, **f32)),
        radius=torch.empty(P, **f32), rect_min=torch.empty(P, 2, **i32),
        rect_max=torch.empty(P, 2, **i32), tiles_touched=torch.empty(P, **i32),
        valid=torch.empty(P, dtype=torch.bool, device=dev))
    clamped = None if shs is None else torch.empty(P, C, dtype=torch.bool,
                                                   device=dev)
    if P:
        _launch("gslidar_preprocess_fwd", dev, ctypes.byref(params),
                means3D.data_ptr(), scales.data_ptr(), quats.data_ptr(),
                opacity.data_ptr(), mask.data_ptr(), _ptr(shs),
                viewmat.data_ptr(), campos.data_ptr(), sa.data_ptr(),
                ca.data_ptr(), *(x.data_ptr() for x in out[:4]),
                None if shs is None else out.color.data_ptr(),
                *(x.data_ptr() for x in out[5:]), _ptr(clamped))
        preprocess.launches += 1
    return out, clamped


def _preprocess_backward_kernel(means3D, scales, quats, shs, viewmat, campos,
                                clamped, dT, dcolor, opts: _Options):
    """The backward kernel: (d means3D, d scales, d quats, d shs or
    None), as ``preprocess_backward_reference``."""
    P = means3D.shape[0]
    dev = means3D.device
    shape_s = scales.shape
    means3D, scales, quats, shs, viewmat, campos = _kernel_inputs(
        means3D, scales, quats, shs, viewmat, campos)
    dT = _float_rows("dT", dT, P, 9)
    C = 0 if shs is None else shs.shape[2]
    if shs is not None:
        dcolor = _float_rows("dcolor", dcolor, P, C)
    params = _kernel_params(P, scales, shs, C, opts)
    f32 = dict(dtype=torch.float32, device=dev)
    dmeans = torch.empty(P, 3, **f32)
    dscales = torch.empty(shape_s, **f32)
    dquats = torch.empty(P, 4, **f32)
    dshs = None if shs is None else torch.empty_like(shs)
    if P:
        _launch("gslidar_preprocess_bwd", dev, ctypes.byref(params),
                means3D.data_ptr(), scales.data_ptr(), quats.data_ptr(),
                _ptr(shs), viewmat.data_ptr(), campos.data_ptr(),
                _ptr(clamped), dT.data_ptr(),
                None if shs is None else dcolor.data_ptr(),
                dmeans.data_ptr(), dscales.data_ptr(), dquats.data_ptr(),
                _ptr(dshs))
        preprocess.backward_launches += 1
    return dmeans, dscales, dquats, dshs


class _Options(NamedTuple):
    """The preprocess pass's arguments that are not tensors."""
    sh_degree: int
    scale_factor: float
    settings: RasterSettings
    scale_modifier: float
    angle_bounds: tuple | None
    cull_bounds: tuple | None


class PreprocessFn(torch.autograd.Function):
    """The preprocess pass with its own backward: on CPU tensors the plain
    forward (autograd off) and the plain backward
    (``preprocess_backward_reference``), on CUDA tensors the kernels of
    csrc/preprocess.cu. Only ``T`` and ``color`` carry a gradient; the
    rest of ``PreprocessOut`` is marked non-differentiable."""

    @staticmethod
    def forward(ctx, means3D, scales, quats, opacity, shs, colors_precomp,
                mask, viewmat, campos, opts: _Options):
        if means3D.device.type == "cpu":
            out, clamped = _preprocess_plain(
                means3D, scales, quats, opacity, shs, mask, viewmat, campos,
                opts.sh_degree, opts.scale_factor, opts.settings,
                opts.scale_modifier, colors_precomp, opts.angle_bounds,
                opts.cull_bounds)
        else:
            out, clamped = _preprocess_kernel(
                means3D, scales, quats, opacity, shs, colors_precomp, mask,
                viewmat, campos, opts)
        ctx.save_for_backward(means3D, scales, quats, shs, viewmat, campos,
                              clamped)
        ctx.opts = opts
        ctx.colors_given = colors_precomp is not None
        ctx.mark_non_differentiable(*(getattr(out, f) for f in (
            "xy", "depth", "normal", "radius", "rect_min", "rect_max",
            "tiles_touched", "valid")))
        return tuple(out)

    @staticmethod
    def backward(ctx, dT, dxy, ddepth, dnormal, dcolor, *_):
        means3D, scales, quats, shs, viewmat, campos, clamped = \
            ctx.saved_tensors
        opts = ctx.opts
        if means3D.device.type == "cpu":
            dm, ds, dq, dsh = preprocess_backward_reference(
                means3D, scales, quats, shs, viewmat, campos, opts.sh_degree,
                clamped, dT, dcolor, opts.scale_modifier)
        else:
            dm, ds, dq, dsh = _preprocess_backward_kernel(
                means3D, scales, quats, shs, viewmat, campos, clamped, dT,
                dcolor, opts)
        return (dm, ds, dq, None, dsh, dcolor if ctx.colors_given else None,
                None, None, None, None)


def preprocess(means3D, scales, quats, opacity, shs, mask, viewmat, campos,
               sh_degree, scale_factor, settings: RasterSettings,
               scale_modifier=1.0, colors_precomp=None,
               angle_bounds=None, cull_bounds=None) -> PreprocessOut:
    """Full preprocess pass (reference forward.cu:174-287), arguments as
    ``preprocess_reference``'s, through ``PreprocessFn``: float32 CPU
    tensors run the plain versions, float32 CUDA tensors launch the
    kernels (``preprocess.launches`` counts the forwards,
    ``preprocess.backward_launches`` the backwards); any other device or
    dtype raises."""
    dev = means3D.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"preprocess runs on cpu or cuda tensors, not "
                         f"{means3D.device}")
    if means3D.dtype != torch.float32:
        raise TypeError(f"preprocess takes float32 tensors, not "
                        f"{means3D.dtype} (preprocess_reference runs any "
                        f"float dtype)")
    if colors_precomp is not None:
        shs = None
    out = PreprocessFn.apply(
        means3D, scales, quats, opacity, shs, colors_precomp, mask, viewmat,
        campos, _Options(int(sh_degree), float(scale_factor), settings,
                         float(scale_modifier), angle_bounds, cull_bounds))
    return PreprocessOut(*out)


preprocess.launches = 0
preprocess.backward_launches = 0
