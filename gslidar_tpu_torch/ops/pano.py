"""Panorama <-> LiDAR geometry (port of gslidar_tpu/ops/pano.py).

Conventions (identical to the reference):
  camera frame: +z forward, +x right, -y up (LiDAR-style);
  phi   = atan2(x, z)                 (azimuth, 0 = forward)
  theta = atan2(sqrt(x^2+z^2), -y)    (polar from "up")
  pixel u (width)  = (phi   - HFOV_min) * W / (HFOV_max - HFOV_min)
  pixel v (height) = (theta - VFOV_min) * H / (VFOV_max - VFOV_min)
"""

from __future__ import annotations

import math

import numpy as np
import torch


def fov_bounds(vfov, hfov):
    """Degrees -> radian angle bounds (VFOV_min, VFOV_max, HFOV_min,
    HFOV_max); theta is measured from 'up', so the vertical bounds swap
    (forward.cu:221-226)."""
    VFOV_max = math.pi / 2 - float(vfov[0]) * math.pi / 180
    VFOV_min = math.pi / 2 - float(vfov[1]) * math.pi / 180
    HFOV_max = float(hfov[1]) * math.pi / 180
    HFOV_min = float(hfov[0]) * math.pi / 180
    return VFOV_min, VFOV_max, HFOV_min, HFOV_max


def pixel_dirs(H: int, W: int, vfov, hfov, device="cpu") -> torch.Tensor:
    """Unit ray directions for every pixel, [3, H, W]
    (utils/graphics_utils.py:96-118)."""
    theta_i = torch.arange(H, dtype=torch.float32, device=device)
    phi_j = torch.arange(W, dtype=torch.float32, device=device)
    theta, phi = torch.meshgrid(theta_i, phi_j, indexing="ij")
    v_range = vfov[1] - vfov[0]
    theta = (90 - vfov[1] + theta / H * v_range) * math.pi / 180
    h_range = hfov[1] - hfov[0]
    phi = (hfov[0] + phi / W * h_range) * math.pi / 180
    dx = torch.sin(theta) * torch.sin(phi)
    dz = torch.sin(theta) * torch.cos(phi)
    dy = -torch.cos(theta)
    d = torch.stack([dx, dy, dz], dim=0)
    return d / torch.linalg.norm(d, dim=0, keepdim=True)


def pano_to_lidar(range_image: torch.Tensor, vfov, hfov):
    """Range panorama [1, H, W] -> (points [H*W, 3], valid mask [H*W])."""
    H, W = range_image.shape[-2:]
    dirs = pixel_dirs(H, W, vfov, hfov, device=range_image.device)
    pts = (dirs * range_image).reshape(3, -1).T
    mask = (range_image > 0).reshape(-1)
    return pts, mask


def pano_to_lidar_np(range_image: np.ndarray, vfov, hfov) -> np.ndarray:
    """The valid points of a numpy range panorama [1, H, W], as numpy
    [N, 3] float32 (the ragged variant for exports such as .ply files)."""
    pts, mask = pano_to_lidar(
        torch.as_tensor(np.asarray(range_image, np.float32)), vfov, hfov)
    return pts[mask].numpy()


def depth_to_normal(range_image: torch.Tensor, vfov, hfov) -> torch.Tensor:
    """Central-difference normals of a range panorama [1, H, W] -> [3, H, W]
    with a zero border ring (utils/graphics_utils.py:121-149)."""
    H, W = range_image.shape[-2:]
    points = pixel_dirs(H, W, vfov, hfov, device=range_image.device) \
        * range_image
    dxv = points[:, 2:, 1:-1] - points[:, :-2, 1:-1]
    dyv = points[:, 1:-1, 2:] - points[:, 1:-1, :-2]
    n = torch.linalg.cross(dxv, dyv, dim=0)
    n = n / torch.sqrt(torch.sum(n * n, dim=0, keepdim=True) + 1e-24)
    return torch.nn.functional.pad(n, (1, 1, 1, 1))


def project_points_to_pano(points_cam: np.ndarray, intensity: np.ndarray,
                           H: int, W: int, vfov, hfov):
    """Nearest-return z-buffer of camera-frame points into range and
    intensity panoramas: ([1, H, W], [1, H, W]) float32 numpy. Uses the
    native C++ z-buffer when it builds (native/gslidar_native.cpp), else
    the numpy lexsort below (sort by (pixel, range), keep the first)."""
    from gslidar_tpu_torch.native import get_native
    nat = get_native()
    if nat is not None:
        return nat.project_pano(
            np.ascontiguousarray(points_cam[:, :3], np.float32),
            np.ascontiguousarray(intensity, np.float32),
            int(H), int(W), float(vfov[0]), float(vfov[1]),
            float(hfov[0]), float(hfov[1]))

    x, y, z = points_cam[:, 0], points_cam[:, 1], points_cam[:, 2]
    phi = np.arctan2(x, z)
    theta = np.arctan2(np.sqrt(x ** 2 + z ** 2), -y)
    r = np.sqrt(x ** 2 + y ** 2 + z ** 2)
    VFOV_min, VFOV_max, HFOV_min, HFOV_max = fov_bounds(vfov, hfov)

    ti = (theta - VFOV_min) * H / (VFOV_max - VFOV_min)
    pj = (phi - HFOV_min) * W / (HFOV_max - HFOV_min)

    keep = (ti >= -0.5) & (ti < H - 0.5) & (pj >= -0.5) & (pj < W - 0.5)
    ti, pj, r, inten = ti[keep], pj[keep], r[keep], intensity[keep]
    ui = np.around(ti).astype(np.int64)
    uj = np.around(pj).astype(np.int64)
    flat = ui * W + uj

    order = np.lexsort((r, flat))
    flat, r, inten = flat[order], r[order], inten[order]
    first = np.ones(flat.shape[0], dtype=bool)
    first[1:] = flat[1:] != flat[:-1]

    depth = np.zeros(H * W, dtype=np.float32)
    inten_img = np.zeros(H * W, dtype=np.float32)
    depth[flat[first]] = r[first]
    inten_img[flat[first]] = inten[first]
    return depth.reshape(1, H, W), inten_img.reshape(1, H, W)
