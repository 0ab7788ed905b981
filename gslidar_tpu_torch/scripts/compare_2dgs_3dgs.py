"""Panoramic 2DGS (surface) vs 3DGS (volume) splatting comparison (the
port of scripts/compare_2dgs_3dgs.py).

A dense renderer on a deterministic synthetic scene (a planar grid of
disks), used to look at the splatting math (reference
scripts/compare_2dgs_3dgs.py, README.md:126-129):

* 2DGS surface splatting: the exact ray-disk intersection of the
  compositor (``raster/preprocess.py::build_transmat``'s splat frame),
  with the exact ray depth;
* 3DGS volume splatting: full 3-D covariances projected through the
  first-order panorama Jacobian (reference :116-148), each splat at one
  constant depth.

    python -m gslidar_tpu_torch.scripts.compare_2dgs_3dgs [--device cpu]
        [--out eval_output/compare_2dgs_3dgs]

writes case1.png (8 x 8 disks) and case2.png (2 x 2): the two colour
images over the two depth maps.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from gslidar_tpu_torch.raster.preprocess import build_transmat, quat_to_rotmat
from gslidar_tpu_torch.utils.general import (make_image_grid, save_image,
                                             visualize_depth)

VFOV = (-20.0, 20.0)
HFOV = (-90.0, 90.0)
H, W = 150, 625


def angle_bounds():
    VFOV_max = np.pi / 2 - VFOV[0] * np.pi / 180
    VFOV_min = np.pi / 2 - VFOV[1] * np.pi / 180
    HFOV_max = HFOV[1] * np.pi / 180
    HFOV_min = HFOV[0] * np.pi / 180
    return VFOV_min, VFOV_max, HFOV_min, HFOV_max


def pixel_grid(H, W, device):
    """Pixel x and y, row-major over [H, W], float32."""
    py, px = torch.meshgrid(torch.arange(H, dtype=torch.float32,
                                         device=device),
                            torch.arange(W, dtype=torch.float32,
                                         device=device), indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def pixel_angles(H, W, device):
    VFOV_min, VFOV_max, HFOV_min, HFOV_max = angle_bounds()
    px, py = pixel_grid(H, W, device)
    phi = px * (HFOV_max - HFOV_min) / W + HFOV_min
    theta = py * (VFOV_max - VFOV_min) / H + VFOV_min
    return phi, theta


def blend_weights(alpha):
    """Front-to-back weights w_i = alpha_i * prod_{j<i}(1 - alpha_j)."""
    T = torch.cat([torch.ones_like(alpha[:1]),
                   torch.cumprod(1 - alpha, dim=0)[:-1]], dim=0)
    return T * alpha


def surface_splatting(means3D, scales, quats, colors, opacity, viewmat, H,
                      W):
    """2DGS: the exact ray-disk intersection at every pixel."""
    T, _ = build_transmat(means3D, scales, quats, viewmat)
    order = torch.argsort(torch.linalg.norm(T[:, 2], dim=-1), stable=True)
    T, colors, opacity = T[order], colors[order], opacity[order]

    phi, theta = pixel_angles(H, W, means3D.device)
    sp, cp = torch.sin(phi)[None, :, None], torch.cos(phi)[None, :, None]
    st, ct = torch.sin(theta)[None, :, None], torch.cos(theta)[None, :, None]
    # component triples across (u_cam, v_cam, p_cam)
    Tx, Ty, Tz = T[:, None, :, 0], T[:, None, :, 1], T[:, None, :, 2]
    k = cp * Tx - sp * Tz
    l = sp * ct * Tx + st * Ty + cp * ct * Tz
    p = torch.linalg.cross(k, l, dim=-1)
    s = p[..., :2] / torch.where(p[..., 2:] == 0, 1.0, p[..., 2:])
    dist2 = torch.sum(s * s, dim=-1)                       # [P, pix]
    sh = torch.cat([s, torch.ones_like(s[..., :1])], -1)
    depth = (torch.sum(sh * Tx, -1) * st[..., 0] * sp[..., 0]
             - torch.sum(sh * Ty, -1) * ct[..., 0]
             + torch.sum(sh * Tz, -1) * st[..., 0] * cp[..., 0])
    alpha = opacity[:, None] * torch.exp(-0.5 * dist2) * (dist2 < 1.0)
    w = blend_weights(alpha)
    img = torch.einsum("pk,pc->kc", w, colors)
    dmap = torch.sum(w * depth, dim=0)          # the exact ray depth
    return img.reshape(H, W, -1), dmap.reshape(H, W)


def volume_splatting(means3D, scales, quats, colors, opacity, viewmat, H,
                     W):
    """3DGS: the full covariance through the panorama Jacobian
    (reference compare_2dgs_3dgs.py:116-148,283-320)."""
    VFOV_min, VFOV_max, HFOV_min, HFOV_max = angle_bounds()
    R = quat_to_rotmat(quats)
    L = R * scales[:, None, :]
    cov3d = L @ L.transpose(1, 2)

    Rw2c = viewmat[:3, :3]
    t = means3D @ Rw2c.T + viewmat[:3, 3]
    tx, ty, tz = t[:, 0], t[:, 1], t[:, 2]
    r_xz = torch.sqrt(tx * tx + tz * tz)
    r2 = tx * tx + ty * ty + tz * tz
    Wpi = W / (HFOV_max - HFOV_min)
    Hrange = H / (VFOV_max - VFOV_min)
    zero = torch.zeros_like(tx)
    J = torch.stack([
        torch.stack([Wpi * tz / (r_xz * r_xz), zero,
                     -Wpi * tx / (r_xz * r_xz)], -1),
        torch.stack([-Hrange * tx * ty / (r_xz * r2), Hrange * r_xz / r2,
                     -Hrange * ty * tz / (r_xz * r2)], -1)], -2)
    cov_cam = Rw2c[None] @ cov3d @ Rw2c.T[None]
    cov2d = J @ cov_cam @ J.transpose(1, 2)                # [P, 2, 2]

    phi = torch.atan2(tx, tz)
    theta = torch.atan2(r_xz, -ty)
    mean2d = torch.stack([(phi - HFOV_min) * W / (HFOV_max - HFOV_min),
                          (theta - VFOV_min) * H / (VFOV_max - VFOV_min)],
                         -1)
    depth = torch.sqrt(r2)

    order = torch.argsort(depth, stable=True)
    cov2d, mean2d, depth = cov2d[order], mean2d[order], depth[order]
    colors, opacity = colors[order], opacity[order]

    conic = torch.linalg.inv(cov2d)
    px, py = pixel_grid(H, W, means3D.device)
    dx = px[None] - mean2d[:, None, 0]                     # [P, pix]
    dy = py[None] - mean2d[:, None, 1]
    dist2 = (dx ** 2 * conic[:, None, 0, 0] + dy ** 2 * conic[:, None, 1, 1]
             + 2 * dx * dy * conic[:, None, 0, 1])
    alpha = opacity[:, None] * torch.exp(-0.5 * dist2) * (dist2 < 1.0)
    w = blend_weights(alpha)
    img = torch.einsum("pk,pc->kc", w, colors)
    dmap = torch.sum(w * depth[:, None], dim=0)  # one depth per splat
    return img.reshape(H, W, -1), dmap.reshape(H, W)


def make_scene(num_points=8, seed=2023, device="cpu"):
    """A planar grid of disks with one shared random orientation
    (reference compare_2dgs_3dgs.py:357-371)."""
    rng = np.random.default_rng(seed)
    length = 1.5
    xs = np.linspace(-1, 1, num_points) * length
    x, y = np.meshgrid(xs, xs)
    means = np.stack([x, y, np.zeros_like(x)], -1).reshape(-1, 3)
    quat = rng.normal(size=4)
    quat /= np.linalg.norm(quat)
    R = quat_to_rotmat(torch.tensor(quat[None], dtype=torch.float32))[0]
    means = means @ R.numpy().astype(np.float64).T
    means[:, 2] += 4.0                                   # in front
    scale = length / (num_points - 1)
    scales = np.full((len(means), 3), scale, np.float32)
    scales[:, 2] = 1e-6
    quats = np.tile(quat, (len(means), 1)).astype(np.float32)
    colors = rng.uniform(0.2, 1.0, (len(means), 3)).astype(np.float32)
    opacity = np.ones(len(means), np.float32)
    return tuple(torch.tensor(np.asarray(a, np.float32), device=device)
                 for a in (means, scales, quats, colors, opacity))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="eval_output/compare_2dgs_3dgs")
    a = p.parse_args(argv)
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    os.makedirs(a.out, exist_ok=True)
    viewmat = torch.eye(4, device=device)
    for case, n in (("case1", 8), ("case2", 2)):
        scene = make_scene(n, device=device)
        img1, d1 = surface_splatting(*scene, viewmat, H, W)
        img2, d2 = volume_splatting(*scene, viewmat, H, W)
        grid = make_image_grid([
            img1.permute(2, 0, 1).cpu().numpy(),
            img2.permute(2, 0, 1).cpu().numpy(),
            visualize_depth(d1.cpu().numpy()[None], 1.0, 6.0),
            visualize_depth(d2.cpu().numpy()[None], 1.0, 6.0)], nrow=2)
        save_image(grid, os.path.join(a.out, f"{case}.png"))
        print(f"saved {case}.png  (2DGS exact depth vs 3DGS constant depth)")


if __name__ == "__main__":
    main()
