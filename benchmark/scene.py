"""The seeded scene of a cell: a drive, its LiDAR returns, the gaussians
made from them, the cameras and their ground-truth panoramas.

Everything is drawn on the device by ``torch.Generator``s, in a few
large calls, so that a 10M-gaussian model is made in well under a
second. The drive's returns and the gaussians' rotations come from the
configuration's ``scene_seed``, the same in every run, as a recorded
sequence is the same in every training run; the gaussians' colours and
velocities come from ``--seed``, so the same seed gives the same model.
Units are the scene's: metres times the configuration's
``scale_factor`` (0.1, the KITTI-360 loader's fixed pose
normalisation).

The drive is straight along +z, ``metres_per_frame`` per frame, the
sensor ``sensor_height_m`` above a flat road between two walls. Each
return is a ray of one frame's sensor, uniform in the configuration's
vertical field of view and in azimuth, ending where it meets the road or
a wall within ``max_range_m`` (rays that meet neither are dropped, as a
LiDAR drops them). The camera frame is the renderer's: +z forward, +x
right, -y up; the front camera of a frame looks along +z and the back
camera, its 180-degree turn about y, along -z.

The gaussians follow ``create_from_pcd``'s formulas (reference
scene/gaussian_model.py:195-276): SH DC from a random colour and the
ray-drop channel at 1 %, the rest of the SH zero, uniform random
quaternions, opacity 0.05, the ray-drop intensity at 1 %, each point's
time its frame's, the temporal scale from ``t_init``. The scale comes not
from a 3-NN search (about 25 s at 10M) but from the density of the
returns: with n returns in a voxel of side v on a surface, the mean
squared distance to the 3 nearest is 2 v^2 / (pi n).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

VOXEL_M = 0.5
SH_C0 = 0.28209479177387814


class Cam(NamedTuple):
    """One camera as the training step reads it."""
    viewmat: torch.Tensor        # [4, 4] world -> camera, row-major
    campos: torch.Tensor         # [3]
    timestamp: float
    towards_idx: int             # 0 = forward, 1 = backward
    pts_depth: torch.Tensor      # [1, h, w] GT range (0 = no return)
    pts_intensity: torch.Tensor  # [1, h, w]


class Scene(NamedTuple):
    points: torch.Tensor         # [P, 3] the returns the gaussians come from
    rotations: torch.Tensor      # [P, 4] the gaussians' quaternions
    intensity: torch.Tensor      # [P]
    times: torch.Tensor          # [P] each return's frame time
    frame_times: list            # per frame of the sequence
    train_frames: list           # indices of the frames used for training


def rgb2sh(x):
    return (x - 0.5) / SH_C0


def frame_times(n_frames: int, run) -> list:
    t0, t1 = run["time_duration"]
    return [t0 + (t1 - t0) * f / (n_frames - 1) for f in range(n_frames)]


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def draw_returns(config, n: int, g: torch.Generator, device):
    """n LiDAR returns of the drive, in metres: (points [n, 3], frame
    index [n], intensity [n])."""
    drive, run = config["drive"], config["run"]
    first, last = config["frames"]
    n_frames = last - first + 1
    e0, e1 = (math.radians(v) for v in run["vfov"])
    h = drive["sensor_height_m"]
    left, right = drive["wall_offset_m"]
    pts, frames, inten = [], [], []
    got = 0
    while got < n:
        m = int((n - got) * 1.6) + 1024
        u = torch.rand(5, m, generator=g, device=device)
        frame = torch.clamp((u[0] * n_frames).long(), max=n_frames - 1)
        elev = e0 + (e1 - e0) * u[1]
        azim = (2.0 * u[2] - 1.0) * math.pi
        d = torch.stack([torch.cos(elev) * torch.sin(azim), -torch.sin(elev),
                         torch.cos(elev) * torch.cos(azim)], 1)
        inf = torch.full_like(elev, float("inf"))
        r_road = torch.where(d[:, 1] > 1e-6, h / d[:, 1].clamp_min(1e-6), inf)
        lat = torch.where(d[:, 0] > 0, right, left)
        r_wall = torch.where(d[:, 0].abs() > 1e-6,
                             lat / d[:, 0].abs().clamp_min(1e-6), inf)
        r = torch.minimum(r_road, r_wall)
        r = r + drive["range_noise_m"] * (2.0 * u[3] - 1.0)
        ok = (r >= drive["min_range_m"]) & (r <= drive["max_range_m"])
        centre = torch.zeros(m, 3, device=device)
        centre[:, 2] = frame.to(torch.float32) * drive["metres_per_frame"]
        p = centre + r[:, None] * d
        lo, hi = drive["intensity"]
        pts.append(p[ok])
        frames.append(frame[ok])
        inten.append(lo + (hi - lo) * u[4][ok])
        got += int(ok.sum())
    return (torch.cat(pts)[:n], torch.cat(frames)[:n], torch.cat(inten)[:n])


def density_dist2(points_m: torch.Tensor) -> torch.Tensor:
    """[P] the mean squared distance to the 3 nearest returns, in m^2,
    from the returns per voxel: 2 v^2 / (pi n)."""
    v = VOXEL_M
    idx = torch.floor(points_m / v).to(torch.int64)
    idx = idx - idx.min(0).values
    dims = idx.max(0).values + 1
    key = (idx[:, 0] * dims[1] + idx[:, 1]) * dims[2] + idx[:, 2]
    counts = torch.bincount(key)
    n = counts[key].to(torch.float32)
    return 2.0 * v * v / (math.pi * n)


def make_scene(config, device) -> Scene:
    """The returns, the gaussians' rotations and the frames of a
    configuration: drawn from its ``scene_seed``, the same in every run,
    so that every seed renders splats of the same footprints (the
    instances, the work and the peak memory of a view do not move with
    the seed)."""
    run = config["run"]
    g = generator(config["scene_seed"], device)
    pts_m, frame, inten = draw_returns(config, config["gaussians"], g, device)
    first, last = config["frames"]
    n_frames = last - first + 1
    times = torch.tensor(frame_times(n_frames, run), device=device)[frame]
    val = set(config["val_frames"])
    train = [f for f in range(n_frames) if first + f not in val]
    rotations = torch.rand(pts_m.shape[0], 4, generator=g, device=device)
    return Scene(points=pts_m, rotations=rotations, intensity=inten,
                 times=times,
                 frame_times=frame_times(n_frames, run), train_frames=train)


def make_params(config, scene: Scene, seed: int) -> dict:
    """The gaussians of ``scene`` in the program's parameter layout
    (float32, [P, ...] per group), drawn from ``seed``."""
    run = config["run"]
    sf = run["scale_factor"]
    device = scene.points.device
    g = generator(seed, device)
    P = scene.points.shape[0]
    K = (run["sh_degree"] + 1) ** 2
    t0, t1 = run["time_duration"]
    colors = torch.rand(P, 3, generator=g, device=device)
    f_dc = torch.empty(P, 1, 4, device=device)
    f_dc[:, 0, :3] = rgb2sh(colors)
    f_dc[:, 0, 3] = rgb2sh(0.01)
    dist2 = torch.clamp_min(density_dist2(scene.points) * sf * sf, 1e-7)
    scaling = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    velocity = torch.zeros(P, 3, device=device)
    if run["dynamic"]:
        velocity = torch.randn(P, 3, generator=g, device=device) \
            * config["velocity_std"]
    return {
        "xyz": (scene.points * sf).contiguous(),
        "f_dc": f_dc,
        "f_rest": torch.zeros(P, K - 1, 4, device=device),
        "opacity": torch.full((P, 1), math.log(0.05 / 0.95), device=device),
        "scaling": scaling.contiguous(),
        "rotation": scene.rotations,
        "t": scene.times[:, None].contiguous(),
        "scaling_t": torch.full((P, 1), math.log(math.sqrt(
            (t1 - t0) * run["t_init"])), device=device),
        "velocity": velocity,
        "intensity": torch.full((P, 1), math.log(0.01 / 0.99),
                                device=device),
    }


def pose(config, frame: int):
    """The front camera's centre at ``frame``, in scene units: [3] float64
    numpy."""
    sf = config["run"]["scale_factor"]
    return np.array([0.0, 0.0,
                     frame * config["drive"]["metres_per_frame"]]) * sf


def viewmat(centre, towards_idx: int) -> np.ndarray:
    """[4, 4] float32 world -> camera of a camera at ``centre``: the front
    camera is axis-aligned, the back one turned 180 degrees about y."""
    R = np.eye(3) if towards_idx == 0 else np.diag([-1.0, 1.0, -1.0])
    M = np.eye(4)
    M[:3, :3] = R
    M[:3, 3] = -R @ centre
    return M.astype(np.float32)


def project(points, intensity, view: torch.Tensor, h: int, w: int, vfov,
            hfov):
    """Nearest-return z-buffer of world points into a camera's range and
    intensity panoramas ([1, h, w] each), pixels rounded as the
    KITTI-360 loader rounds them (round half to even)."""
    p = points @ view[:3, :3].T + view[:3, 3]
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    phi = torch.atan2(x, z)
    theta = torch.atan2(torch.sqrt(x * x + z * z), -y)
    r = torch.sqrt(x * x + y * y + z * z)
    vmax = math.pi / 2 - math.radians(vfov[0])
    vmin = math.pi / 2 - math.radians(vfov[1])
    hmin, hmax = math.radians(hfov[0]), math.radians(hfov[1])
    ti = (theta - vmin) * h / (vmax - vmin)
    pj = (phi - hmin) * w / (hmax - hmin)
    keep = (ti >= -0.5) & (ti < h - 0.5) & (pj >= -0.5) & (pj < w - 0.5)
    flat = torch.round(ti[keep]).long() * w + torch.round(pj[keep]).long()
    r, inten = r[keep], intensity[keep]
    depth = torch.full((h * w,), float("inf"), device=points.device)
    depth.scatter_reduce_(0, flat, r, reduce="amin")
    nearest = r == depth[flat]
    out_i = torch.zeros(h * w, device=points.device)
    out_i[flat[nearest]] = inten[nearest]
    depth = torch.where(torch.isinf(depth), 0.0, depth)
    return depth.reshape(1, h, w), out_i.reshape(1, h, w)


def train_cameras(config, scene: Scene) -> list:
    """The front and back camera of every training frame, in frame order,
    with their GT panoramas projected from the scene's returns."""
    run = config["run"]
    h, w = run["hw"]
    sf = run["scale_factor"]
    device = scene.points.device
    world = scene.points * sf
    cams = []
    for f in scene.train_frames:
        c = pose(config, f)
        for towards in (0, 1):
            vm = torch.tensor(viewmat(c, towards), device=device)
            d, i = project(world, scene.intensity, vm, h, w, run["vfov"],
                           run["hfov"])
            cams.append(Cam(viewmat=vm, campos=torch.tensor(
                c, dtype=torch.float32, device=device),
                timestamp=float(scene.frame_times[f]), towards_idx=towards,
                pts_depth=d, pts_intensity=i))
    return cams
