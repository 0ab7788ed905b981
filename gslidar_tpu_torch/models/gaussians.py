"""4D Gaussian point model: configuration, activations and loading
(port of gslidar_tpu/models/gaussians.py; reference
scene/gaussian_model.py).

Parameters are a plain dict of tensors with the JAX package's keys and
shapes, so a ``gslidar_tpu`` params dict or checkpoint loads unchanged
(``params_from_numpy``). The temporal model (SHM displacement, velocity
decay, gaussian marginal in t) matches gaussian_model.py:151-186.

Tensors are sized exactly to the gaussians there are, as in the
reference: no capacity padding, and ``GaussianAux.alive`` is all True
(the JAX package's fixed-capacity slots are cut to its ``alive`` rows by
the ``*_from_numpy`` conversions).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping

import numpy as np
import torch

from gslidar_tpu_torch.ops.knn import mean_sq_dist_knn3
from gslidar_tpu_torch.ops.sh import rgb2sh

Params = Dict[str, torch.Tensor]

PARAM_KEYS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation",
              "t", "scaling_t", "velocity", "intensity")


@dataclasses.dataclass(frozen=True)
class GaussianConfig:
    """Model hyperparameters (reference scene/gaussian_model.py:45-82)."""
    sh_degree: int = 3
    cycle: float = 0.2                # SHM period args.cycle
    velocity_decay: float = 1.0
    time_duration: tuple = (-0.5, 0.5)
    t_init: float = 0.1
    no_time_split: bool = True
    t_grad: bool = True
    contract: bool = True
    big_point_threshold: float = 0.1
    random_init_point: int = 200000
    percent_dense: float = 0.01
    init_opacity: float = 0.05

    @property
    def max_sh_channels(self) -> int:
        return (self.sh_degree + 1) ** 2


def params_from_numpy(d: Mapping[str, np.ndarray], device,
                      keep=None) -> Params:
    """The JAX package's params dict (numpy arrays under ``PARAM_KEYS``,
    shapes as ``create_from_pcd`` makes them) -> float32 tensors on
    ``device``; ``keep`` (e.g. its ``alive`` mask) selects rows."""
    missing = [k for k in PARAM_KEYS if k not in d]
    if missing:
        raise KeyError(f"params lack {missing}")
    rows = slice(None) if keep is None else np.asarray(keep)
    return {k: torch.as_tensor(np.asarray(d[k], np.float32)[rows],
                               device=device) for k in PARAM_KEYS}


@dataclasses.dataclass
class GaussianAux:
    """Non-learned per-gaussian state and the densification accumulators
    (reference scene/gaussian_model.py:61-65,278-283), [N] each."""
    alive: torch.Tensor                  # bool, all True
    max_radii2D: torch.Tensor
    xyz_gradient_accum: torch.Tensor
    xyz_gradient_accum_abs: torch.Tensor
    t_gradient_accum: torch.Tensor
    denom: torch.Tensor

    @classmethod
    def zeros(cls, n: int, device) -> "GaussianAux":
        def z():
            return torch.zeros(n, dtype=torch.float32, device=device)
        return cls(alive=torch.ones(n, dtype=torch.bool, device=device),
                   max_radii2D=z(), xyz_gradient_accum=z(),
                   xyz_gradient_accum_abs=z(), t_gradient_accum=z(),
                   denom=z())

    @classmethod
    def from_numpy(cls, aux, device) -> "GaussianAux":
        """gslidar_tpu's GaussianAux (numpy leaves) -> its alive rows."""
        keep = np.asarray(aux.alive)
        return cls(**{f.name: torch.as_tensor(np.asarray(getattr(
            aux, f.name))[keep], device=device)
            for f in dataclasses.fields(cls)})


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


def get_xyz_shm(params: Params, timestamp, cfg: GaussianConfig):
    """Simple-harmonic displacement x(t) = x + v sin((t - t0) a) / a,
    a = 2 pi / cycle (gaussian_model.py:151-153)."""
    a = 1.0 / cfg.cycle * math.pi * 2
    return params["xyz"] + params["velocity"] * torch.sin(
        (timestamp - params["t"]) * a) / a


def get_inst_velocity(params: Params, cfg: GaussianConfig) -> torch.Tensor:
    """Velocity with temporal-extent decay (gaussian_model.py:156-157)."""
    return params["velocity"] * torch.exp(
        -get_scaling_t(params) / cfg.cycle / 2 * cfg.velocity_decay)


def get_marginal_t(params: Params, timestamp) -> torch.Tensor:
    """Temporal opacity marginal (gaussian_model.py:185-186)."""
    st = get_scaling_t(params)
    return torch.exp(-0.5 * (params["t"] - timestamp) ** 2 / (st * st))


# ------------------------------ creation ----------------------------------
def create_from_pcd(points: np.ndarray, colors: np.ndarray, times,
                    cfg: GaussianConfig, seed: int = 0,
                    device="cpu") -> tuple[Params, GaussianAux]:
    """Initialize from a fused point cloud (reference
    scene/gaussian_model.py:195-276; gslidar_tpu's create_from_pcd draws
    the same numpy random numbers in the same order, so one seed gives
    both packages the same model): optional far-field sphere and near-box
    points, scales from the 3-NN distances, uniform random rotations,
    opacity 0.05, the ray-drop SH channel at 1 %."""
    rng = np.random.default_rng(seed)
    pts = np.asarray(points, np.float32)
    n_base = pts.shape[0]
    K = cfg.max_sh_channels
    features = np.zeros((n_base, K, 4), np.float32)      # [N, K, C]
    features[:, 0, :3] = rgb2sh(np.asarray(colors, np.float32))

    if cfg.random_init_point > 0:
        # far-field sphere + near box (gaussian_model.py:202-226)
        r_max, r_min = 100000.0, 2.0
        num = cfg.random_init_point
        th = 2 * np.pi * rng.random(num)
        ph = (np.pi / 2 * 0.99 * rng.random(num)) ** 1.5
        s = rng.random(num)
        r = 1.0 / (s / r_min + (1 - s) / r_max)
        pts_sph = np.stack([r * np.cos(th) * np.cos(ph),
                            r * np.sin(th) * np.cos(ph),
                            r * np.sin(ph)], -1)
        pts_rec = np.stack([r_min * (rng.random(num) - 0.5),
                            r_min * (rng.random(num) - 0.5),
                            r_min * rng.random(num)], -1)
        extra = np.concatenate([pts_rec, pts_sph], 0).astype(np.float32)
        extra[:, 2] = -extra[:, 2] + 1
        pts = np.concatenate([pts, extra], 0)
        features = np.concatenate(
            [features, np.zeros((extra.shape[0], K, 4), np.float32)], 0)
    features[:, 0, 3] = float(rgb2sh(0.01))              # raydrop prior 1%

    n = pts.shape[0]
    t0, t1 = cfg.time_duration
    if times is None or times.shape[0] != n_base:
        time_base = (rng.random((n_base, 1)) * 1.2 - 0.1) * (t1 - t0) + t0
    else:
        time_base = np.asarray(times, np.float32).reshape(n_base, 1)
    if cfg.t_init < 1:
        rand_extra = (rng.random((n - n_base, 1)) * 1.2 - 0.1) * (t1 - t0) + t0
        fused_times = np.concatenate([time_base, rand_extra], 0)
    else:
        fused_times = np.full((n, 1), 0.5 * (t0 + t1))

    xyz = torch.as_tensor(pts, device=device)
    dist2 = torch.clamp_min(mean_sq_dist_knn3(xyz), 1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    rots = rng.random((n, 4)).astype(np.float32)         # like torch.rand
    scales_t = np.log(np.sqrt(np.full((n, 1), (t1 - t0) * cfg.t_init,
                                      np.float32)))

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    params: Params = {
        "xyz": xyz,
        "f_dc": t(features[:, 0:1, :]),
        "f_rest": t(features[:, 1:, :]),
        "opacity": torch.full((n, 1), math.log(cfg.init_opacity
                                               / (1 - cfg.init_opacity)),
                              dtype=torch.float32, device=device),
        "scaling": scales.contiguous(),
        "rotation": t(rots),
        "t": t(fused_times),
        "scaling_t": t(scales_t),
        "velocity": torch.zeros((n, 3), dtype=torch.float32, device=device),
        "intensity": torch.full((n, 1), math.log(0.01 / 0.99),
                                dtype=torch.float32, device=device),
    }
    return params, GaussianAux.zeros(n, device)
