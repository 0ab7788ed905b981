"""Learned per-pixel ray-drop prior (port of
gslidar_tpu/models/raydrop_prior.py; reference scene/raydrop_prior.py):
a logit panorama [1, H, 2W] initialized at sigmoid^-1(0.1); the forward
slices the front or back half and applies sigmoid; its own Adam."""

from __future__ import annotations

import math

import torch

ADAM_EPS = 1e-15


def init_raydrop_prior(h: int, w: int, device="cpu") -> torch.Tensor:
    return torch.full((1, h, 2 * w), math.log(0.1 / 0.9),
                      dtype=torch.float32, device=device)


def raydrop_prior_forward(param: torch.Tensor, towards: str) -> torch.Tensor:
    """Front/back half in [0, 1] (reference raydrop_prior.py:29-37)."""
    w = param.shape[-1] // 2
    if towards == "forward":
        sl = param[:, :, :w]
    elif towards == "backward":
        sl = param[:, :, w:]
    else:
        raise NotImplementedError(towards)
    return torch.sigmoid(sl)


def _linspace(n_src: int, n_dst: int, device) -> torch.Tensor:
    """numpy.linspace(0, n_src - 1, n_dst) in float64, computed as numpy
    computes it (i * step, the last sample set to the end)."""
    i = torch.arange(n_dst, dtype=torch.float64, device=device)
    if n_dst == 1:
        return i
    out = i * ((n_src - 1) / (n_dst - 1))
    out[-1] = n_src - 1
    return out


def raydrop_prior_upscale(param: torch.Tensor, h: int, w: int
                          ) -> torch.Tensor:
    """Bilinear resize to [1, h, 2w] on a coarse-to-fine step (reference
    raydrop_prior.py:39-42, align_corners=True), in float64 as the JAX
    package's numpy version computes it, then cast to float32."""
    src = param[0].to(torch.float64)
    sh, sw = src.shape
    yi = _linspace(sh, h, src.device)
    xi = _linspace(sw, 2 * w, src.device)
    y0, x0 = yi.floor().long(), xi.floor().long()
    y1 = torch.clamp_max(y0 + 1, sh - 1)
    x1 = torch.clamp_max(x0 + 1, sw - 1)
    wy = (yi - y0)[:, None]
    wx = (xi - x0)[None, :]
    out = (src[y0][:, x0] * (1 - wy) * (1 - wx)
           + src[y1][:, x0] * wy * (1 - wx)
           + src[y0][:, x1] * (1 - wy) * wx
           + src[y1][:, x1] * wy * wx)
    return out[None].to(torch.float32)


class PriorAdam:
    """The prior's own Adam, torch.optim.Adam(lr, eps=1e-15)
    (gslidar_tpu/models/raydrop_prior.py::PriorAdam). The state is
    (first moment, second moment, step count)."""

    @staticmethod
    def init(param: torch.Tensor):
        return (torch.zeros_like(param), torch.zeros_like(param), 0)

    @staticmethod
    def from_numpy(state, device):
        """gslidar_tpu's prior Adam state (numpy leaves) -> this one."""
        mu, nu, count = state
        return (torch.as_tensor(mu, dtype=torch.float32, device=device),
                torch.as_tensor(nu, dtype=torch.float32, device=device),
                int(count))

    @staticmethod
    def step(param, grad, state, lr, b1=0.9, b2=0.999):
        mu, nu, count = state
        count = count + 1
        mu = b1 * mu + (1 - b1) * grad
        nu = b2 * nu + (1 - b2) * grad * grad
        c1 = 1 - b1 ** count
        c2 = 1 - b2 ** count
        new = param - lr * (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS)
        return new, (mu, nu, count)
