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
