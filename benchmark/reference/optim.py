"""Per-group Adam and the ray-drop prior's Adam.

A frozen copy of the port's plain PyTorch version (models/optim.py,
models/raydrop_prior.py), held here so that a change to the program
cannot move the reference it is judged by. It imports nothing of the
program."""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

from benchmark.reference.model import PARAM_KEYS, Params


class AdamState(NamedTuple):
    mu: Params
    nu: Params
    count: int

B1, B2, EPS = 0.9, 0.999, 1e-15
ADAM_EPS = 1e-15


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1000000) -> float:
    """Log-linear decay (reference utils/general_utils.py:61-94; the JAX
    package's expon_lr_jnp)."""
    if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
        return 0.0
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
    else:
        delay_rate = 1.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return delay_rate * math.exp(math.log(lr_init) * (1 - t)
                                 + math.log(lr_final) * t)


def group_lrs(args, iteration) -> Dict[str, float]:
    """Per-group learning rates at ``iteration`` (training_setup and
    update_learning_rate, gaussian_model.py:285-321; spatial_lr_scale 1)."""
    final_decay = args.position_lr_final / args.position_lr_init
    return {
        "xyz": expon_lr(iteration, args.position_lr_init,
                        args.position_lr_final,
                        lr_delay_mult=args.position_lr_delay_mult,
                        max_steps=args.iterations),
        "t": expon_lr(iteration, args.t_lr_init,
                      args.t_lr_init * final_decay,
                      lr_delay_mult=args.position_lr_delay_mult,
                      max_steps=args.iterations),
        "f_dc": args.feature_lr,
        "f_rest": args.feature_lr / 20.0,
        "opacity": args.opacity_lr,
        "scaling": args.scaling_lr,
        "rotation": args.rotation_lr,
        "scaling_t": args.scaling_t_lr,
        "intensity": args.intensity_lr,
        "velocity": args.velocity_lr if args.dynamic else 0.0,
    }


def adam_step(params: Params, grads: Params, state: AdamState,
              lrs: Dict[str, float]) -> tuple[Params, AdamState]:
    """One Adam step of every group; returns new tensors."""
    count = state.count + 1
    c1 = 1.0 - B1 ** count
    c2 = 1.0 - B2 ** count
    new_p, new_mu, new_nu = {}, {}, {}
    for k in PARAM_KEYS:
        g = grads[k]
        mu = B1 * state.mu[k] + (1 - B1) * g
        nu = B2 * state.nu[k] + (1 - B2) * g * g
        update = (mu / c1) / (torch.sqrt(nu / c2) + EPS)
        new_p[k] = params[k] - lrs[k] * update
        new_mu[k], new_nu[k] = mu, nu
    return new_p, AdamState(mu=new_mu, nu=new_nu, count=count)


def init_raydrop_prior(h: int, w: int, device="cpu") -> torch.Tensor:
    return torch.full((1, h, 2 * w), math.log(0.1 / 0.9),
                      dtype=torch.float32, device=device)


class PriorAdam:
    """The prior's own Adam, torch.optim.Adam(lr, eps=1e-15). The state
    is (first moment, second moment, step count)."""

    @staticmethod
    def init(param: torch.Tensor):
        return (torch.zeros_like(param), torch.zeros_like(param), 0)

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

