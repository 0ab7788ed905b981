"""Image and depth loss primitives (port of gslidar_tpu/ops/losses.py;
reference utils/loss_utils.py).

Masked means are sum / count, as in the JAX package, so an empty mask
gives 0 rather than NaN. ``abs_`` is |x| with jax.numpy.abs's gradient.
"""

from __future__ import annotations

import torch

EPS = 1e-5


def abs_(x):
    """|x| whose gradient at x = 0 is 1, as jax.numpy.abs's (torch.abs has
    0 there). It matters: the velocity regularizer sees exactly zero
    features while the velocities are at their initial 0."""
    return torch.where(x >= 0, x, -x)


def masked_l1(pred, target, mask):
    """L1 over mask, equivalent to F.l1_loss(target[mask], pred[mask])."""
    mask = mask.to(pred.dtype)
    denom = torch.clamp_min(mask.sum(), 1.0)
    return torch.sum(abs_(pred - target) * mask) / denom


def binary_cross_entropy(pred, target, eps: float = 1e-7):
    pred = torch.clamp(pred, eps, 1.0 - eps)
    return -torch.mean(target * torch.log(pred)
                       + (1 - target) * torch.log(1 - pred))


def tv_loss(depth):
    """Total variation, reference utils/loss_utils.py:65-71."""
    c, h, w = depth.shape
    count_h = c * (h - 1) * w
    count_w = c * h * (w - 1)
    h_tv = torch.sum(torch.square(depth[..., 1:, :] - depth[..., :-1, :]))
    w_tv = torch.sum(torch.square(depth[..., :, 1:] - depth[..., :, :-1]))
    return 2 * (h_tv / count_h + w_tv / count_w)


def grad_smooth_loss(pred_depth, gt_depth, grad_clip):
    """Masked gradient-matching smoothness (reference train.py:269-289)."""
    gt_gx = gt_depth[:, :, :-1] - gt_depth[:, :, 1:]
    gt_gy = gt_depth[:, :-1, :] - gt_depth[:, 1:, :]
    mx = (gt_depth[:, :, :-1] > 0) & (gt_depth[:, :, 1:] > 0)
    my = (gt_depth[:, :-1, :] > 0) & (gt_depth[:, 1:, :] > 0)
    gmx = (torch.abs(gt_gx) < grad_clip) & mx
    gmy = (torch.abs(gt_gy) < grad_clip) & my
    pr_gx = pred_depth[:, :, :-1] - pred_depth[:, :, 1:]
    pr_gy = pred_depth[:, :-1, :] - pred_depth[:, 1:, :]
    return masked_l1(pr_gx, gt_gx, gmx) + masked_l1(pr_gy, gt_gy, gmy)
