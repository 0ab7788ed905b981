"""The training losses.

A frozen copy of the port's plain PyTorch version (ops/losses.py,
ops/chamfer.py, engine/losses.py), held here so that a change to the
program cannot move the reference it is judged by. It imports nothing of
the program."""

from __future__ import annotations

import math

import torch

from benchmark.reference.geometry import depth_to_normal, pano_to_lidar

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


def _one_sided_min_sqdist(a, b, chunk: int):
    """For each a[i]: min_j ||a_i - b_j||^2 ([N]; zeros when b is empty)."""
    if b.shape[0] == 0:
        return a.new_zeros(a.shape[0])
    bsq = torch.sum(b * b, dim=-1).detach()
    out = []
    for i in range(0, a.shape[0], chunk):
        blk = a[i:i + chunk]
        with torch.no_grad():
            d2 = (torch.sum(blk * blk, dim=-1)[:, None] + bsq[None, :]
                  - 2.0 * blk @ b.T)
            nn = torch.argmin(d2, dim=1)
        out.append(torch.sum((blk - b[nn]) ** 2, dim=-1))
    return torch.cat(out) if out else a.new_zeros(0)


def chamfer_distance(x1, x2, mask1=None, mask2=None, chunk: int = 4096):
    """Two-sided squared chamfer terms.

    Args:
        x1: [N, 3], x2: [M, 3]; mask*: boolean validity (None = all valid).
    Returns:
        (dist1 [N], dist2 [M], mean1, mean2): squared distances (0 at
        invalid points) and their means over the valid points
        (reference train.py:256-267).
    """
    if mask1 is None:
        mask1 = torch.ones(x1.shape[0], dtype=torch.bool, device=x1.device)
    if mask2 is None:
        mask2 = torch.ones(x2.shape[0], dtype=torch.bool, device=x2.device)
    a, b = x1[mask1], x2[mask2]
    d1 = x1.new_zeros(x1.shape[0]).masked_scatter(
        mask1, _one_sided_min_sqdist(a, b, chunk))
    d2 = x2.new_zeros(x2.shape[0]).masked_scatter(
        mask2, _one_sided_min_sqdist(b, a, chunk))
    n1 = torch.clamp_min(mask1.sum(), 1)
    n2 = torch.clamp_min(mask2.sum(), 1)
    return d1, d2, d1.sum() / n1, d2.sum() / n2


def compute_losses(pkg, pts_depth, pts_intensity, iteration,
                   args, opacity_act, alive):
    """Returns (total loss, log dict of tensors). pts_* are [1, H, W] GT
    panoramas; iteration is a python number."""
    log = {}
    loss = 0.0
    depth = pkg.depth
    alpha = pkg.alpha

    if args.sky_depth:
        sky_depth = 900
        depth = depth / torch.clamp_min(alpha, EPS)
        if args.depth_blend_mode == 0:      # harmonic mean
            depth = 1 / torch.clamp_min(
                alpha / torch.clamp_min(depth, EPS)
                + (1 - alpha) / sky_depth, EPS)
        elif args.depth_blend_mode == 1:
            depth = alpha * depth + (1 - alpha) * sky_depth

    mask = pts_depth > 0

    if args.lambda_distortion > 0:
        lam = args.lambda_distortion if iteration > 3000 else 0.0
        l = torch.mean(pkg.distortion)
        log["loss_distortion"] = l
        loss += lam * l

    if args.lambda_lidar > 0:
        l = masked_l1(depth, pts_depth, mask)
        decay = (math.exp(-iteration / 8000.0 * args.lidar_decay)
                 if args.lidar_decay > 0 else 1.0)
        log["loss_lidar"] = l
        loss += decay * args.lambda_lidar * l

    if args.lambda_lidar_median > 0:
        l = masked_l1(pkg.depth_median, pts_depth, mask)
        log["loss_lidar_median"] = l
        loss += args.lambda_lidar_median * l

    feature = pkg.feature / torch.clamp_min(alpha, EPS)
    if args.lambda_t_reg > 0:
        l = -torch.mean(abs_(feature[0:1]))
        log["loss_t_reg"] = l
        loss += args.lambda_t_reg * l

    if args.lambda_v_reg > 0:
        l = torch.mean(abs_(feature[1:4]))
        log["loss_v_reg"] = l
        loss += args.lambda_v_reg * l

    if args.get("lambda_intensity_sh", 0) > 0:
        l = masked_l1(pkg.intensity_sh, pts_intensity, mask)
        log["loss_intensity_sh"] = l
        loss += args.lambda_intensity_sh * l

    if args.lambda_raydrop > 0:
        gt_raydrop = 1.0 - mask.to(torch.float32)
        l = binary_cross_entropy(pkg.raydrop, gt_raydrop)
        log["loss_raydrop"] = l
        loss += args.lambda_raydrop * l

    if args.lambda_chamfer > 0:
        pred_pts, pred_mask = pano_to_lidar(depth * mask, args.vfov,
                                            args.hfov)
        gt_pts, gt_mask = pano_to_lidar(pts_depth, args.vfov, args.hfov)
        sf = args.scale_factor
        _, _, m1, m2 = chamfer_distance(pred_pts / sf, gt_pts / sf,
                                        mask1=pred_mask, mask2=gt_mask)
        l = m1 + m2
        log["loss_chamfer"] = l
        loss += args.lambda_chamfer * l

    if args.lambda_smooth > 0:
        l = grad_smooth_loss(depth, pts_depth, 0.01 * args.scale_factor)
        log["loss_smooth"] = l
        loss += args.lambda_smooth * l

    if args.lambda_tv > 0:
        l = tv_loss(depth)
        log["loss_tv"] = l
        loss += args.lambda_tv * l

    if args.lambda_gs_opa > 0:
        o = torch.clamp(opacity_act, 1e-6, 1 - 1e-6)
        l = torch.sum(((1 - o) ** 2) * alive) / torch.clamp_min(
            torch.sum(alive), 1)
        log["loss_gs_opa"] = l
        loss += args.lambda_gs_opa * l

    if args.lambda_normal_consistency > 0:
        lam = args.lambda_normal_consistency if iteration > 7000 else 0.0
        surf_normal = depth_to_normal(depth, args.vfov, args.hfov)
        l = torch.mean(1 - torch.sum(pkg.normal * surf_normal,
                                     dim=0)[1:-1, 1:-1])
        log["loss_normal_consistency"] = l
        loss += lam * l

    if args.lambda_opacity_entropy > 0:
        o = torch.clamp(alpha, 1e-6, 1 - 1e-6)
        l = -torch.mean(o * torch.log(o))
        log["loss_opacity_entropy"] = l
        loss += args.lambda_opacity_entropy * l

    if args.lambda_depth_var > 0:
        depth_var = pkg.depth_square - pkg.depth ** 2
        l = torch.mean(torch.sqrt(torch.clamp_min(depth_var, 1e-6)))
        log["loss_depth_var"] = l
        lam = args.lambda_depth_var if iteration > 3000 else 0.0
        loss += lam * l

    log["loss"] = loss
    return loss, log

