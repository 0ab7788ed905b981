"""Training loss assembly (port of gslidar_tpu/engine/losses.py;
reference train.py:201-323).

A term is computed when its lambda in the config is positive. The
iteration schedules are the JAX package's: distortion and depth variance
count from iteration 3001, normal consistency from 7001, and the lidar
term decays with ``lidar_decay``; a scheduled term that is still off is
computed and logged with weight 0.
"""

from __future__ import annotations

import math

import torch

from gslidar_tpu_torch.engine.render import RenderPkg
from gslidar_tpu_torch.ops.chamfer import chamfer_distance
from gslidar_tpu_torch.ops.losses import (EPS, abs_, binary_cross_entropy,
                                          grad_smooth_loss, masked_l1,
                                          tv_loss)
from gslidar_tpu_torch.ops.pano import depth_to_normal, pano_to_lidar


def compute_losses(pkg: RenderPkg, pts_depth, pts_intensity, iteration,
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
