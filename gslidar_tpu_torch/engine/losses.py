"""Training loss assembly (port of gslidar_tpu/engine/losses.py;
reference train.py:201-323).

A term is computed when its lambda in the config is positive. The
iteration schedules are the JAX package's: distortion and depth variance
count from iteration 3001, normal consistency from 7001, and the lidar
term decays with ``lidar_decay``; a scheduled term that is still off is
computed and logged with weight 0 (``loss_weights``). Each term is
computed in a span of its own, ``loss.<term>``.

On the card, while a plane of the render needs a gradient, the terms run
as a captured CUDA graph pair (``engine/loss_graph.py``): the same
kernels in the same order, replayed by one launch for the forward and one
for the backward to the render planes; the ``loss.<term>`` spans then
show only at the capture. The per-gaussian opacity term (``gs_opa``),
whose inputs change length with densification, keeps the eager code, and
so does every call on the CPU.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch

from gslidar_tpu_torch.engine import loss_graph
from gslidar_tpu_torch.engine.render import RenderPkg
from gslidar_tpu_torch.ops.chamfer import chamfer_distance
from gslidar_tpu_torch.ops.losses import (EPS, abs_, binary_cross_entropy,
                                          grad_smooth_loss, masked_l1,
                                          tv_loss)
from gslidar_tpu_torch.ops.pano import depth_to_normal, pano_to_lidar
from gslidar_tpu_torch.utils.trace import span

# the render planes each term reads besides depth, alpha and feature,
# which every call reads
TERM_PLANES = {"distortion": "distortion", "lidar_median": "depth_median",
               "intensity_sh": "intensity_sh", "raydrop": "raydrop",
               "normal_consistency": "normal", "depth_var": "depth_square"}


def loss_weights(args, iteration) -> dict:
    """The weight of each term computed at ``iteration``: {term: Python
    float}, in the order the loss adds the terms. The lidar term's is
    ``decay * lambda_lidar``, formed in double; a weight multiplies its
    float32 term as the float32 it rounds to, whether as a Python number
    (the eager code) or from a float32 vector (the graph)."""
    w = {}
    if args.lambda_distortion > 0:
        w["distortion"] = args.lambda_distortion if iteration > 3000 else 0.0
    if args.lambda_lidar > 0:
        decay = (math.exp(-iteration / 8000.0 * args.lidar_decay)
                 if args.lidar_decay > 0 else 1.0)
        w["lidar"] = decay * args.lambda_lidar
    if args.lambda_lidar_median > 0:
        w["lidar_median"] = args.lambda_lidar_median
    if args.lambda_t_reg > 0:
        w["t_reg"] = args.lambda_t_reg
    if args.lambda_v_reg > 0:
        w["v_reg"] = args.lambda_v_reg
    if args.get("lambda_intensity_sh", 0) > 0:
        w["intensity_sh"] = args.lambda_intensity_sh
    if args.lambda_raydrop > 0:
        w["raydrop"] = args.lambda_raydrop
    if args.lambda_chamfer > 0:
        w["chamfer"] = args.lambda_chamfer
    if args.lambda_smooth > 0:
        w["smooth"] = args.lambda_smooth
    if args.lambda_tv > 0:
        w["tv"] = args.lambda_tv
    if args.lambda_gs_opa > 0:
        w["gs_opa"] = args.lambda_gs_opa
    if args.lambda_normal_consistency > 0:
        w["normal_consistency"] = (args.lambda_normal_consistency
                                   if iteration > 7000 else 0.0)
    if args.lambda_opacity_entropy > 0:
        w["opacity_entropy"] = args.lambda_opacity_entropy
    if args.lambda_depth_var > 0:
        w["depth_var"] = args.lambda_depth_var if iteration > 3000 else 0.0
    return {k: float(v) for k, v in w.items()}


def compute_losses(pkg: RenderPkg, pts_depth, pts_intensity, iteration,
                   args, opacity_act, alive):
    """Returns (total loss, log dict of tensors). pts_* are [1, H, W] GT
    panoramas; iteration is a python number. On the card the log's terms
    are fresh tensors that need no gradient; on the CPU they are the
    terms themselves."""
    weights = loss_weights(args, iteration)
    planes = {f: getattr(pkg, f) for f in
              ("depth", "alpha", "feature",
               *(TERM_PLANES[t] for t in weights if t in TERM_PLANES))}
    if (pts_depth.device.type == "cuda" and "gs_opa" not in weights
            and torch.is_grad_enabled()
            and any(p.requires_grad for p in planes.values())):
        return loss_graph.replay(
            lambda pl, d, i, w: _losses(SimpleNamespace(**pl), d, i, args,
                                        w, None, None),
            planes, (pts_depth, pts_intensity), weights,
            _baked(args))
    return _losses(pkg, pts_depth, pts_intensity, args, weights,
                   opacity_act, alive)


def _baked(args) -> tuple:
    """What of ``args`` the terms read as constants of a graph, besides
    which terms they compute."""
    return (bool(args.sky_depth),
            args.depth_blend_mode if args.sky_depth else None,
            bool(args.get("median_depth", False)),
            tuple(float(x) for x in args.vfov),
            tuple(float(x) for x in args.hfov), float(args.scale_factor))


def _losses(pkg, pts_depth, pts_intensity, args, weights, opacity_act,
            alive):
    """The terms of ``weights`` on ``pkg``'s planes, each times its weight
    (a Python number or a 0-d tensor), added in order."""
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

    if "distortion" in weights:
        with span("loss.distortion"):
            l = torch.mean(pkg.distortion)
            log["loss_distortion"] = l
            loss += weights["distortion"] * l

    if "lidar" in weights:
        with span("loss.lidar"):
            l = masked_l1(depth, pts_depth, mask)
            log["loss_lidar"] = l
            loss += weights["lidar"] * l

    if "lidar_median" in weights:
        with span("loss.lidar_median"):
            l = masked_l1(pkg.depth_median, pts_depth, mask)
            log["loss_lidar_median"] = l
            loss += weights["lidar_median"] * l

    feature = pkg.feature / torch.clamp_min(alpha, EPS)
    if "t_reg" in weights:
        with span("loss.t_reg"):
            l = -torch.mean(abs_(feature[0:1]))
            log["loss_t_reg"] = l
            loss += weights["t_reg"] * l

    if "v_reg" in weights:
        with span("loss.v_reg"):
            l = torch.mean(abs_(feature[1:4]))
            log["loss_v_reg"] = l
            loss += weights["v_reg"] * l

    if "intensity_sh" in weights:
        with span("loss.intensity_sh"):
            l = masked_l1(pkg.intensity_sh, pts_intensity, mask)
            log["loss_intensity_sh"] = l
            loss += weights["intensity_sh"] * l

    if "raydrop" in weights:
        with span("loss.raydrop"):
            gt_raydrop = 1.0 - mask.to(torch.float32)
            l = binary_cross_entropy(pkg.raydrop, gt_raydrop)
            log["loss_raydrop"] = l
            loss += weights["raydrop"] * l

    if "chamfer" in weights:
        with span("loss.chamfer"):
            pred_pts, pred_mask = pano_to_lidar(depth * mask, args.vfov,
                                                args.hfov)
            gt_pts, gt_mask = pano_to_lidar(pts_depth, args.vfov, args.hfov)
            sf = args.scale_factor
            _, _, m1, m2 = chamfer_distance(pred_pts / sf, gt_pts / sf,
                                            mask1=pred_mask, mask2=gt_mask)
            l = m1 + m2
            log["loss_chamfer"] = l
            loss += weights["chamfer"] * l

    if "smooth" in weights:
        with span("loss.smooth"):
            l = grad_smooth_loss(depth, pts_depth, 0.01 * args.scale_factor)
            log["loss_smooth"] = l
            loss += weights["smooth"] * l

    if "tv" in weights:
        with span("loss.tv"):
            l = tv_loss(depth)
            log["loss_tv"] = l
            loss += weights["tv"] * l

    if "gs_opa" in weights:
        with span("loss.gs_opa"):
            o = torch.clamp(opacity_act, 1e-6, 1 - 1e-6)
            l = torch.sum(((1 - o) ** 2) * alive) / torch.clamp_min(
                torch.sum(alive), 1)
            log["loss_gs_opa"] = l
            loss += weights["gs_opa"] * l

    if "normal_consistency" in weights:
        with span("loss.normal_consistency"):
            surf_normal = depth_to_normal(depth, args.vfov, args.hfov)
            l = torch.mean(1 - torch.sum(pkg.normal * surf_normal,
                                         dim=0)[1:-1, 1:-1])
            log["loss_normal_consistency"] = l
            loss += weights["normal_consistency"] * l

    if "opacity_entropy" in weights:
        with span("loss.opacity_entropy"):
            o = torch.clamp(alpha, 1e-6, 1 - 1e-6)
            l = -torch.mean(o * torch.log(o))
            log["loss_opacity_entropy"] = l
            loss += weights["opacity_entropy"] * l

    if "depth_var" in weights:
        with span("loss.depth_var"):
            depth_var = pkg.depth_square - pkg.depth ** 2
            l = torch.mean(torch.sqrt(torch.clamp_min(depth_var, 1e-6)))
            log["loss_depth_var"] = l
            loss += weights["depth_var"] * l

    log["loss"] = loss
    return loss, log
