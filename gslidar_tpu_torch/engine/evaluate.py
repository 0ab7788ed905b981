"""Evaluation: the stitched 360-degree range map and the metric suite
(port of gslidar_tpu/engine/evaluate.py; reference
gaussian_renderer/__init__.py:158-227 and train.py:467-563).

``complete_eval`` renders each front/back test (and, on the final eval,
train) camera pair as one 360-degree panorama, writes the eight-panel PNG
grid, the ray-drop refinement's inputs (``ray_drop_datasets/``) and
``metrics.json``, all in the JAX package's layout. The JAX package's
``_check_dropped`` has no counterpart: the port's instance lists are sized
exactly, so an eval render never drops an instance.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from gslidar_tpu_torch.engine.render import render
from gslidar_tpu_torch.engine.train import CameraBatch, camera_to_batch
from gslidar_tpu_torch.utils.general import (make_image_grid, save_image,
                                             visualize_depth)
from gslidar_tpu_torch.utils.metrics import (DepthMeter, IntensityMeter,
                                             PointsMeter, RaydropMeter,
                                             lpips_json)

EPS = 1e-5


def make_eval_render(args, cfg, settings, bg):
    """Half-panorama render of one camera. Eval never reads the
    distortion moments (a training loss term), so they are off."""
    sf = float(args.scale_factor)
    dynamic = bool(args.dynamic)
    median_depth = bool(args.get("median_depth", False))
    s_eval = dataclasses.replace(settings, compute_distortion=False)

    @torch.no_grad()
    def eval_render(params, alive, prior, cam: CameraBatch, sh_degree):
        return render(params, alive, cam.viewmat, cam.campos, cam.timestamp,
                      cam.towards_idx, prior, bg, sh_degree, sf, cfg,
                      s_eval, dynamic=dynamic, median_depth=median_depth)
    return eval_render


def wrap360_settings(settings):
    """The full-360 settings of a half-panorama config: one wrap_x
    panorama of width 2w whose hfov is anchored so pano column w//2
    carries exactly the front camera's column 0 (the reference's stitch
    puts the halves at integer columns, which for odd w sits half a pixel
    off the naive (-180, 180) grid)."""
    w = settings.width
    pix_deg = (settings.hfov[1] - settings.hfov[0]) / w
    hmin = settings.hfov[0] - (w // 2) * pix_deg
    return dataclasses.replace(settings, width=w * 2,
                               hfov=(hmin, hmin + 2 * w * pix_deg),
                               wrap_x=True)


def make_eval_render360(args, cfg, settings, bg):
    """Single-pass full-360 render in the FRONT camera frame
    (``wrap360_settings`` of the half-panorama ``settings``)."""
    sf = float(args.scale_factor)
    dynamic = bool(args.dynamic)
    median_depth = bool(args.get("median_depth", False))
    s360 = dataclasses.replace(wrap360_settings(settings),
                               compute_distortion=False)

    @torch.no_grad()
    def eval_render360(params, alive, prior, cam: CameraBatch, sh_degree):
        return render(params, alive, cam.viewmat, cam.campos, cam.timestamp,
                      cam.towards_idx, prior, bg, sh_degree, sf, cfg,
                      s360, dynamic=dynamic, median_depth=median_depth,
                      full360=True)
    return eval_render360


def _depth3(depth, depth_median, depth_sq, alpha, args, col_groups):
    """depth_mix/mean/median stack with the reference's per-half-image
    variance quantile (col_groups lists each half's columns)."""
    depth_var = depth_sq - depth ** 2
    depth_mix = np.empty_like(depth)
    for cols in col_groups:
        vq = np.median(depth_var[..., cols]) * 10
        sel = depth_var[..., cols] > vq
        depth_mix[..., cols] = np.where(sel, depth_median[..., cols],
                                        depth[..., cols])
    depth3 = np.concatenate([depth_mix, depth, depth_median], axis=0)
    if args.sky_depth:
        sky = 900.0
        depth3 = depth3 / np.clip(alpha, EPS, None)
        if args.depth_blend_mode == 0:
            depth3 = 1 / np.clip(alpha / np.clip(depth3, EPS, None)
                                 + (1 - alpha) / sky, EPS, None)
        else:
            depth3 = alpha * depth3 + (1 - alpha) * sky
    return depth3


def _np(x):
    return x.detach().cpu().numpy()


def render_range_map(args, cam_front, cam_back, eval_render, params, alive,
                     prior, sh_degree, hw, eval_render360=None):
    """360 range map with the reference break layout (0, w/2, 3w/2, 2w).
    With ``eval_render360`` the panorama is rendered in ONE wrap_x pass;
    otherwise the front and back halves are rendered and stitched.
    Returns numpy (depth [3, h, 2w], intensity, raydrop, gt_depth,
    gt_intensity)."""
    assert cam_front.towards == "forward" and cam_back.towards == "backward"
    device = alive.device
    h, w = hw
    breaks = (0, w // 2, 3 * w // 2, w * 2)
    front_cols = np.arange(breaks[1], breaks[2])
    back_cols = np.concatenate([np.arange(breaks[2], breaks[3]),
                                np.arange(breaks[0], breaks[1])])

    gt_depth_pano = np.zeros([1, h, w * 2], np.float32)
    gt_intensity_pano = np.zeros([1, h, w * 2], np.float32)
    for idx, cam in enumerate([cam_front, cam_back]):
        cols = front_cols if idx == 0 else back_cols
        gt_depth_pano[..., cols] = np.asarray(cam.pts_depth)
        gt_intensity_pano[..., cols] = np.asarray(cam.pts_intensity)

    if eval_render360 is not None:
        pkg = eval_render360(params, alive, prior,
                             camera_to_batch(cam_front, device), sh_degree)
        depth_pano = _depth3(_np(pkg.depth), _np(pkg.depth_median),
                             _np(pkg.depth_square), _np(pkg.alpha), args,
                             [front_cols, back_cols])
        return (depth_pano, _np(pkg.intensity_sh), _np(pkg.raydrop),
                gt_depth_pano, gt_intensity_pano)

    depth_pano = np.zeros([3, h, w * 2], np.float32)
    intensity_pano = np.zeros([1, h, w * 2], np.float32)
    raydrop_pano = np.zeros([1, h, w * 2], np.float32)
    for idx, cam in enumerate([cam_front, cam_back]):
        pkg = eval_render(params, alive, prior, camera_to_batch(cam, device),
                          sh_degree)
        depth3 = _depth3(_np(pkg.depth), _np(pkg.depth_median),
                         _np(pkg.depth_square), _np(pkg.alpha), args,
                         [np.arange(w)])
        cols = front_cols if idx == 0 else back_cols
        depth_pano[..., cols] = depth3
        intensity_pano[..., cols] = _np(pkg.intensity_sh)
        raydrop_pano[..., cols] = _np(pkg.raydrop)

    return (depth_pano, intensity_pano, raydrop_pano, gt_depth_pano,
            gt_intensity_pano)


def eval_splits(args, scene, is_final):
    """[(split, cameras)] of an eval: the test cameras, and on the final
    eval the train cameras too (for KittiMot scenes only the last fifth
    of each half of them, reference train.py:473-478)."""
    scale = scene.resolution_scales[scene.scale_index]
    test = ("test", scene.get_test_cameras(scale=scale))
    if not is_final:
        return [test]
    if args.scene_type == "KittiMot":
        num = len(scene.get_train_cameras()) // 2
        hold = num // 5
        tc = sorted(scene.get_train_cameras(), key=lambda x: x.colmap_id)
        return [test, ("train", tc[:num][-hold:] + tc[num:][-hold:])]
    return [test, ("train", scene.get_train_cameras())]


def complete_eval(iteration, args, scene, state, sh_degree, eval_render,
                  is_final=False, save_raydrop_data=False,
                  eval_render360=None):
    """Reference train.py:467-563: for each split, every front/back pair
    rendered as a 360-degree range map, an eight-panel PNG per pair and
    ``<model_path>/eval/<split>_<iteration>_render/metrics.json``; with
    ``save_raydrop_data``, the refinement's inputs
    ``ray_drop_datasets/{render_<split>,gt}/<id>.npy`` (raydrop,
    intensity, depth mix; GT raydrop, intensity, depth). The meters run
    on the state's device. Returns {split: metrics dict}."""
    device = state.aux.alive.device
    scale = scene.resolution_scales[scene.scale_index]
    h, w = args.hw
    h, w = h // int(scale), w // int(scale)
    savedir = os.path.join(args.model_path, "ray_drop_datasets")
    results = {}
    for name, cameras in eval_splits(args, scene, is_final):
        if not cameras:
            continue
        meters = [RaydropMeter(), IntensityMeter(scale=1, device=device),
                  DepthMeter(scale=args.scale_factor, device=device)] + [
            PointsMeter(scale=args.scale_factor, vfov=args.vfov,
                        device=device) for _ in range(3)]
        outdir = os.path.join(args.model_path, "eval",
                              f"{name}_{iteration}_render")
        os.makedirs(outdir, exist_ok=True)
        if save_raydrop_data:
            for sub in ("gt", f"render_{name}"):
                os.makedirs(os.path.join(savedir, sub), exist_ok=True)

        for idx in range(len(cameras) // 2):
            cam_front, cam_back = cameras[idx * 2], cameras[idx * 2 + 1]
            (depth_pano, intensity_pano, raydrop_pano, gt_depth_pano,
             gt_intensity_pano) = render_range_map(
                args, cam_front, cam_back, eval_render, state.params,
                state.aux.alive, state.prior, sh_degree, [h, w],
                eval_render360=eval_render360)

            raydrop_mask = np.where(raydrop_pano > 0.5, 1.0, 0.0)
            gt_raydrop = np.where(gt_depth_pano > 0, 0.0, 1.0)

            if save_raydrop_data:
                fname = f"{cam_front.colmap_id:03d}.npy"
                np.save(os.path.join(savedir, f"render_{name}", fname),
                        np.concatenate([raydrop_pano, intensity_pano,
                                        depth_pano[[0]]]))
                np.save(os.path.join(savedir, "gt", fname),
                        np.concatenate([gt_raydrop, gt_intensity_pano,
                                        gt_depth_pano]))

            depth_pano_m = depth_pano * (1.0 - raydrop_mask)
            intensity_pano_m = intensity_pano * (1.0 - raydrop_mask)

            sf = args.scale_factor
            grid = [visualize_depth(depth_pano_m[[0]], scale_factor=sf),
                    np.repeat(np.clip(intensity_pano_m, 0, 1), 3, 0),
                    visualize_depth(depth_pano_m[[1]], scale_factor=sf),
                    np.repeat(np.clip(gt_intensity_pano, 0, 1), 3, 0),
                    visualize_depth(depth_pano_m[[2]], scale_factor=sf),
                    visualize_depth(raydrop_mask, near=0.01, far=1),
                    visualize_depth(gt_depth_pano, scale_factor=sf),
                    visualize_depth(gt_raydrop, near=0.01, far=1)]
            save_image(make_image_grid(grid, nrow=2),
                       os.path.join(outdir, f"{cam_front.colmap_id:03d}.png"))

            meters[0].update(raydrop_pano, gt_raydrop)
            meters[1].update(intensity_pano_m, gt_intensity_pano)
            meters[2].update(depth_pano_m[[0]], gt_depth_pano)
            for i in range(3):
                meters[3 + i].update(depth_pano_m[[i]], gt_depth_pano)

        RMSE, Acc, F1 = meters[0].measure()
        rmse_i, medae_i, lp_i, ssim_i, psnr_i = meters[1].measure()
        rmse_d, medae_d, lp_d, ssim_d, psnr_d = meters[2].measure()
        cd_mix, f_mix = meters[3].measure()
        cd_mean, f_mean = meters[4].measure()
        cd_med, f_med = meters[5].measure()
        metrics = {
            "split": name, "iteration": int(iteration),
            "Ray drop": {"RMSE": RMSE, "Acc": Acc, "F1": F1},
            "Point Cloud mix": {"C-D": cd_mix, "F-score": f_mix},
            "Point Cloud mean": {"C-D": cd_mean, "F-score": f_mean},
            "Point Cloud median": {"C-D": cd_med, "F-score": f_med},
            "Depth": {"RMSE": rmse_d, "MedAE": medae_d,
                      "LPIPS": lpips_json(lp_d), "SSIM": ssim_d,
                      "PSNR": psnr_d},
            "Intensity SH": {"RMSE": rmse_i, "MedAE": medae_i,
                             "LPIPS": lpips_json(lp_i), "SSIM": ssim_i,
                             "PSNR": psnr_i},
        }
        with open(os.path.join(outdir, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=1, default=float)
        print(f"[ITER {iteration}] eval {name}: ray drop RMSE {RMSE:.4f} "
              f"Acc {Acc:.4f} F1 {F1:.4f} | depth RMSE {rmse_d:.4f} | "
              f"C-D mix {cd_mix:.4f} F-score {f_mix:.4f}", flush=True)
        results[name] = metrics
    return results
