"""Ray-drop refinement: U-Net post-training on cached renders (port of
gslidar_tpu/engine/refine.py; reference train.py:566-734).

``refine`` trains the U-Net full-batch on ``ray_drop_datasets/
render_train`` against the GT ray drop: Adam (optax's ``adam``: eps 1e-8,
bias-corrected) with the one-cycle learning rate set per epoch, a clipped
BCE, and random box masks drawn from ``np.random.default_rng(0)`` exactly
as the JAX package draws them. It writes ``ckpt/refine.npz`` in the JAX
package's flat leaf layout, which its ``_load_unet`` reads, as this
module's reads a JAX-written one. ``refine_test`` applies the U-Net to the
train and test renders, masks depth and intensity with its ray drop and
writes metrics, PNGs and .ply point clouds where the JAX package does.

The U-Net runs in full float32 on a card (TF32 off), as it does on the
CPU. The weights start from flax's initialisation scheme drawn from a
seeded ``torch.Generator``, and dropout draws from another: neither
stream can match JAX's ``PRNGKey``.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from gslidar_tpu_torch.models.unet import (UNet, init_unet,
                                           unet_from_leaves, unet_leaves)
from gslidar_tpu_torch.raster.preprocess import full_f32

BCE_EPS = 1e-7


def _onecycle_lr(step, total, max_lr=1e-3, pct_start=0.3, div=25.0,
                 final_div=1e4):
    """torch OneCycleLR (cos annealing) at optax's update count ``step``
    (0 at the first update), in float32 as the JAX package evaluates it:
    near the end the schedule is 1 + cos(x) with cos(x) near -1, where a
    float64 evaluation would differ from JAX's by up to 2e-4 relative."""
    f32 = np.float32
    s = f32(step)
    init_lr = max_lr / div
    min_lr = init_lr / final_div
    up = max(int(pct_start * total), 1)

    def cos(x):
        return f32(math.cos(float(x)))
    if s < up:
        t = min(max(s / f32(up), f32(0)), f32(1))
        lr = f32(init_lr) + f32((max_lr - init_lr) * 0.5) * (
            f32(1) - cos(f32(math.pi) * t))
    else:
        t = min(max((s - f32(up)) / f32(max(total - up, 1)), f32(0)),
                f32(1))
        lr = f32(min_lr) + f32((max_lr - min_lr) * 0.5) * (
            f32(1) + cos(f32(math.pi) * t))
    return float(f32(lr))


def box_mask(rng, h, w):
    """[h, w] float32 ones with up to 31 random boxes zeroed (reference
    train.py:614-624), drawn from ``rng`` in the JAX package's order."""
    mask = np.ones((h, w), np.float32)
    by = max(int(0.1 * h), 2)
    bx = max(int(0.1 * w), 2)
    for _ in range(rng.integers(32)):
        sy = rng.integers(1, by)
        sx = rng.integers(1, bx)
        yi = rng.integers(h - sy)
        xi = rng.integers(w - sx)
        mask[yi:yi + sy, xi:xi + sx] = 0.0
    return mask


def bce(out, y):
    """The clipped binary cross-entropy of the refinement."""
    o = torch.clamp(out, BCE_EPS, 1 - BCE_EPS)
    return -torch.mean(y * torch.log(o) + (1 - y) * torch.log(1 - o))


def adam(model):
    """optax's ``adam`` over the U-Net (eps 1e-8, bias-corrected); the
    learning rate is set per step by ``refine_step``."""
    return torch.optim.Adam(model.parameters(), lr=0.0, betas=(0.9, 0.999),
                            eps=1e-8)


def refine_step(model, opt, x, y, mask, lr, generator):
    """One full-batch epoch: the clipped BCE of the masked input, its
    gradients (left in ``.grad``) and an Adam step at ``lr``. Returns the
    loss."""
    for group in opt.param_groups:
        group["lr"] = lr
    loss = bce(model(x * mask, generator), y)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss


def _dataset_dir(args, sub):
    return os.path.join(args.model_path, "ray_drop_datasets", sub)


def refine(args, device, on_epoch=None):
    """Train the U-Net for ``args.refine_epochs`` (default 1000) full-batch
    epochs on ``device`` and write ``ckpt/refine.npz``. ``on_epoch(i,
    loss)`` is called after each epoch with its loss tensor. Returns (the
    model, [(epoch, loss)] of the printed epochs)."""
    os.makedirs(os.path.join(args.model_path, "refine"), exist_ok=True)
    gt_dir, train_dir = _dataset_dir(args, "gt"), _dataset_dir(
        args, "render_train")
    names = sorted(os.listdir(train_dir))
    x = torch.as_tensor(np.stack([np.load(os.path.join(train_dir, n))
                                  for n in names]), dtype=torch.float32,
                        device=device)                      # [B, 3, H, 2W]
    y = torch.as_tensor(np.stack([np.load(os.path.join(gt_dir, n))[[0]]
                                  for n in names]), dtype=torch.float32,
                        device=device)                      # [B, 1, H, 2W]

    model = init_unet(UNet(), torch.Generator().manual_seed(0)).to(device)
    model.train()
    epochs = int(args.get("refine_epochs", 1000))
    opt = adam(model)
    dropout = torch.Generator(device=device).manual_seed(0)
    rng = np.random.default_rng(0)
    printed = []
    print("Start UNet Optimization ...", flush=True)
    with full_f32():
        for i in range(epochs):
            mask = torch.as_tensor(box_mask(rng, x.shape[2], x.shape[3]),
                                   device=device)
            loss = refine_step(model, opt, x, y, mask,
                               _onecycle_lr(i, epochs), dropout)
            if on_epoch is not None:
                on_epoch(i, loss)
            if i % 50 == 0:
                printed.append((i, float(loss.detach())))
                print(f"refine iter {i} loss {printed[-1][1]:.5f}",
                      flush=True)

    ckpt = os.path.join(args.model_path, "ckpt", "refine.npz")
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    np.savez_compressed(ckpt, **{f"leaf_{i}": a for i, a in
                                 enumerate(unet_leaves(model))})
    return model, printed


def _load_unet(args, device):
    """The U-Net of ``ckpt/refine.npz`` (written by either package), in
    eval mode on ``device``."""
    with np.load(os.path.join(args.model_path, "ckpt", "refine.npz")) as d:
        leaves = [d[f"leaf_{i}"] for i in range(len(d.files))]
    return unet_from_leaves(leaves, device).eval()


def refine_test(args, device):
    """Apply the refined U-Net to the train and test renders; writes
    ``eval/{train,test}_refine_render/`` (metrics.json, a PNG and a .ply
    per pair). Returns {split: metrics dict}."""
    from gslidar_tpu_torch.ops.pano import pano_to_lidar_np
    from gslidar_tpu_torch.utils.general import (make_image_grid,
                                                 save_image, visualize_depth)
    from gslidar_tpu_torch.utils.metrics import (DepthMeter, IntensityMeter,
                                                 PointsMeter, RaydropMeter,
                                                 lpips_json)
    from gslidar_tpu_torch.utils.ply import save_xyz_ply

    model = _load_unet(args, device)
    sf = args.scale_factor
    all_metrics = {}
    for mode in ["train", "test"]:
        outdir = os.path.join(args.model_path, "eval",
                              f"{mode}_refine_render")
        os.makedirs(outdir, exist_ok=True)
        test_dir, gt_dir = _dataset_dir(args, f"render_{mode}"), \
            _dataset_dir(args, "gt")
        names = sorted(os.listdir(test_dir))
        xs = np.stack([np.load(os.path.join(test_dir, n)) for n in names])
        gts = np.stack([np.load(os.path.join(gt_dir, n)) for n in names])

        meters = [RaydropMeter(), IntensityMeter(scale=1, device=device),
                  DepthMeter(scale=sf, device=device),
                  PointsMeter(scale=sf, vfov=args.vfov, device=device)]

        with torch.no_grad(), full_f32():
            refined = model(torch.as_tensor(xs, dtype=torch.float32,
                                            device=device)).cpu().numpy()
        ray_mask = np.where(refined > 0.5, 1.0, 0.0)
        for idx, name in enumerate(names):
            raydrop_pano = refined[idx, [0]]
            m = ray_mask[idx, [0]]
            intensity_pano = xs[idx, [1]] * (1 - m)
            depth_pano = xs[idx, [2]] * (1 - m)
            gt_raydrop, gt_intensity, gt_depth = (gts[idx, [0]],
                                                  gts[idx, [1]],
                                                  gts[idx, [2]])
            grid = [visualize_depth(gt_depth, scale_factor=sf),
                    visualize_depth(depth_pano, scale_factor=sf),
                    np.repeat(np.clip(gt_intensity, 0, 1), 3, 0),
                    np.repeat(np.clip(intensity_pano, 0, 1), 3, 0)]
            save_image(make_image_grid(grid, nrow=1),
                       os.path.join(outdir, name.replace(".npy", ".png")))
            save_xyz_ply(pano_to_lidar_np(depth_pano, args.vfov, (-180, 180)),
                         os.path.join(outdir, name.replace(".npy", ".ply")))
            meters[0].update(raydrop_pano, gt_raydrop)
            meters[1].update(intensity_pano, gt_intensity)
            meters[2].update(depth_pano, gt_depth)
            meters[3].update(depth_pano, gt_depth)

        RMSE, Acc, F1 = meters[0].measure()
        rmse_i, medae_i, lp_i, ssim_i, psnr_i = meters[1].measure()
        rmse_d, medae_d, lp_d, ssim_d, psnr_d = meters[2].measure()
        cd, fs = meters[3].measure()
        metrics = {
            "split": mode, "iteration": "refine",
            "Ray drop": {"RMSE": RMSE, "Acc": Acc, "F1": F1},
            "Point Cloud": {"C-D": cd, "F-score": fs},
            "Depth": {"RMSE": rmse_d, "MedAE": medae_d,
                      "LPIPS": lpips_json(lp_d), "SSIM": ssim_d,
                      "PSNR": psnr_d},
            "Intensity": {"RMSE": rmse_i, "MedAE": medae_i,
                          "LPIPS": lpips_json(lp_i), "SSIM": ssim_i,
                          "PSNR": psnr_i},
        }
        with open(os.path.join(outdir, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=1, default=float)
        print(f"[refine] {mode}: ray drop RMSE {RMSE:.4f} Acc {Acc:.4f} "
              f"F1 {F1:.4f} | C-D {cd:.4f} F-score {fs:.4f}", flush=True)
        all_metrics[mode] = metrics
    return all_metrics
