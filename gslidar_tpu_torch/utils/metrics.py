"""Evaluation meters (port of gslidar_tpu/utils/metrics.py; reference
utils/metrics_utils.py).

numpy float64 implementations of the reference formulas; the chamfer of
``PointsMeter`` and LPIPS run on the meter's device. LPIPS needs
pretrained AlexNet weights that cannot be downloaded: with a converted
weights file at ``GSLIDAR_LPIPS_WEIGHTS`` it is measured
(``utils/lpips.py``), without one the column is NaN in the meter and
``None`` in metrics.json. Unlike the JAX package, a weights file that is
there but fails to load raises instead of reporting NaN.
"""

from __future__ import annotations

import numpy as np
import torch

from gslidar_tpu_torch.ops.chamfer import chamfer_distance, fscore
from gslidar_tpu_torch.ops.pano import pixel_dirs
from gslidar_tpu_torch.utils.lpips import lpips_from_env


def _ssim_skimage_like(pred, gt):
    """structural_similarity(pred, gt, data_range=gt.max()-gt.min()) with
    skimage defaults: 7x7 uniform window, no gaussian."""
    from scipy.ndimage import uniform_filter
    pred = pred.astype(np.float64)
    gt = gt.astype(np.float64)
    drange = gt.max() - gt.min()
    K1, K2, win = 0.01, 0.03, 7
    C1, C2 = (K1 * drange) ** 2, (K2 * drange) ** 2

    def f(x):
        return uniform_filter(x, size=win)
    ux, uy = f(pred), f(gt)
    NP = win ** 2
    cov_norm = NP / (NP - 1)
    uxx, uyy, uxy = f(pred * pred), f(gt * gt), f(pred * gt)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    A1, A2 = 2 * ux * uy + C1, 2 * vxy + C2
    B1, B2 = ux ** 2 + uy ** 2 + C1, vx + vy + C2
    S = (A1 * A2) / (B1 * B2)
    pad = (win - 1) // 2
    return S[pad:-pad, pad:-pad].mean()


def lpips_json(value):
    """JSON-safe LPIPS entry: the measured float, or None when the metric
    is unavailable (no weights file), so metrics.json stays strict JSON."""
    v = float(value)
    return v if np.isfinite(v) else None


class RaydropMeter:
    """RMSE / Accuracy / F1 (reference metrics_utils.py:362-416)."""

    def __init__(self, ratio=0.5):
        self.ratio = ratio
        self.V = []

    def clear(self):
        self.V = []

    def update(self, preds, truths):
        preds, truths = np.asarray(preds), np.asarray(truths)
        rmse = float(np.sqrt(((truths - preds) ** 2).mean()))
        pm = np.where(preds > self.ratio, 1, 0)
        acc = float((pm == truths).mean())
        TP = np.sum((truths == 1) & (pm == 1))
        FP = np.sum((truths == 0) & (pm == 1))
        FN = np.sum((truths == 1) & (pm == 0))
        precision = TP / max(TP + FP, 1e-12)
        recall = TP / max(TP + FN, 1e-12)
        f1 = 2 * precision * recall / max(precision + recall, 1e-12)
        self.V.append([rmse, acc, float(f1)])

    def measure(self):
        return np.array(self.V).mean(0)


class _ImageMeter:
    """Shared RMSE/MedAE/LPIPS/SSIM/PSNR machinery
    (reference metrics_utils.py:140-211, 419-490); LPIPS on ``device``,
    and only for panoramas at least 32 rows high (1.0 below that)."""

    def __init__(self, scale, vmax, device="cpu"):
        self.scale = scale
        self.vmax = vmax
        self.device = device
        self.V = []

    def clear(self):
        self.V = []

    def update(self, preds, truths):
        pred = np.asarray(preds, np.float64) / self.scale
        gt = np.asarray(truths, np.float64) / self.scale
        vmin = 1e-6
        pred = np.clip(pred, vmin, self.vmax)
        gt = np.clip(gt, vmin, self.vmax)
        rmse = float(np.sqrt(((gt - pred) ** 2).mean()))
        medae = float(np.median(np.abs(gt - pred)))
        if gt.shape[-2] >= 32:
            lpips = lpips_from_env(self.device)
            lp = float("nan") if lpips is None else lpips(pred, gt)
        else:
            lp = 1.0
        ssim = float(_ssim_skimage_like(pred.squeeze(0), gt.squeeze(0)))
        psnr = float(10 * np.log10(self.vmax ** 2 / ((pred - gt) ** 2).mean()))
        self.V.append([rmse, medae, lp, ssim, psnr])

    def measure(self):
        return np.array(self.V).mean(0)


class DepthMeter(_ImageMeter):
    def __init__(self, scale, device="cpu"):
        super().__init__(scale, vmax=80.0, device=device)


class IntensityMeter(_ImageMeter):
    def __init__(self, scale, device="cpu"):
        super().__init__(scale, vmax=1.0, device=device)


class PointsMeter:
    """Chamfer + F-score@0.05 on backprojected 360-degree panoramas
    (reference metrics_utils.py:270-359): far=80 zeroed out, points with
    range <= 0.2 discarded, hfov fixed to (-180, 180); the chamfer runs on
    ``device``."""

    def __init__(self, scale, vfov, device="cpu"):
        self.scale = scale
        self.vfov = vfov
        self.device = device
        self.near, self.far = 0.2, 80.0
        self.V = []

    def clear(self):
        self.V = []

    def _pano_to_points(self, img):
        img = np.array(img, np.float32)
        img[img > self.far] = 0
        H, W = img.shape[-2:]
        dirs = pixel_dirs(H, W, self.vfov, (-180, 180)).numpy()
        pts = (dirs * img).reshape(3, -1).T
        mask = np.linalg.norm(pts, axis=1) > self.near
        return pts, mask

    def update(self, preds, truths):
        pred = np.asarray(preds) / self.scale
        gt = np.asarray(truths) / self.scale
        p_pts, p_mask = self._pano_to_points(pred[0])
        g_pts, g_mask = self._pano_to_points(gt[0])

        def dev(a):
            return torch.as_tensor(a, device=self.device)
        p_mask, g_mask = dev(p_mask), dev(g_mask)
        d1, d2, m1, m2 = chamfer_distance(dev(p_pts), dev(g_pts),
                                          mask1=p_mask, mask2=g_mask)
        f, _, _ = fscore(d1, d2, p_mask, g_mask)
        self.V.append([float(m1 + m2), float(f)])

    def measure(self):
        return np.array(self.V).mean(0)
