"""LPIPS (AlexNet) perceptual metric in PyTorch (port of
gslidar_tpu/utils/lpips_jax.py; reference: the ``lpips`` package with
pretrained AlexNet features, utils/metrics_utils.py:145,424).

Pretrained weights cannot be downloaded, so, as in the JAX package:

* this module implements the AlexNet-LPIPS forward (the conv feature
  stack, unit-normalized channel activations, the learned linear heads);
* ``load_lpips(path, device)`` loads a converted weights file: an npz
  with keys ``convN_w/b`` and ``linN_w``, or the ``lpips.LPIPS(net=
  'alex')`` state_dict names;
* ``lpips_from_env(device)`` reads the file named by
  ``GSLIDAR_LPIPS_WEIGHTS``; without one the meters report no LPIPS.

The convs are ``torch.nn.functional.conv2d`` in full float32 (the JAX
convs run at ``Precision.HIGHEST``): TF32 is off around them on a card.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from gslidar_tpu_torch.raster.preprocess import full_f32

# AlexNet feature config: (out_ch, kernel, stride, pad); M = maxpool
_ALEX = [(64, 11, 4, 2), "M", (192, 5, 1, 2), "M", (384, 3, 1, 1),
         (256, 3, 1, 1), (256, 3, 1, 1)]

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _alexnet_feats(x, params):
    feats = []
    i = 0
    for spec in _ALEX:
        if spec == "M":
            x = F.max_pool2d(x, 3, 2)
            continue
        _, _, s, p = spec
        x = F.relu(F.conv2d(x, params[f"conv{i}_w"], params[f"conv{i}_b"],
                            stride=s, padding=p))
        feats.append(x)
        i += 1
    return feats


def _unit_norm(x, eps=1e-10):
    return x / torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + eps)


def lpips_distance(img0, img1, params):
    """img*: [B, 3, H, W] in [0, 1] (normalize=True semantics) -> [B]."""
    shift = torch.tensor(_SHIFT, device=img0.device).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=img0.device).view(1, 3, 1, 1)
    with full_f32():
        f0 = _alexnet_feats((2 * img0 - 1 - shift) / scale, params)
        f1 = _alexnet_feats((2 * img1 - 1 - shift) / scale, params)
    total = 0.0
    for i, (a, b) in enumerate(zip(f0, f1)):
        d = (_unit_norm(a) - _unit_norm(b)) ** 2
        total = total + torch.mean(torch.sum(d * params[f"lin{i}_w"], dim=1),
                                   dim=(1, 2))
    return total


def _convert_state_dict(raw):
    """Map lpips.LPIPS(net='alex') state_dict names to our keys."""
    params = {}
    conv_ids = [0, 3, 6, 8, 10]                # torchvision alexnet indices
    for i, ci in enumerate(conv_ids):
        params[f"conv{i}_w"] = raw[f"net.slice{i + 1}.{ci}.weight"]
        params[f"conv{i}_b"] = raw[f"net.slice{i + 1}.{ci}.bias"]
    for i in range(5):
        params[f"lin{i}_w"] = raw[f"lins.{i}.model.1.weight"]
    return params


def load_lpips(path: str, device):
    """fn(pred, gt) -> float LPIPS of two [1, H, W] (or [3, H, W])
    panoramas in [0, 1], computed on ``device``."""
    with np.load(path) as data:
        raw = dict(data)
    if "conv0_w" not in raw:
        raw = _convert_state_dict(raw)
    params = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
              for k, v in raw.items()}

    def to_rgb(x):
        x = torch.as_tensor(np.asarray(x, np.float32), device=device)
        if x.dim() == 3 and x.shape[0] == 1:
            x = x.expand(3, -1, -1)
        return x[None]

    @torch.no_grad()
    def fn(pred, gt):
        return float(lpips_distance(to_rgb(pred), to_rgb(gt), params)[0])
    return fn


@functools.lru_cache(maxsize=None)
def _load_cached(path: str, mtime_ns: int, device: str):
    return load_lpips(path, device)


def lpips_from_env(device):
    """The LPIPS of ``GSLIDAR_LPIPS_WEIGHTS`` on ``device`` (loaded once per
    file and device), or None when the variable is unset or names no
    file. A file that is there but does not load raises."""
    path = os.environ.get("GSLIDAR_LPIPS_WEIGHTS", "")
    if not path or not os.path.exists(path):
        return None
    return _load_cached(os.path.abspath(path), os.stat(path).st_mtime_ns,
                        str(torch.device(device)))
