"""Seeding, the camera-pair shuffle and the depth visualizations (the
port's copy of gslidar_tpu/utils/general.py::seed_everything,
::shuffle_by_pairs, ::visualize_depth, ::make_image_grid and ::save_image;
reference utils/general_utils.py).

The visualizations need neither matplotlib nor PIL: the turbo colormap is
carried as data (``utils/turbo.py``) and the PNG is written with zlib.
"""

from __future__ import annotations

import os
import random
import struct
import zlib

import numpy as np


def seed_everything(seed: int) -> None:
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)


def shuffle_by_pairs(lst) -> None:
    """In-place shuffle preserving (front, back) camera adjacency
    (reference: utils/general_utils.py:160-164)."""
    paired = [(lst[i], lst[i + 1]) for i in range(0, len(lst), 2)]
    random.shuffle(paired)
    lst[:] = [item for pair in paired for item in pair]


def visualize_depth(depth, near=2, far=50, linear=False, scale_factor=None):
    """Depth -> turbo-colormapped float RGB [3, H, W] in [0, 1], numpy
    (reference utils/general_utils.py:15-35, the log-depth curve), looked
    up as matplotlib's ``colormaps["turbo"]`` does."""
    from gslidar_tpu_torch.utils.turbo import TURBO
    depth = np.asarray(depth)
    if scale_factor is not None:
        depth = depth / scale_factor
    depth = depth[0] if depth.ndim == 3 else depth
    eps = np.finfo(np.float32).eps
    curve = (lambda x: -x) if linear else \
        (lambda x: -np.log(np.maximum(x, 0) + eps))
    near = (near if near else depth.min()) - eps
    far = (far if far else depth.max()) + eps
    near_c, far_c, depth_c = curve(near), curve(far), curve(depth)
    t = np.nan_to_num(np.clip((depth_c - np.minimum(near_c, far_c))
                              / np.abs(far_c - near_c), 0, 1))
    lut = np.asarray(TURBO, np.float64)
    idx = t * len(lut)
    idx[idx == len(lut)] = len(lut) - 1
    vis = lut[idx.astype(int)]
    return np.clip(vis, 0.0, 1.0).transpose(2, 0, 1).astype(np.float32)


def make_image_grid(images, nrow=4, pad=2):
    """Tile [3, H, W] images into one grid image (replaces torchvision
    make_grid for visualization dumps)."""
    images = [np.asarray(im) for im in images]
    c, h, w = images[0].shape
    nrows = (len(images) + nrow - 1) // nrow
    grid = np.zeros((c, nrows * (h + pad) + pad, nrow * (w + pad) + pad),
                    dtype=np.float32)
    for i, im in enumerate(images):
        r, col = divmod(i, nrow)
        y = pad + r * (h + pad)
        x = pad + col * (w + pad)
        grid[:, y:y + h, x:x + w] = im
    return grid


def save_image(img, path) -> None:
    """Save a [3, H, W] float image in [0, 1] as an 8-bit RGB PNG."""
    arr = (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)
    rgb = np.ascontiguousarray(arr.transpose(1, 2, 0))
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))
