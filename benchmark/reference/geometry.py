"""Panorama geometry and the rasterizer's settings.

A frozen copy of the port's plain PyTorch version (raster/settings.py,
ops/pano.py), held here so that a change to the program cannot move the
reference it is judged by. It imports nothing of the program."""

from __future__ import annotations

import dataclasses
import math

import torch

NEAR_N = 2.0


FAR_N = 300.0


FILTER_INV_SQUARE = 2.0


ALPHA_EPS = 1.0 / 255.0


T_STOP = 1e-4


FRUSTUM_MARGIN = 1.3


MAX_ALPHA = 0.99


@dataclasses.dataclass(frozen=True)
class RasterSettings:
    height: int
    width: int
    vfov: tuple                   # degrees (min, max)
    hfov: tuple                   # degrees (min, max)
    num_extra_features: int = 0   # S: extra blended channels (t_scale, v)
    tile_h: int = 16
    tile_w: int = 16
    wrap_x: bool = False          # circular x axis (full-360 panorama):
                                  # the tile grid wraps modulo tiles_x, and
                                  # pixels past the width in the partial
                                  # last tile column are dead
    wrap_period: float = 0.0      # low-pass pixel-distance wrap period
                                  # (0 = width when wrap_x, else none)
    sort_depth_bits: int = 0      # 0 = auto (32 - tile-id bits)
    tight_rects: bool = True      # per-axis output-preserving tile rects
    compute_distortion: bool = True   # distortion moments (a training
                                      # loss term; eval turns it off)
    compute_contrib: bool = True  # n_contrib (last accepted position)

    def __post_init__(self):
        object.__setattr__(self, "vfov", tuple(float(v) for v in self.vfov))
        object.__setattr__(self, "hfov", tuple(float(v) for v in self.hfov))
        if self.tile_h * self.tile_w > 1024:
            raise ValueError("a tile holds at most 1024 pixels (one CUDA "
                             "thread per pixel)")

    @property
    def tiles_y(self) -> int:
        return (self.height + self.tile_h - 1) // self.tile_h

    @property
    def tiles_x(self) -> int:
        return (self.width + self.tile_w - 1) // self.tile_w

    @property
    def num_tiles(self) -> int:
        return self.tiles_y * self.tiles_x

    @property
    def tile_pixels(self) -> int:
        return self.tile_h * self.tile_w

    @property
    def angle_bounds(self):
        """(VFOV_min, VFOV_max, HFOV_min, HFOV_max) in radians
        (reference forward.cu:221-226)."""
        return fov_bounds(self.vfov, self.hfov)

    @property
    def dxp_wrap_period(self) -> float:
        """Pixel period of the 2D low-pass distance wrap (0 = no wrap)."""
        if self.wrap_period:
            return float(self.wrap_period)
        return float(self.width) if self.wrap_x else 0.0

    @property
    def depth_bits(self) -> int:
        """Bits of the 32-bit sort key that hold quantized depth; the rest
        hold the tile id (binning.py)."""
        tile_bits = max(1, (self.num_tiles + 1).bit_length())
        if self.sort_depth_bits:
            if self.sort_depth_bits + tile_bits > 32:
                raise ValueError("sort_depth_bits leaves no room for the "
                                 "tile id")
            return self.sort_depth_bits
        return 32 - tile_bits


def fov_bounds(vfov, hfov):
    """Degrees -> radian angle bounds (VFOV_min, VFOV_max, HFOV_min,
    HFOV_max); theta is measured from 'up', so the vertical bounds swap
    (forward.cu:221-226)."""
    VFOV_max = math.pi / 2 - float(vfov[0]) * math.pi / 180
    VFOV_min = math.pi / 2 - float(vfov[1]) * math.pi / 180
    HFOV_max = float(hfov[1]) * math.pi / 180
    HFOV_min = float(hfov[0]) * math.pi / 180
    return VFOV_min, VFOV_max, HFOV_min, HFOV_max


def pixel_dirs(H: int, W: int, vfov, hfov, device="cpu") -> torch.Tensor:
    """Unit ray directions for every pixel, [3, H, W]
    (utils/graphics_utils.py:96-118)."""
    theta_i = torch.arange(H, dtype=torch.float32, device=device)
    phi_j = torch.arange(W, dtype=torch.float32, device=device)
    theta, phi = torch.meshgrid(theta_i, phi_j, indexing="ij")
    v_range = vfov[1] - vfov[0]
    theta = (90 - vfov[1] + theta / H * v_range) * math.pi / 180
    h_range = hfov[1] - hfov[0]
    phi = (hfov[0] + phi / W * h_range) * math.pi / 180
    dx = torch.sin(theta) * torch.sin(phi)
    dz = torch.sin(theta) * torch.cos(phi)
    dy = -torch.cos(theta)
    d = torch.stack([dx, dy, dz], dim=0)
    return d / torch.linalg.norm(d, dim=0, keepdim=True)


def pano_to_lidar(range_image: torch.Tensor, vfov, hfov):
    """Range panorama [1, H, W] -> (points [H*W, 3], valid mask [H*W])."""
    H, W = range_image.shape[-2:]
    dirs = pixel_dirs(H, W, vfov, hfov, device=range_image.device)
    pts = (dirs * range_image).reshape(3, -1).T
    mask = (range_image > 0).reshape(-1)
    return pts, mask


def depth_to_normal(range_image: torch.Tensor, vfov, hfov) -> torch.Tensor:
    """Central-difference normals of a range panorama [1, H, W] -> [3, H, W]
    with a zero border ring (utils/graphics_utils.py:121-149)."""
    H, W = range_image.shape[-2:]
    points = pixel_dirs(H, W, vfov, hfov, device=range_image.device) \
        * range_image
    dxv = points[:, 2:, 1:-1] - points[:, :-2, 1:-1]
    dyv = points[:, 1:-1, 2:] - points[:, 1:-1, :-2]
    n = torch.linalg.cross(dxv, dyv, dim=0)
    n = n / torch.sqrt(torch.sum(n * n, dim=0, keepdim=True) + 1e-24)
    return torch.nn.functional.pad(n, (1, 1, 1, 1))

