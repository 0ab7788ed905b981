"""Per-tile instance statistics of the 360-degree bench workload for
candidate tile shapes (the port of scripts/tile_stats.py).

    python -m gslidar_tpu_torch.scripts.tile_stats [--tiles 16x16 ...]
        [--points 1000000] [--device cuda|cpu]

For ``bench.build_scene``'s scene on ``bench.bench_settings``' panorama
with each tile shape: the grid, the instances (pairs), their mean, p50,
p90 and largest count per tile, and the pixel work (instances x tile
pixels), in the JAX script's line format. The per-tile counts are the
differences of the binning's ``tile_starts``, the ranges the forward
kernel walks (the JAX script replays the tile walk in numpy). A shape of
more than 1024 pixels is skipped: the port runs one CUDA thread per tile
pixel.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gslidar_tpu_torch.bench import (SCALE_FACTOR, SH_DEGREE, bench_settings,
                                     build_scene, parse_tiles)
from gslidar_tpu_torch.microbench.timing import card, entry_device
from gslidar_tpu_torch.raster.binning import bin_gaussians
from gslidar_tpu_torch.raster.preprocess import preprocess

# the JAX script's shapes, in its order
TILES = ("8x128", "16x128", "16x64", "32x32", "8x64", "32x64", "16x32")


@torch.no_grad()
def tile_counts(scene, settings) -> np.ndarray:
    """[num_tiles] int64 instances per tile of ``scene``'s 360-degree
    render from the origin."""
    dev = scene["means3D"].device
    prep = preprocess(scene["means3D"], scene["scales"], scene["rotations"],
                      scene["opacity"], scene["shs"], scene["mask"],
                      torch.eye(4, device=dev), torch.zeros(3, device=dev),
                      SH_DEGREE, SCALE_FACTOR, settings)
    b = bin_gaussians(prep.rect_min, prep.rect_max, prep.depth,
                      prep.tiles_touched, SCALE_FACTOR, settings)
    return np.diff(b.tile_starts.cpu().numpy().astype(np.int64))


def stats_line(settings, counts: np.ndarray) -> str:
    """scripts/tile_stats.py's line for one tile shape."""
    th, tw = settings.tile_h, settings.tile_w
    gx, gy = settings.tiles_x, settings.tiles_y
    K = int(counts.sum())
    return (f"tile {th}x{tw}: grid {gy}x{gx}={gx*gy}, pairs={K}, "
            f"mean/tile={counts.mean():.0f}, "
            f"p50={np.percentile(counts, 50):.0f}, "
            f"p90={np.percentile(counts, 90):.0f}, max={counts.max()}, "
            f"px-work={K*th*tw/1e9:.2f}G")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tiles", nargs="*", default=list(TILES))
    p.add_argument("--points", type=int, default=1_000_000)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    device = entry_device(a.device)
    scene = build_scene(a.points, 0, device)
    print(f"device: {card(device)}; {a.points} gaussians", flush=True)
    for tile in a.tiles:
        try:
            settings = bench_settings(*parse_tiles(tile))
        except ValueError as e:
            print(f"tile {tile}: skip ({e})", flush=True)
            continue
        print(stats_line(settings, tile_counts(scene, settings)), flush=True)


if __name__ == "__main__":
    main()
