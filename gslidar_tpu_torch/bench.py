"""Benchmark: 66x1030 360-degree panorama renders per second on one card
(the port of root ``bench.py``).

    python -m gslidar_tpu_torch.bench [--points 1000000] [--tiles 16x16]
        [--renders 50] [--device cuda|cpu]

The workload is root ``bench.py``'s: a KITTI-360-scale scene of seeded
gaussians (``build_scene``: the same numpy draws in the same order)
rendered as one circular 66x1030 panorama through
``raster.rasterize.rasterize`` under ``torch.no_grad()``, as serving runs
it: preprocess, binning (one host sync, exact-size instance lists: none
is dropped, so the JAX bench's ``num_dropped == 0`` check has no
counterpart and ``num_pairs`` is printed instead) and the forward
compositing kernel without checkpoints.

Earlier lines give the panorama's instance count, the card (``nvidia-smi``
name and power limit), the median ms of one render between CUDA events
and the forward compositing and preprocess kernels' launches in the run
(0 on the CPU, where the plain versions run). The last line is one JSON
object with root ``bench.py``'s keys: ``metric``, ``value`` (renders per
second of ``--renders`` back-to-back renders by the host's clock with one
synchronize at the end, so the binning's host sync and the enqueue
count), ``unit``, ``vs_baseline`` (against 100 renders/s, BASELINE.md's
estimate of the CUDA rasterizer on an A100) and ``backend`` (``cuda`` or
``cpu``).

Not ported: the JAX bench's pair cap and payload packing switches (the
port sizes every buffer exactly), its 24x64 tile choice (measured on
another chip: the default here is 16x16, ``--tiles`` chooses), its
dependent-chain slope timing (its relay did not block) and its fallback
to another compositor: a failure raises and the process exits non-zero.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from gslidar_tpu_torch.microbench.timing import (calls_per_sec, card,
                                                 entry_device, median_ms)
from gslidar_tpu_torch.raster.composite_fwd import composite_forward
from gslidar_tpu_torch.raster.preprocess import preprocess
from gslidar_tpu_torch.raster.rasterize import rasterize
from gslidar_tpu_torch.raster.settings import RasterSettings

A100_BASELINE_RENDERS_PER_SEC = 100.0
SCALE_FACTOR = 0.1
SH_DEGREE = 3


def build_scene(P=1_000_000, seed=0, device="cpu"):
    """Root ``bench.py::build_scene``: points spread like a driving scene
    (a road band and structure), scales 0.003 r, unnormalised random
    quaternions, SH degree 3 of 4 channels, 4 extra features; ``mask``
    all true."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(np.pi / 2 - 0.45, np.pi / 2 + 0.35, P)
    phi = rng.uniform(-np.pi, np.pi, P)
    r = np.exp(rng.uniform(np.log(2.2), np.log(60.0), P))
    x = r * np.sin(theta) * np.sin(phi)
    z = r * np.sin(theta) * np.cos(phi)
    y = -r * np.cos(theta)
    means = np.stack([x, y, z], 1).astype(np.float32) * 0.1
    scale = (0.03 * r * 0.1).astype(np.float32)
    rotations = rng.random((P, 4)).astype(np.float32)
    opacity = rng.uniform(0.2, 0.9, P).astype(np.float32)
    shs = rng.normal(size=(P, 16, 4))     # in place: 5 GB of float64 at 10M
    shs *= 0.2
    scene = dict(
        means3D=means,
        scales=np.stack([scale, scale, scale], 1),
        rotations=rotations,
        opacity=opacity,
        shs=shs.astype(np.float32),
        features=rng.normal(size=(P, 4)).astype(np.float32),
        mask=np.ones(P, bool),
    )
    return {k: torch.as_tensor(v, device=device) for k, v in scene.items()}


def parse_tiles(text: str) -> tuple:
    """``"16x32"`` -> (16, 32): tile height by width."""
    th, tw = (int(v) for v in text.split("x"))
    return th, tw


def bench_settings(tile_h=16, tile_w=16) -> RasterSettings:
    """The bench's panorama: 66x1030, the full 360 degrees with x wrapped,
    distortion and n_contrib off (serving computes neither)."""
    return RasterSettings(height=66, width=1030, vfov=(-24.9, 2.0),
                          hfov=(-180, 180), num_extra_features=4,
                          tile_h=tile_h, tile_w=tile_w, wrap_x=True,
                          compute_distortion=False, compute_contrib=False)


def render_360(scene, settings: RasterSettings):
    """One 360-degree render of ``scene`` from the origin, as root
    ``bench.py::run`` renders it (sf 0.1, SH degree 3, bg [0, 0, 0, 1])."""
    dev = scene["means3D"].device
    with torch.no_grad():
        return rasterize(scene["means3D"], scene["scales"],
                         scene["rotations"], scene["opacity"], scene["shs"],
                         scene["features"], scene["mask"],
                         torch.eye(4, device=dev),
                         torch.zeros(3, device=dev),
                         torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev),
                         SH_DEGREE, SCALE_FACTOR, settings=settings)


def points_label(P: int) -> str:
    """1000000 -> "1M", 10000000 -> "10M", 4096 -> "4096"."""
    if P % 1_000_000 == 0:
        return f"{P // 1_000_000}M"
    return f"{P // 1000}k" if P % 1000 == 0 else str(P)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--points", type=int, default=1_000_000)
    p.add_argument("--tiles", default="16x16",
                   help="tile height x width, at most 1024 pixels")
    p.add_argument("--renders", type=int, default=50,
                   help="renders timed one by one (the median) and back to "
                   "back (the rate)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    device = entry_device(a.device)
    settings = bench_settings(*parse_tiles(a.tiles))
    scene = build_scene(a.points, 0, device)

    def render():
        return render_360(scene, settings)

    out = render()
    if not all(bool(torch.isfinite(x).all())
               for x in (out.color, out.depth, out.alpha)):
        raise RuntimeError("the bench render is not finite")
    print(f"scene: {a.points} gaussians, {settings.height}x{settings.width} "
          f"wrap_x, {settings.tile_h}x{settings.tile_w} tiles "
          f"({settings.tiles_y}x{settings.tiles_x}); num_pairs "
          f"{out.num_pairs}", flush=True)
    print(f"device: {card(device)}", flush=True)
    ms = median_ms(render, device, reps=a.renders, warmup=1)
    rate = calls_per_sec(render, a.renders, device)
    print(f"one render: {ms:.3f} ms (median of {a.renders}, "
          f"{'CUDA events' if device.type == 'cuda' else 'host clock'}) = "
          f"{1e3 / ms:.2f} renders/s; {a.renders} back-to-back renders: "
          f"{rate:.2f} renders/s", flush=True)
    print(f"forward kernel launches: {composite_forward.launches}",
          flush=True)
    print(f"preprocess kernel launches: {preprocess.launches}", flush=True)
    print(json.dumps({
        "metric": "pano_360_renders_per_sec_66x1030_"
                  f"{points_label(a.points)}_gaussians",
        "value": round(rate, 3),
        "unit": "renders/s",
        "vs_baseline": round(rate / A100_BASELINE_RENDERS_PER_SEC, 3),
        "backend": device.type,
    }))


if __name__ == "__main__":
    main()
