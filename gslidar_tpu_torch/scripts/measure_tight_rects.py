"""Instance counts of the square and the tight tile rects on the bench
workload, and the render with and without tight rects (the port of
scripts/measure_tight_rects.py).

    python -m gslidar_tpu_torch.scripts.measure_tight_rects [--tiles 16x32]
        [--points 1000000] [--device cuda|cpu]

The JAX script's three counts, on its subsample (the first 200,000
gaussians of ``bench.build_scene``'s scene; the ratio is statistical)
and with the reference square rects of preprocess (``tight_rects=False``):

* K of the square rect (``tight_rects=False``);
* K of the per-axis eps rect: each axis of the rho_eps = 2 ln(255 op)
  ellipse, sampled at 64 angles, unioned with the low-pass disk and
  intersected with the square (what ``tight_rects=True`` bounds);
* K of the per-row ideal: the ellipse polygon's x-range within each tile
  row.

Then, on the whole scene, the instances binning makes with each setting,
and the 360-degree render with tight rects against the one without. The
culled instances have alpha < 1/255 on every pixel of their tile, so
they contribute nothing; but a removed instance shifts the later ones
across staging batches, which regroups the running sums, and moves the
batch at which a saturated tile's walk stops (``render_differences``).
It prints, per output, whether the two are equal bit for bit and their
largest difference on the open and on the saturated pixels, and fails
beyond tests/test_raster.py's bars for the same comparison (on the
saturated pixels, the outputs of T get T_STOP more). The median position
(an index into the tile's list) moves with the list and is not compared.
"""

from __future__ import annotations

import argparse
import dataclasses
import math

import torch

from gslidar_tpu_torch.bench import (SCALE_FACTOR, SH_DEGREE, bench_settings,
                                     build_scene, parse_tiles, render_360)
from gslidar_tpu_torch.microbench.timing import card, entry_device
from gslidar_tpu_torch.raster.preprocess import preprocess
from gslidar_tpu_torch.raster.settings import T_STOP, RasterSettings

SUBSAMPLE = 200_000
SAMPLES = 64              # dense sampling: the IDEAL tight bound
# tests/test_raster.py::test_tight_rects_output_preserving's bars
BARS = {"color": 2e-6, "alpha": 2e-6, "feature": 2e-5, "final_T": 2e-6,
        "mean depth": 1e-4, "sum w d^2": 5e-3, "distortion": 1e-5}
MEDIAN_DEPTH_FLIP = 0.005     # of the pixels, > 1e-3 apart


def rect_counts(prep, opacity, settings: RasterSettings):
    """(K square, K per-axis eps rect, K per-row ideal) of the gaussians of
    ``prep`` (a ``tight_rects=False`` preprocess), the JAX script's
    ``tight`` step for step."""
    VFOV_min, VFOV_max, HFOV_min, HFOV_max = settings.angle_bounds
    H, W = settings.height, settings.width
    gx, gy = settings.tiles_x, settings.tiles_y
    tw, th = settings.tile_w, settings.tile_h
    prepT, valid = prep.T, prep.valid
    rect_min, rect_max, cxy = prep.rect_min, prep.rect_max, prep.xy
    dev = prepT.device
    rho_eps = torch.clamp_min(
        2.0 * torch.log(255.0 * torch.clamp_min(opacity, 1e-30)), 1e-6)
    cut = torch.sqrt(rho_eps)
    ang = (2.0 * math.pi * torch.arange(SAMPLES, dtype=torch.float32,
                                        device=dev) / SAMPLES)
    sa, ca = torch.sin(ang), torch.cos(ang)
    p_cam = prepT[:, 2, :]
    sample = (cut[:, None, None] * (sa[None, :, None] * prepT[:, None, 0, :]
                                    + ca[None, :, None] * prepT[:, None, 1, :])
              + p_cam[:, None, :])
    s_deg = (sample[..., 0] ** 2 + sample[..., 2] ** 2) < 1e-20
    s_x = torch.where(s_deg, 0.0, sample[..., 0])
    s_z = torch.where(s_deg, 1.0, sample[..., 2])
    s_phi = torch.atan2(s_x, s_z)
    x, z = p_cam[:, 0], p_cam[:, 2]
    deg = (x * x + z * z) < 1e-20
    phi = torch.atan2(torch.where(deg, 0.0, x), torch.where(deg, 1.0, z))
    dphi = s_phi - phi[:, None]
    dphi = dphi - 2.0 * math.pi * torch.round(dphi / (2.0 * math.pi))
    s_phi = phi[:, None] + dphi
    s_theta = torch.atan2(torch.sqrt(s_x * s_x + s_z * s_z), -sample[..., 1])
    sx = (s_phi - HFOV_min) * W / (HFOV_max - HFOV_min)
    sy = (s_theta - VFOV_min) * H / (VFOV_max - VFOV_min)
    cx, cy = cxy[:, 0], cxy[:, 1]
    disk = torch.sqrt(rho_eps / 2.0)

    # the square rect, as row and (modular) column spans
    rx0, ry0 = rect_min[:, 0], rect_min[:, 1]
    rx1, ry1 = rect_max[:, 0], rect_max[:, 1]
    ref_w = rx1 - rx0
    ref_h = ry1 - ry0
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    K_now = torch.where(valid, ref_w * ref_h, zero).sum()

    def cols(lo, hi):
        return (torch.floor(hi / tw) - torch.floor(lo / tw) + 1).to(
            torch.int32).clamp(0, gx)

    # per-axis
    ex_min = torch.minimum(sx.amin(1), cx - disk)
    ex_max = torch.maximum(sx.amax(1), cx + disk)
    ey_min = torch.minimum(sy.amin(1), cy - disk)
    ey_max = torch.maximum(sy.amax(1), cy + disk)
    ay0 = torch.floor(ey_min / th).to(torch.int32).clamp(0, gy)
    ay1 = (torch.floor(ey_max / th) + 1).to(torch.int32).clamp(0, gy)
    a_w = torch.minimum(cols(ex_min, ex_max), ref_w)
    a_h = torch.minimum(torch.clamp_min(ay1 - ay0, 0), ref_h)
    K_axis = torch.where(valid, a_w * a_h, zero).sum()

    # per-row: the x-range of the polygon's edges that cross each row of
    # tiles, unioned with the centre disk's
    rows = torch.arange(gy, dtype=torch.int32, device=dev)
    band_lo = rows[None, None, :] * th
    band_hi = band_lo + th
    sy_e, sx_e = sy[:, :, None], sx[:, :, None]
    sy_nxt = torch.roll(sy, -1, dims=1)[:, :, None]
    sx_nxt = torch.roll(sx, -1, dims=1)[:, :, None]
    in_band = ((torch.maximum(sy_e, sy_nxt) >= band_lo)
               & (torch.minimum(sy_e, sy_nxt) < band_hi))     # [P, N, gy]
    big = 1e9
    bx_min = torch.where(in_band, torch.minimum(sx_e, sx_nxt), big).amin(1)
    bx_max = torch.where(in_band, torch.maximum(sx_e, sx_nxt), -big).amax(1)
    d_in = (((cy + disk)[:, None] >= band_lo[0])
            & ((cy - disk)[:, None] < band_hi[0]))
    bx_min = torch.where(d_in, torch.minimum(bx_min, (cx - disk)[:, None]),
                         bx_min)
    bx_max = torch.where(d_in, torch.maximum(bx_max, (cx + disk)[:, None]),
                         bx_max)
    b_w = torch.where(bx_max > -big, cols(bx_min, bx_max), zero)
    b_w = torch.minimum(b_w, ref_w[:, None])
    r = rows[None, :]
    row_ok = ((r >= ay0[:, None]) & (r < ay1[:, None])
              & (r >= ry0[:, None]) & (r < ry1[:, None]))
    K_row = torch.where(valid[:, None] & row_ok, b_w, zero).sum()
    return int(K_now), int(K_axis), int(K_row)


def render_differences(a, b):
    """{output: (bit-identical, largest |a - b| on the open pixels, on the
    saturated ones)} of two RasterOuts, and the share of pixels whose
    median depth is > 1e-3 apart. A pixel is open where its final T is
    >= T_STOP in both renders: its tile walked every staging batch in
    both. Elsewhere the walk stopped at a batch boundary once every pixel
    of the tile fell below T_STOP, and T decays on (unaccepted) up to
    there, so final T, alpha and the background's share of color may move
    by up to T_STOP where the culled instances moved the boundary."""
    open_ = ((a.final_T >= T_STOP) & (b.final_T >= T_STOP))[0]
    fields = {"color": (a.color, b.color), "feature": (a.feature, b.feature),
              "alpha": (a.alpha, b.alpha), "final_T": (a.final_T, b.final_T),
              "mean depth": (a.depth[:1], b.depth[:1]),
              "distortion": (a.depth[2:3], b.depth[2:3]),
              "sum w d^2": (a.depth[3:4], b.depth[3:4]),
              "median depth": (a.depth[1:2], b.depth[1:2])}

    def largest(d, where):
        return float(d[:, where].max()) if bool(where.any()) else 0.0

    out = {}
    for k, (x, y) in fields.items():
        d = (x - y).abs()
        out[k] = (bool(torch.equal(x, y)), largest(d, open_),
                  largest(d, ~open_))
    flips = float(((a.depth[1] - b.depth[1]).abs() > 1e-3).float().mean())
    return out, flips, int(open_.sum())


def over_bars(diffs):
    """The outputs of ``render_differences`` beyond BARS: on the open
    pixels BARS; on the saturated ones BARS + T_STOP for the outputs of
    T (color, alpha, final T)."""
    of_T = ("color", "alpha", "final_T")
    return [k for k, bar in BARS.items()
            if diffs[k][1] > bar
            or diffs[k][2] > bar + (T_STOP if k in of_T else 0.0)]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tiles", default="16x32",
                   help="the JAX script's tile (16x32) by default")
    p.add_argument("--points", type=int, default=1_000_000)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    device = entry_device(a.device)
    tight = bench_settings(*parse_tiles(a.tiles))
    square = dataclasses.replace(tight, tight_rects=False)
    sc = build_scene(a.points, 0, device)
    print(f"device: {card(device)}; {a.points} gaussians, {a.tiles} tiles",
          flush=True)
    sub = slice(0, SUBSAMPLE)
    with torch.no_grad():
        pre = {}
        for name, s in (("square", square), ("tight", tight)):
            pre[name] = preprocess(
                sc["means3D"], sc["scales"], sc["rotations"], sc["opacity"],
                sc["shs"], sc["mask"], torch.eye(4, device=device),
                torch.zeros(3, device=device), SH_DEGREE, SCALE_FACTOR, s)
        K_now, K_axis, K_row = rect_counts(
            type(pre["square"])(*(x if x is None else x[sub]
                                  for x in pre["square"])),
            sc["opacity"][sub], square)
    print(f"K current (square rect):      {K_now:>10,}")
    print(f"K per-axis eps-rect:          {K_axis:>10,}  "
          f"({K_axis / K_now:.3f}x)")
    print(f"K per-row  eps-ranges (ideal):{K_row:>10,}  "
          f"({K_row / K_now:.3f}x)", flush=True)
    n_sq = int(pre["square"].tiles_touched.to(torch.int64).sum())
    n_ti = int(pre["tight"].tiles_touched.to(torch.int64).sum())
    print(f"binning, every gaussian: {n_sq:,} instances with square rects, "
          f"{n_ti:,} with tight rects ({n_ti / n_sq:.3f}x)", flush=True)
    del pre
    diffs, flips, n_open = render_differences(render_360(sc, tight),
                                              render_360(sc, square))
    print(f"render, tight vs square rects ({n_open} of "
          f"{tight.height * tight.width} pixels open, the rest saturated "
          "below T_STOP): " + ", ".join(
              f"{k} bit-identical" if same else
              f"{k} max |d| {o:.3g} open, {t:.3g} saturated"
              for k, (same, o, t) in diffs.items())
          + f"; median depth > 1e-3 apart on {flips:.5f} of the pixels",
          flush=True)
    over = over_bars(diffs)
    if over or flips >= MEDIAN_DEPTH_FLIP:
        raise RuntimeError(f"tight rects change the render: {over}, median "
                           f"depth flips {flips:.5f}")


if __name__ == "__main__":
    main()
