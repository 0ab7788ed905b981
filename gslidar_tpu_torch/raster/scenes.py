"""Seeded splat scenes for checking the compositing kernels against their
plain versions, on the CPU and on the card.

Every scene is a dict of numpy arrays made from a ``numpy.random``
Generator, in the shapes ``raster.preprocess.preprocess`` takes;
``port_rows`` turns one (as torch tensors) into the sorted payload rows the
compositors walk.
"""

from __future__ import annotations

import numpy as np


def splat_scene(rng, P=256, S=2, wrap=False):
    """P splats in front of an identity camera (or all around it when
    ``wrap``), with S extra features."""
    theta = rng.uniform(np.pi / 2 - 0.3, np.pi / 2 + 0.3, P)
    phi = (rng.uniform(-np.pi, np.pi, P) if wrap
           else rng.uniform(-0.9, 0.9, P))
    r = rng.uniform(4, 40, P)
    means = np.stack([r * np.sin(theta) * np.sin(phi), -r * np.cos(theta),
                      r * np.sin(theta) * np.cos(phi)], 1)
    return dict(
        means=means.astype(np.float32),
        scales=rng.uniform(0.3, 1.5, (P, 3)).astype(np.float32),
        quats=rng.normal(size=(P, 4)).astype(np.float32),
        opac=rng.uniform(0.2, 0.95, P).astype(np.float32),
        shs=(rng.normal(size=(P, 16, 4)) * 0.2).astype(np.float32),
        feats=rng.normal(size=(P, S)).astype(np.float32),
        mask=np.ones(P, bool),
        viewmat=np.eye(4, dtype=np.float32),
        campos=np.zeros(3, np.float32))



def pano_scene(rng, P=512, seam=False):
    """P splats all around an identity camera over a 360-degree panorama's
    vertical band, at ranges of 3-30 (log-uniform) and sizes 5 % of range
    (tests/test_parallel_pano.py's scene, in its draw order); with
    ``seam``, the second half clusters on the phi = +-pi seam, so that
    splats straddle it."""
    theta = rng.uniform(np.pi / 2 - 0.4, np.pi / 2 + 0.3, P)
    phi = rng.uniform(-np.pi, np.pi, P)
    r = np.exp(rng.uniform(np.log(3.0), np.log(30.0), P))
    if seam:
        phi[P // 2:] = np.pi + rng.normal(0, 0.08, P - P // 2)
    means = np.stack([r * np.sin(theta) * np.sin(phi), -r * np.cos(theta),
                      r * np.sin(theta) * np.cos(phi)], 1)
    s = 0.05 * r
    return dict(
        means=means.astype(np.float32),
        scales=np.stack([s, s, s], 1).astype(np.float32),
        quats=rng.normal(size=(P, 4)).astype(np.float32),
        opac=rng.uniform(0.3, 0.9, P).astype(np.float32),
        shs=(rng.normal(size=(P, 16, 4)) * 0.3).astype(np.float32),
        feats=rng.normal(size=(P, 4)).astype(np.float32),
        mask=np.ones(P, bool),
        viewmat=np.eye(4, dtype=np.float32),
        campos=np.zeros(3, np.float32))

def deep_tile_scene(rng, P=3000, S=2):
    """P splats crowded into the view of one 16x16 tile of a 30x130
    panorama over vfov (-20, 20) and hfov (-60, 60) degrees (tile 4:
    columns 64-79 of the top row), a few pixels across and of low opacity,
    so that the tile walks 12 staging batches of 256 and its pixels' T
    crosses 0.5 and the 1e-4 floor at positions spread over the walk, most
    after its first batch."""
    phi = np.radians(6.0) + rng.uniform(-0.1, 0.1, P)
    theta = np.pi / 2 - 0.17 + rng.uniform(-0.15, 0.15, P)
    r = rng.uniform(5, 30, P)
    means = np.stack([r * np.sin(theta) * np.sin(phi), -r * np.cos(theta),
                      r * np.sin(theta) * np.cos(phi)], 1)
    sc = splat_scene(rng, P=P, S=S)
    sc.update(means=means.astype(np.float32),
              scales=(r[:, None] * rng.uniform(0.01, 0.05, (P, 3))
                      ).astype(np.float32),
              opac=rng.uniform(0.02, 0.25, P).astype(np.float32))
    return sc


def _toward_tile(phi, theta, r):
    return np.stack([r * np.sin(theta) * np.sin(phi), -r * np.cos(theta),
                     r * np.sin(theta) * np.cos(phi)], 1).astype(np.float32)


def opaque_front_tile_scene(rng, P=11000, S=2, n_opaque=300):
    """``deep_tile_scene`` with P splats, so that the same tile holds 43
    staging batches, and n_opaque large, nearly opaque splats at range
    5.8-6.2 among its front ones: every pixel of the tile falls under the
    1e-4 floor within its first 2 batches, and the walk must stop there."""
    sc = deep_tile_scene(rng, P=P, S=S)
    n = n_opaque
    r = rng.uniform(5.8, 6.2, n)
    sc["means"][:n] = _toward_tile(np.radians(6.0) + rng.uniform(-0.1, 0.1, n),
                                   np.pi / 2 - 0.17
                                   + rng.uniform(-0.15, 0.15, n), r)
    sc["scales"][:n] = r[:, None] * rng.uniform(0.1, 0.2, (n, 3))
    sc["opac"][:n] = rng.uniform(0.9, 0.99, n)
    return sc


def long_tile_scene(rng, P=72000, S=2):
    """P tiny, faint splats in the view of ``deep_tile_scene``'s tile,
    thinning out from its left edge to its right, so that the tile holds
    >= 263 staging batches (the heaviest tile of a 360-degree view of 1M
    gaussians) and walks all of them: its pixels fall under the 1e-4 floor
    at positions spread over the whole list, and some never do."""
    sc = deep_tile_scene(rng, P=P, S=S)
    r = rng.uniform(5, 30, P)
    phi = np.radians(6.0) - 0.1 + np.minimum(rng.exponential(0.04, P), 0.2)
    sc.update(means=_toward_tile(phi, np.pi / 2 - 0.17
                                 + rng.uniform(-0.15, 0.15, P), r),
              scales=(r[:, None] * rng.uniform(0.003, 0.01, (P, 3))
                      ).astype(np.float32),
              opac=rng.uniform(0.02, 0.1, P).astype(np.float32))
    return sc


def port_rows(sc, settings):
    """The sorted payload rows and tile starts of scene ``sc`` (torch
    tensors, on any device) through the port's own preprocess (SH degree
    3, scale factor 1) and binning."""
    from gslidar_tpu_torch.raster.binning import bin_gaussians
    from gslidar_tpu_torch.raster.composite_fwd import pack_payload
    from gslidar_tpu_torch.raster.preprocess import preprocess
    prep = preprocess(sc["means"], sc["scales"], sc["quats"], sc["opac"],
                      sc["shs"], sc["mask"], sc["viewmat"], sc["campos"], 3,
                      1.0, settings)
    b = bin_gaussians(prep.rect_min, prep.rect_max, prep.depth,
                      prep.tiles_touched, 1.0, settings,
                      payload=pack_payload(prep, sc["opac"], sc["feats"]))
    return b.data_rows.contiguous(), b.tile_starts
