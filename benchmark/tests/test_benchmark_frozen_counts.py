"""The benchmark's frozen copy of the work counts (benchmark/counts.py)
equals the port's ``gslidar_tpu_torch/microbench/bounds.py`` on a seeded
fixture today. Should the port's counts change, this test fails and the
copy stays as it is: the yardstick does not move with the program."""

import numpy as np
import pytest
import torch

from benchmark import counts as F
from gslidar_tpu_torch.microbench import bounds as B
from gslidar_tpu_torch.raster.composite_fwd import (
    composite_forward_reference, make_params)
from gslidar_tpu_torch.raster.settings import RasterSettings


def test_constants():
    for name in ("HBM_BYTES_PER_S", "SMS", "BOOST_CLOCK_HZ",
                 "ISSUE_PER_SM_CLOCK", "RAY_FP32", "RAY_MUFU", "STAGE_FP32",
                 "STAGE_MUFU", "INTERSECT_FP32", "INTERSECT_MUFU",
                 "FWD_ACCEPT_FP32", "FWD_DIST_FP32", "FWD_DIST_MUFU",
                 "BWD_ACCEPT_FP32", "BWD_ACCEPT_MUFU", "BWD_DIST_FP32",
                 "BWD_DIST_MUFU", "FINISH_FP32", "FINISH_MUFU",
                 "PREP_FWD_MUFU", "PREP_BWD_MUFU", "PREP_FWD_FP32",
                 "PREP_BWD_FP32"):
        assert getattr(F, name) == getattr(B, name), name
    from gslidar_tpu_torch.raster.composite_fwd import WINDOW_ENDS
    assert F.WINDOW_ENDS == WINDOW_ENDS


@pytest.mark.parametrize("P,n_sh,C,cols,backward", [
    (1_000_000, 16, 4, 3, False), (1_000_000, 16, 4, 3, True),
    (10_000_000, 9, 4, 2, False), (12345, 0, 3, 2, True)])
def test_preprocess(P, n_sh, C, cols, backward):
    assert F.preprocess_bytes(P, n_sh, 16, C, cols, backward) == \
        B.preprocess_bytes(P, n_sh, 16, C, cols, backward)
    want = B.preprocess_bound(P, n_sh, 16, C, cols, B.BOOST_CLOCK_HZ,
                              backward)
    got = F.preprocess_bound(P, n_sh, 16, C, cols, F.BOOST_CLOCK_HZ,
                             backward)
    assert got.ms == want.ms and got.by == want.by
    n_bytes, fp32, mufu = F.preprocess_work(P, n_sh, 16, C, cols, backward)
    again = F.bound(bytes=F.bytes_ms(n_bytes),
                    fp32=F.issue_ms(fp32, "fp32", F.BOOST_CLOCK_HZ),
                    mufu=F.issue_ms(mufu, "mufu", F.BOOST_CLOCK_HZ))
    assert again.ms == pytest.approx(want.ms, rel=1e-12)


def seeded_forward():
    """A plain forward of seeded rows over a 32x64 view of 16x16 tiles."""
    rng = np.random.default_rng(7)
    st = RasterSettings(height=32, width=64, vfov=(-24.9, 2.0),
                        hfov=(-90, 90), num_extra_features=4)
    counts = rng.integers(0, 400, st.num_tiles)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    n = int(starts[-1])
    rows = np.zeros((n, 18), np.float32)
    # splats facing the camera a few metres out, spread over the view
    phi = rng.uniform(-1.4, 1.4, n)
    theta = rng.uniform(-0.4, 0.05, n)
    r = rng.uniform(0.5, 3.0, n)
    p = np.stack([r * np.cos(theta) * np.sin(phi), -r * np.sin(theta),
                  r * np.cos(theta) * np.cos(phi)], 1)
    u = np.cross(p, [0, 1, 0])
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v = np.cross(p, u)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    s = rng.uniform(0.01, 0.05, (n, 1))
    T = np.stack([u * s, v * s, p], 1)          # rows u, v, p
    rows[:, :9] = T.transpose(0, 2, 1).reshape(n, 9)
    rows[:, 9] = rng.uniform(0.05, 0.9, n)
    rows[:, 10:] = rng.uniform(0, 1, (n, 8))
    rows, starts = torch.from_numpy(rows), torch.from_numpy(starts)
    fwd = composite_forward_reference(rows, starts, make_params(0.1, st), st,
                                      4, 4)
    return fwd, st, n, starts


@pytest.mark.parametrize("backward", [False, True])
def test_composite_work(backward):
    fwd, st, n, starts = seeded_forward()
    want = B.composite_work(fwd, st, n, 4, 4, backward, starts)
    got = F.composite_work(fwd, st, n, 4, 4, backward, starts)
    assert got == want
    assert want.needed_pairs > 0
    assert got.bound().ms == want.bound().ms


def test_product_batches():
    rng = np.random.default_rng(3)
    counts = torch.from_numpy(rng.integers(0, 40_000, 200))
    walked = torch.minimum(counts, torch.from_numpy(
        rng.integers(0, 40_000, 200)))
    assert torch.equal(F.product_batches(walked, counts, 256),
                       B.product_batches(walked, counts, 256))
