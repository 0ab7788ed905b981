"""The port's bench (``gslidar_tpu_torch.bench``) against root ``bench.py``.

* ``build_scene`` is root ``bench.build_scene`` bit for bit;
* ``render_360`` of that scene equals gslidar_tpu's ``rasterize`` under the
  same settings and 16x16 tiles (its XLA compositor, as the JAX package's
  CPU tests run it, at caps that drop nothing), at
  test_torch_render.py's bars;
* ``python -m gslidar_tpu_torch.bench --device cpu`` ends in one JSON line
  with root ``bench.py``'s keys and ``backend``; without a card and
  without ``--device cpu`` it exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gslidar_tpu_torch import bench as TB

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 4096


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.update(extra)
    return env


@pytest.mark.parametrize("seed", [0, 1])
def test_build_scene_is_root_bench(seed):
    import bench as JB
    want = JB.build_scene(P, seed)
    got = TB.build_scene(P, seed)
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == torch.from_numpy(v.copy()).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_render_360_matches_jax():
    import jax
    import jax.numpy as jnp
    import bench as JB
    from gslidar_tpu.raster import RasterSettings as JS
    from gslidar_tpu.raster import rasterize
    ts = TB.bench_settings(16, 16)
    js = JS(height=ts.height, width=ts.width, vfov=ts.vfov, hfov=ts.hfov,
            num_extra_features=4, tile_h=16, tile_w=16, wrap_x=True,
            compute_distortion=False, compute_contrib=False,
            pair_cap=1 << 14, tile_chunk=32, tile_list_cap=1 << 10,
            backend="xla")
    sc = JB.build_scene(P, 0)
    a = jax.jit(lambda s: rasterize(
        s["means3D"], s["scales"], s["rotations"], s["opacity"], s["shs"],
        s["features"], s["mask"], jnp.eye(4, dtype=jnp.float32),
        jnp.zeros(3), jnp.asarray([0.0, 0.0, 0.0, 1.0]), 3, 0.1,
        settings=js))(sc)
    assert int(a.num_dropped) == 0 and int(a.tile_need) <= 1 << 10
    b = TB.render_360(TB.build_scene(P, 0), ts)
    assert b.num_pairs == int(a.num_pairs) > 0
    for name, got, want, tol in [
            ("alpha", b.alpha, a.alpha, 5e-4),
            ("intensity", b.color, a.color, 5e-4),
            ("feature", b.feature, a.feature, 2e-3),
            ("depth", b.depth[0], a.depth[0], 2e-2)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                                   err_msg=name)
    assert float(np.asarray(a.alpha).mean()) > 0.2
    # the median picks one splat: a T_before within rounding of 0.5 flips
    med = np.abs(b.depth[1].numpy() - np.asarray(a.depth[1])) > 2e-2
    assert med.mean() < 2e-3


def test_points_label():
    assert [TB.points_label(p) for p in (1_000_000, 10_000_000, 4096,
                                         250_000)] == ["1M", "10M", "4096",
                                                       "250k"]


def test_bench_cli_on_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "gslidar_tpu_torch.bench", "--device", "cpu",
         "--points", str(P), "--renders", "2"], cwd=REPO,
        env=_env(OMP_NUM_THREADS="2"), capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert f"num_pairs {11322}" in lines[0]          # test_render_360's
    out = json.loads(lines[-1])
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "backend"}
    assert out["metric"] == "pano_360_renders_per_sec_66x1030_4096_gaussians"
    assert out["unit"] == "renders/s" and out["backend"] == "cpu"
    assert out["value"] > 0
    assert out["vs_baseline"] == pytest.approx(out["value"] / 100.0,
                                               abs=1e-3)


def test_bench_cli_refuses_without_a_card():
    r = subprocess.run(
        [sys.executable, "-m", "gslidar_tpu_torch.bench", "--points", "64"],
        cwd=REPO, env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True,
        text=True, timeout=120)
    assert r.returncode != 0
    assert "metric" not in r.stdout
    assert "CUDA" in r.stderr


def test_bench_tiles_hold_at_most_1024_pixels():
    assert TB.parse_tiles("8x32") == (8, 32)
    TB.bench_settings(32, 32)
    with pytest.raises(ValueError, match="1024"):
        TB.bench_settings(16, 128)
