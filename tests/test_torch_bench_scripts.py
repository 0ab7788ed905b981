"""The port's measurement scripts (``gslidar_tpu_torch/scripts/``) against
the JAX scripts under ``scripts/``, and its spoof batch runner.

* ``bench_train_step``: ``train_bench_inputs`` and ``train_bench_args`` are
  what scripts/bench_train_step.py's ``main`` draws and builds (captured
  from it at ``make_train_step``), and one step on that model matches
  gslidar_tpu's ``make_train_step`` (``torch_scenes.assert_step_matches``);
* ``tile_stats``: the per-tile counts (binning's ``tile_starts``) equal
  scripts/tile_stats.py's numpy replay of gslidar_tpu's ``preprocess``,
  and the two scripts print the same lines;
* ``measure_tight_rects``: the three counts equal the JAX script's, and
  the render with tight rects is held to tests/test_raster.py's bars;
* ``profile_render`` and ``profile_train_step`` print every stage;
* ``scripts/run_selected_spoofs.sh`` runs ``python -m
  gslidar_tpu_torch.train`` under CUDA_VISIBLE_DEVICES per attack id,
  skipping a missing config.

The JAX scripts' ``main`` run here on a small scene: root ``bench.py``'s
``build_scene`` is patched to P = 4096. On the CPU the train-step scripts
run on a 16x64 (or 32x128) panorama: the bench camera's GT covers every
pixel, and the chamfer term is quadratic in them.
"""

import functools
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gslidar_tpu_torch import bench as TB
from gslidar_tpu_torch.scripts import (bench_train_step, measure_tight_rects,
                                       profile_render, profile_train_step,
                                       tile_stats)
from torch_scenes import assert_step_matches

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 4096
STATIC_NO_GRAD = ("intensity", "t", "scaling_t")


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def small_bench(monkeypatch):
    """Root bench.py's build_scene at P points."""
    import bench as JB
    monkeypatch.setattr(JB, "build_scene",
                        functools.partial(JB.build_scene, P=P))
    return JB


class _Stop(Exception):
    pass


def test_train_bench_inputs_and_args_are_the_scripts(monkeypatch):
    from gslidar_tpu.engine import train as JT
    from gslidar_tpu.models import gaussians as JG
    got = {}
    create = JG.create_from_pcd

    def create_keep(pts, colors, *a, **k):
        got["pts"], got["colors"] = pts, colors
        return create(pts, colors, *a, **k)

    def make_step_stop(args, cfg, settings, bg):
        got.update(args=args, cfg=cfg, settings=settings)
        raise _Stop

    monkeypatch.setattr(JG, "create_from_pcd", create_keep)
    monkeypatch.setattr(JT, "make_train_step", make_step_stop)
    monkeypatch.setattr(sys, "argv", ["bench_train_step.py", "--points",
                                      "2048"])
    with pytest.raises(_Stop):
        _load_script("bench_train_step").main()
    pts, colors = bench_train_step.train_bench_inputs(2048)
    for name, a, b in (("pts", pts, got["pts"]),
                       ("colors", colors, got["colors"])):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert dict(bench_train_step.train_bench_args()) == dict(got["args"])
    s, js = bench_train_step.step_settings(), got["settings"]
    assert (s.height, s.width, s.vfov, s.hfov, s.num_extra_features,
            s.compute_distortion) == (js.height, js.width, js.vfov, js.hfov,
                                      js.num_extra_features,
                                      js.compute_distortion)
    assert got["cfg"].random_init_point == 0


def test_bench_step_matches_jax(monkeypatch):
    import jax
    from gslidar_tpu.config import Config as JC
    from gslidar_tpu.engine import train as JT
    from gslidar_tpu.models import gaussians as JG
    from gslidar_tpu.models.raydrop_prior import init_raydrop_prior
    from gslidar_tpu_torch.engine import train as TT
    bts = bench_train_step
    monkeypatch.setattr(bts, "H", 32)
    monkeypatch.setattr(bts, "W", 128)
    pts, colors = bts.train_bench_inputs(2048)
    params, aux = JG.create_from_pcd(pts, colors, None,
                                     JG.GaussianConfig(random_init_point=0),
                                     capacity=2048)
    state0 = JT.init_train_state(params, aux, init_raydrop_prior(32, 128))
    tstate = TT.state_from_numpy(jax.tree.map(np.asarray, state0), "cpu")
    c = bts.bench_camera(0, "cpu")
    cam = dict(viewmat=c.viewmat.numpy(), campos=c.campos.numpy(),
               timestamp=c.timestamp, towards_idx=c.towards_idx,
               pts_depth=c.pts_depth.numpy(),
               pts_intensity=c.pts_intensity.numpy())
    assert_step_matches(state0, tstate, cam, iteration=bts.ITERATION,
                        sh=bts.SH_DEGREE,
                        args=JC(dict(bts.train_bench_args())),
                        no_grad_keys=STATIC_NO_GRAD)


def _replay_counts(prep, settings):
    """scripts/tile_stats.py:44-62: per-tile counts, a numpy replay of the
    modular column walk over gslidar_tpu's preprocess output (restated:
    it is local to the script's main)."""
    tt = np.asarray(prep.tiles_touched)
    rmin = np.asarray(prep.rect_min)
    rmax = np.asarray(prep.rect_max)
    valid = np.asarray(prep.valid)
    gx, gy = settings.tiles_x, settings.tiles_y
    counts = np.zeros(gx * gy + 1, np.int64)
    v = valid & (tt > 0)
    x0 = rmin[v, 0]
    y0 = rmin[v, 1]
    wt = rmax[v, 0] - rmin[v, 0]
    ht = rmax[v, 1] - rmin[v, 1]
    for dy in range(int(ht.max()) if len(ht) else 0):
        rows_ok = ht > dy
        for dx in range(int(wt.max()) if len(wt) else 0):
            m = rows_ok & (wt > dx)
            xc = x0[m] + dx
            if settings.wrap_x:
                xc = np.where(xc >= gx, xc - gx, xc)
            t = (y0[m] + dy) * gx + xc
            np.add.at(counts, t, 1)
    return counts[:gx * gy]


@pytest.mark.parametrize("tile", ["16x16", "8x64", "32x32"])
def test_tile_counts_match_the_scripts_replay(tile):
    import jax.numpy as jnp
    import bench as JB
    from gslidar_tpu.raster.preprocess import preprocess
    from gslidar_tpu.raster.settings import RasterSettings as JS
    th, tw = TB.parse_tiles(tile)
    js = JS(height=66, width=1030, vfov=(-24.9, 2.0), hfov=(-180, 180),
            num_extra_features=4, tile_h=th, tile_w=tw, wrap_x=True,
            pair_cap=1 << 22, tile_list_cap=1 << 16)
    sc = JB.build_scene(P, 0)
    prep = preprocess(sc["means3D"], sc["scales"], sc["rotations"],
                      sc["opacity"], sc["shs"], sc["mask"],
                      jnp.eye(4, dtype=jnp.float32), jnp.zeros(3), 3, 0.1,
                      js)
    want = _replay_counts(prep, js)
    got = tile_stats.tile_counts(TB.build_scene(P, 0),
                                 TB.bench_settings(th, tw))
    assert want.sum() > 0
    np.testing.assert_array_equal(got, want)


def test_tile_stats_prints_the_scripts_lines(small_bench, capsys):
    _load_script("tile_stats").main()
    want = capsys.readouterr().out.strip().splitlines()
    tile_stats.main(["--device", "cpu", "--points", str(P)])
    got = capsys.readouterr().out.strip().splitlines()
    assert got[0].startswith("device: cpu")
    got = got[1:]
    assert len(got) == len(want) == len(tile_stats.TILES)
    for g, w in zip(got, want):
        if "skip" in g:          # more than 1024 pixels: no CUDA tile
            assert g.split(":")[0] == w.split(":")[0] and "1024" in g
        else:
            assert g == w
    assert sum("skip" in g for g in got) == 2


def test_measure_tight_rects_counts_are_the_scripts(small_bench, capsys):
    _load_script("measure_tight_rects").main()
    want = capsys.readouterr().out.strip().splitlines()
    measure_tight_rects.main(["--device", "cpu", "--points", str(P)])
    got = capsys.readouterr().out.strip().splitlines()
    assert len(want) == 3 and want[0].startswith("K current")
    assert got[1:4] == want
    assert "instances with square rects" in got[4]
    assert got[5].startswith("render, tight vs square rects (")


def test_tight_rect_bars_catch_a_changed_render():
    """``over_bars``: test_raster.py's bars on the open pixels, and T_STOP
    more for the outputs of T on the saturated ones (here the left half
    of the panorama, its final T set below T_STOP in both renders)."""
    import dataclasses
    mtr = measure_tight_rects
    sc = TB.build_scene(2048, 0)
    s = TB.bench_settings()
    a = TB.render_360(sc, s)
    b = TB.render_360(sc, dataclasses.replace(s, tight_rects=False))
    same, flips, n_open = mtr.render_differences(a, a)
    assert all(v == (True, 0.0, 0.0) for v in same.values()) and flips == 0
    left = torch.zeros_like(a.final_T)
    left[..., :s.width // 2] = 1.0
    a = a._replace(final_T=torch.where(left > 0, 5e-5, a.final_T))
    b = b._replace(final_T=torch.where(left > 0, 5e-5, b.final_T))
    diffs, _, n_open = mtr.render_differences(a, b)
    assert n_open == s.height * (s.width - s.width // 2)
    assert mtr.over_bars(diffs) == []
    # 1e-5 more color is seen on the open pixels, not on the saturated
    diffs, _, _ = mtr.render_differences(a, b._replace(
        color=b.color + 1e-5 * left))
    assert mtr.over_bars(diffs) == []
    diffs, _, _ = mtr.render_differences(a, b._replace(
        color=b.color + 1e-5 * (1 - left)))
    assert mtr.over_bars(diffs) == ["color"]
    # on the saturated ones T_STOP is allowed, 2e-4 is not
    diffs, _, _ = mtr.render_differences(a, b._replace(
        alpha=b.alpha + 9e-5 * left, final_T=b.final_T + 9e-5 * left))
    assert mtr.over_bars(diffs) == []
    diffs, _, _ = mtr.render_differences(a, b._replace(
        alpha=b.alpha + 2e-4 * left))
    assert mtr.over_bars(diffs) == ["alpha"]
    # features do not depend on where the walk stopped
    diffs, _, _ = mtr.render_differences(a, b._replace(
        feature=b.feature + 1e-4 * left))
    assert mtr.over_bars(diffs) == ["feature"]


def test_profile_render_prints_every_stage(capsys):
    profile_render.main(["--device", "cpu", "--points", "2048", "--reps",
                         "1", "--tiles", "16x16", "8x32"])
    out = capsys.readouterr().out
    for tile in ("16x16", "8x32"):
        assert f"--- tile {tile}" in out
    for label in profile_render.LABELS:
        assert out.count(label) == 2, label
    assert out.count("renders/s back to back") == 2
    with pytest.raises(SystemExit, match="--trace"):
        profile_render.main(["--device", "cpu", "--points", "64", "--trace"])


def test_train_step_scripts_print_every_stage(monkeypatch, capsys):
    monkeypatch.setattr(bench_train_step, "H", 16)
    monkeypatch.setattr(bench_train_step, "W", 64)
    profile_train_step.main(["--device", "cpu", "--points", "2048",
                             "--reps", "1"])
    out = capsys.readouterr().out
    assert "16x64" in out
    for label in profile_train_step.LABELS:
        assert label in out, label
    assert "it/s" in out
    bench_train_step.main(["--device", "cpu", "--points", "2048",
                           "--steps", "1"])
    out = capsys.readouterr().out
    assert "train step (16x16 tiles, P=2048): " in out
    assert "ms/step" in out and "30k iters in" in out
    with pytest.raises(SystemExit, match="--trace"):
        profile_train_step.main(["--device", "cpu", "--points", "64",
                                 "--trace"])


def test_run_selected_spoofs_calls_the_port(tmp_path):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    calls = tmp_path / "calls.txt"
    stub = bindir / "python"
    stub.write_text("#!/bin/bash\n"
                    f'echo "$CUDA_VISIBLE_DEVICES|$*" >> {calls}\n')
    stub.chmod(0o755)
    work = tmp_path / "work"
    (work / "all_configs").mkdir(parents=True)
    (work / "all_configs" / "opv2v_spoof_attack_23.yaml").write_text("{}\n")
    script = os.path.join(REPO, "gslidar_tpu_torch", "scripts",
                          "run_selected_spoofs.sh")
    env = dict(os.environ, PATH=f"{bindir}:{os.environ['PATH']}")
    r = subprocess.run(["bash", script, "3", "23,56"], cwd=work, env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    assert calls.read_text().splitlines() == [
        "3|-m gslidar_tpu_torch.train --config "
        "all_configs/opv2v_spoof_attack_23.yaml "
        "model_path=eval_output/opv2v_reconstruction/spoof_23"]
    assert ("config not found: all_configs/opv2v_spoof_attack_56.yaml, "
            "skipping.") in r.stdout
    assert r.stdout.strip().endswith("all runs complete.")
    r = subprocess.run(["bash", script, "3"], cwd=work, env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 1 and r.stdout.startswith("usage:")
