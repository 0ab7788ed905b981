"""The raw KITTI-360 pipeline of the port against gslidar_tpu's, on seeded
raw trees (no real KITTI-360 sweeps are in the repository):

* ``data/kitti360_tree.py`` writes, byte for byte, the trees of the JAX
  package's raw-format fixtures: the toy one of
  tests/test_dress_rehearsal.py (2,500 points per sweep, pose ids with
  ``fid % 7 == 3`` skipped) and the production-density one of
  tests/test_scale_rehearsal.py (120,000 points, every pose; on a 4-frame
  window here, the same seeded stream);
* ``data/preprocess/kitti360_to_gs`` gives the same transforms JSON as the
  JAX package's converter, skipped poses carried forward;
* ``read_kitti360_info`` of both packages, with ``np.random`` seeded alike
  before each, then each package's ``Scene``, for kitti360_nvs_1908
  (static) and kitti360_nvs_10750 (dynamic, three resolution scales):
  every camera's R, T, timestamp and projected range and intensity
  panoramas, the point cloud with its colours and times, the scale
  factor, ``nerf_normalization``, the train / test split and the time
  interval; integers exactly, floats within 1e-6;
* ``python -m gslidar_tpu_torch.train --config
  configs/kitti360_nvs_1908.yaml --device cpu`` on the toy tree for 12
  steps (a densify at 8), through its final eval, refine and
  refine_test, to metrics.json.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQS = {"1908": "kitti360_nvs_1908.yaml", "10750": "kitti360_nvs_10750.yaml"}


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _assert_same_tree(a, b):
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb) and fa
    for k in fa:
        assert fa[k] == fb[k], k


def test_tree_matches_dress_rehearsal_fixture(tmp_path):
    from gslidar_tpu_torch.data.kitti360 import SEQ_TABLE
    from gslidar_tpu_torch.data.kitti360_tree import write_kitti360_tree
    from tests.test_dress_rehearsal import fabricate_kitti_raw
    s, e, _ = SEQ_TABLE["1908"]
    want = fabricate_kitti_raw(tmp_path / "jax", s, e)
    got, n = write_kitti360_tree(tmp_path / "torch", s, e)
    assert n == 2500 * (e + 1 - s)
    _assert_same_tree(got, want)
    with open(os.path.join(got, "data_poses", "2013_05_28_drive_0000_sync",
                           "poses.txt")) as f:
        ids = [int(line.split()[0]) for line in f]
    skipped = [i for i in range(s, e + 1) if i % 7 == 3]
    assert skipped and not set(ids) & set(skipped)


def test_tree_matches_scale_rehearsal_fixture(tmp_path):
    from gslidar_tpu_torch.data.kitti360_tree import write_kitti360_tree
    from tests.test_scale_rehearsal import fabricate_kitti_raw_dense
    want = fabricate_kitti_raw_dense(tmp_path / "jax", 1908, 1911)
    got, n = write_kitti360_tree(tmp_path / "torch", 1908, 1911,
                                 pts_per_sweep=120_000, skip_poses=False)
    assert n == 4 * 120_000
    _assert_same_tree(got, want)


def _args(config_mod, seq, root, model_path, extra=None):
    cfg = config_mod.Config
    args = cfg.merge(cfg.load(os.path.join(REPO, "configs", "base.yaml")),
                     cfg.load(os.path.join(REPO, "configs", SEQS[seq])),
                     {"hw": [16, 64], "num_pts": 20000,
                      "source_path": str(root),
                      "model_path": str(model_path), **(extra or {})})
    os.makedirs(model_path)
    return args


def _convert(seq, root, pkg):
    r = subprocess.run(
        [sys.executable, "-m", f"{pkg}.data.preprocess.kitti360_to_gs",
         "--seq", seq, "--kitti_root", str(root / "KITTI-360"),
         "--out", str(root)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    with open(root / seq / f"transforms_{seq}_all.json") as f:
        return f.read()


def _cam_key(c):
    return (c.uid, c.colmap_id, c.timestamp, c.towards, c.width, c.height)


@pytest.mark.parametrize("seq", sorted(SEQS))
def test_read_kitti360_info_matches_jax(seq, tmp_path):
    import gslidar_tpu.config as jax_config
    import gslidar_tpu_torch.config as torch_config
    from gslidar_tpu.data.kitti360 import read_kitti360_info as jax_read
    from gslidar_tpu.data.scene import Scene as JaxScene
    from gslidar_tpu_torch.data.kitti360 import SEQ_TABLE, read_kitti360_info
    from gslidar_tpu_torch.data.kitti360_tree import write_kitti360_tree
    from gslidar_tpu_torch.data.scene import Scene
    s, e, val = SEQ_TABLE[seq]
    root = tmp_path / "data"
    write_kitti360_tree(root, s, e)
    got_json = _convert(seq, root, "gslidar_tpu_torch")
    assert _convert(seq, root, "gslidar_tpu") == got_json
    frames = json.loads(got_json)["frames"]
    assert len(frames) == e + 1 - s
    skip = next(i for i in range(1, len(frames)) if (s + i) % 7 == 3)
    assert frames[skip]["lidar2world"] == frames[skip - 1]["lidar2world"]

    runs = []
    for name, mod, read, scene_cls in (
            ("jax", jax_config, jax_read, JaxScene),
            ("torch", torch_config, read_kitti360_info, Scene)):
        args = _args(mod, seq, root, tmp_path / name)
        np.random.seed(0)
        info = read(args)
        runs.append((info, args, scene_cls(args, info, shuffle=False)))
    (want, want_args, want_scene), (got, got_args, got_scene) = runs

    assert got_args.scale_factor == want_args.scale_factor
    assert got_args.frames == want_args.frames == e + 1 - s
    assert len(got.point_cloud[0]) == 20000
    for a, b in zip(got.point_cloud, want.point_cloud):
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for k in ("translate", "radius"):
        np.testing.assert_allclose(got.nerf_normalization[k],
                                   want.nerf_normalization[k], atol=1e-6)
    assert (got.time_interval, got.time_duration) == \
        (want.time_interval, want.time_duration)
    # the split: the test pairs are the val frames' front and back
    assert [c.uid for c in got.test_cameras] == \
        [c.uid for c in want.test_cameras]
    assert [c.uid for c in got.train_cameras] == \
        [c.uid for c in want.train_cameras]
    assert len(got.test_cameras) == 2 * len(val)
    assert len(got.train_cameras) == 2 * (e + 1 - s - len(val))

    scales = list(got_args.resolution_scales)
    assert scales == ([1] if seq == "1908" else [1, 2, 4])
    for rs in scales:
        for split in ("train_cameras", "test_cameras"):
            gc = getattr(got_scene, split)[rs]
            wc = getattr(want_scene, split)[rs]
            assert len(gc) == len(wc) > 0
            for g, w in zip(gc, wc):
                assert _cam_key(g) == _cam_key(w)
                for k in ("R", "T", "pts_depth", "pts_intensity"):
                    a, b = getattr(g, k), np.asarray(getattr(w, k))
                    assert a.shape == b.shape, (rs, k)
                    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6,
                                               err_msg=f"{rs} {k}")
                assert (g.pts_depth > 0).any()


def test_train_cli_on_the_raw_tree(tmp_path):
    """The port's CLI on kitti360_nvs_1908 over the toy tree, on the CPU:
    the converter's JSON, the loader, 12 steps with a densify at 8, the
    final eval, 2 refine epochs and refine_test."""
    from gslidar_tpu_torch.data.kitti360 import SEQ_TABLE
    from gslidar_tpu_torch.data.kitti360_tree import write_kitti360_tree
    s, e, _ = SEQ_TABLE["1908"]
    root = tmp_path / "data"
    write_kitti360_tree(root, s, e)
    _convert("1908", root, "gslidar_tpu_torch")
    run = tmp_path / "run"
    r = subprocess.run(
        [sys.executable, "-m", "gslidar_tpu_torch.train", "--config",
         os.path.join(REPO, "configs", "kitti360_nvs_1908.yaml"),
         "--device", "cpu", f"source_path={root}", f"model_path={run}",
         "hw=[16,64]", "num_pts=3000", "iterations=12",
         "densify_from_iter=4", "densification_interval=4",
         "densify_until_iter=10", "test_iterations=[12]",
         "checkpoint_iterations=[12]", "vis_step=12", "refine_epochs=2"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=600)
    log = (run / "log.txt").read_text() if (run / "log.txt").exists() else ""
    assert r.returncode == 0, r.stderr[-2000:] + log[-3000:]
    assert "[8] densify: 3000 -> " in log, log[-3000:]
    assert "trained 12 steps to" in log
    assert (run / "scale_factor.txt").exists()
    assert (run / "transform_poses_pca.npz").exists()
    assert (run / "ckpt" / "chkpnt12.npz").exists()
    for name in ("test_12_render", "train_12_render", "test_refine_render"):
        with open(run / "eval" / name / "metrics.json") as f:
            m = json.load(f)
        depth = m["Depth"]["RMSE"]
        assert depth is not None and np.isfinite(depth), (name, m)
    with open(run / "eval" / "test_12_render" / "metrics.json") as f:
        m = json.load(f)
    assert np.isfinite(m["Point Cloud mix"]["C-D"])
