"""The port's OPV2V scene path against gslidar_tpu on the CPU: its copy of
``data/opv2v.py``, the two offline preprocess scripts, the scene dispatch
and one dynamic training step on an OPV2V scene.

Inputs are a seeded tiny OPV2V tree (``data/opv2v_tree.py``: 3 vehicles x
17 frames at opv2v_dynamic_2's frame window, 4 x 32 rays per sweep),
written once for the module, and seeded numpy arrays.

* the loader's helpers, ``read_opv2v_info`` (one vehicle, the ``all``
  wildcard, and ``debug_cuda``'s cut after 16 frames) and
  ``read_opv2v_info_spoof_remove`` (through a stub of the external
  ``attack`` module) give equal results, exactly, with ``np.random``
  seeded alike before each call;
* the split counts camera pairs across the concatenated vehicles (a
  finding recorded in ROADMAP.md, not a fault): opv2v_dynamic_2's
  ``val_frames`` [78, 88, 98] select pairs 10, 20 and 30 of the merged
  list;
* both preprocess scripts write the same bytes as the originals;
* ``build_scene`` dispatches ``OPV2V`` and ``OPV2V_SR``;
* one training step on the scene's first training camera with a nonzero
  time shift, against gslidar_tpu's, at tests/test_torch_train.py's bars
  (``torch_scenes.assert_step_matches``), the velocity group included;
* ``--debug_cuda`` cuts the scales and the frames.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = os.path.join(REPO, "configs", "base.yaml")
DYNAMIC = os.path.join(REPO, "configs", "opv2v_dynamic_2.yaml")
SPOOF = os.path.join(REPO, "configs", "opv2v_spoof_attack_0.yaml")
FRAME_IDS = list(range(68, 101, 2))          # opv2v_dynamic_2's window
HW = (32, 64)


def _write_tree(root):
    from gslidar_tpu_torch.data.opv2v_tree import write_opv2v_tree
    return write_opv2v_tree(str(root), FRAME_IDS, n_el=4, n_az=32,
                            world_n=2000, body_n=100)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tiny tree with the transforms JSONs of the port's preprocess."""
    from gslidar_tpu_torch.data.preprocess import opv2v_to_gs
    root = tmp_path_factory.mktemp("opv2v") / "data"
    assert _write_tree(root) > 2000
    opv2v_to_gs.main(str(root))
    return root


def _args(pkg, model_path, config=DYNAMIC, extra=()):
    """A run config of ``pkg`` ("jax" or "torch"), as each entry point
    loads it."""
    if pkg == "jax":
        from gslidar_tpu.config import load_run_config
    else:
        from gslidar_tpu_torch.config import load_run_config
    os.makedirs(model_path, exist_ok=True)
    return load_run_config(BASE, config, [
        f"model_path={model_path}", "num_pts=2000", f"hw=[{HW[0]},{HW[1]}]",
        *extra])


def _read_both(tmp_path, read_name, config=DYNAMIC, extra=(),
               before=lambda: None):
    """(JAX's, the port's) (SceneInfo, args) of loader ``read_name`` on
    the same config, ``np.random`` seeded alike before each."""
    import gslidar_tpu.data.opv2v as J
    import gslidar_tpu_torch.data.opv2v as T
    out = []
    for pkg, mod in (("jax", J), ("torch", T)):
        args = _args(pkg, tmp_path / pkg, config, extra)
        before()
        np.random.seed(0)
        out.append((getattr(mod, read_name)(args), args))
    return out


def _assert_infos_equal(want, got):
    (wi, wa), (gi, ga) = want, got
    for a, b in zip(gi.point_cloud, wi.point_cloud):
        np.testing.assert_array_equal(a, b)
    for split in ("train_cameras", "test_cameras"):
        gc, wc = getattr(gi, split), getattr(wi, split)
        assert len(gc) == len(wc)
        for g, w in zip(gc, wc):
            for f in ("R", "T", "pointcloud_camera", "intensity"):
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
            for f in ("uid", "timestamp", "towards", "sequence_id"):
                assert getattr(g, f) == getattr(w, f), f
    assert gi.nerf_normalization["radius"] == wi.nerf_normalization["radius"]
    np.testing.assert_array_equal(gi.nerf_normalization["translate"],
                                  wi.nerf_normalization["translate"])
    assert gi.time_interval == wi.time_interval
    assert gi.time_duration == wi.time_duration
    assert ga.scale_factor == wa.scale_factor
    assert ga.frames == wa.frames
    for name in ("points3d.ply", "transform_poses_pca.npz"):
        with open(os.path.join(wa.model_path, name), "rb") as f, \
                open(os.path.join(ga.model_path, name), "rb") as g:
            assert f.read() == g.read(), name


def test_loader_helpers_match_jax(tmp_path):
    import gslidar_tpu.data.opv2v as J
    import gslidar_tpu_torch.data.opv2v as T
    rng = np.random.default_rng(7)
    for angles in rng.uniform(-np.pi, np.pi, (8, 3)):
        np.testing.assert_array_equal(T.rotation_matrix(*angles),
                                      J.rotation_matrix(*angles))
        calib = {"lidar_pose": [*rng.uniform(-50, 50, 3),
                                *np.degrees(angles)]}
        np.testing.assert_array_equal(T.get_c2w_matrix(calib),
                                      J.get_c2w_matrix(calib))
    pts = rng.normal(size=(5000, 3)) * [20, 20, 2]
    for m in (1234, 4999):                     # the points > M branch
        got = T.subsample_pointcloud(pts, m)
        np.testing.assert_array_equal(got, J.subsample_pointcloud(pts, m))
        assert len(got) <= m
    np.testing.assert_array_equal(T.subsample_pointcloud(pts, 6000),
                                  np.arange(5000))
    good = tmp_path / "good.npy"
    np.save(good, rng.normal(size=(300, 2)))
    bad = tmp_path / "bad.npy"
    np.save(bad, np.ones((10, 2)))
    for path, attack_id in [(good, 0), (good, 299), (good, 300), (good, -1),
                            (bad, 5), (tmp_path / "missing.npy", 5)]:
        got = T.load_spoof_offsets(str(path), attack_id)
        assert got == J.load_spoof_offsets(str(path), attack_id)
    assert T.load_spoof_offsets(str(good), 3) == \
        np.load(good)[3].tolist() != [0.0, 0.0]


@pytest.mark.parametrize("extra", [["sequence_id='650'"], [],
                                   ["debug_cuda=true"]],
                         ids=["one_vehicle", "all", "debug_cuda"])
def test_read_opv2v_info_matches_jax(tree, tmp_path, extra):
    want, got = _read_both(tmp_path, "read_opv2v_info",
                           extra=[f"source_path={tree}", *extra])
    _assert_infos_equal(want, got)
    info, args = got
    assert args.frames == 17
    n_vehicles = 1 if extra == ["sequence_id='650'"] else 3
    frames_read = 16 if extra == ["debug_cuda=true"] else 17
    cams = info.train_cameras + info.test_cameras
    assert len(cams) == 2 * n_vehicles * frames_read
    # the grid subsample keeps at most num_pts (fewer where cells are thin)
    assert 1500 < len(info.point_cloud[0]) <= 2000
    assert info.time_interval == 1 / 16


def test_split_counts_pairs_across_vehicles(tree, tmp_path):
    """The split key ``i // cam_num + frame_start`` (opv2v.py:135-142)
    counts camera pairs of the merged list: it ignores ``frame_stride``
    and runs on across vehicles. opv2v_dynamic_2's val_frames [78, 88, 98]
    with frame_start 68, stride 2 and 3 vehicles of 17 frames select pairs
    10, 20 and 30: vehicle 641's frame 88 and vehicle 650's frames 74 and
    94, and no frame 78 or 98; one vehicle alone gets only its frame 88."""
    _, (info, args) = _read_both(tmp_path, "read_opv2v_info",
                                 extra=[f"source_path={tree}"])
    assert list(args.val_frames) == [78, 88, 98] and args.frame_start == 68
    test = [(c.sequence_id, c.uid, c.towards) for c in info.test_cameras]
    assert test == [("641", 10, "forward"), ("641", 27, "backward"),
                    ("650", 3, "forward"), ("650", 20, "backward"),
                    ("650", 13, "forward"), ("650", 30, "backward")]
    assert len(info.train_cameras) == 2 * 48
    _, (one, _) = _read_both(tmp_path / "one", "read_opv2v_info",
                             extra=[f"source_path={tree}",
                                    "sequence_id='659'"])
    assert [(c.uid, c.towards) for c in one.test_cameras] == \
        [(10, "forward"), (27, "backward")]
    assert len(one.train_cameras) == 2 * 16


class _StubAttacker:
    """The external ``attack.GeneralAttacker``: seeded sweeps of 2
    vehicles over 3 frames, fresh arrays per call; records its calls."""
    calls = []

    def attack(self, **kw):
        _StubAttacker.calls.append(kw)
        rng = np.random.default_rng(11)
        frames, cars = [80, 82, 84], ["641", "650"]
        lidar = [{car: {"lidar": np.concatenate(
            [rng.normal(size=(300, 3)) * 10, rng.uniform(0, 1, (300, 1))],
            1).astype(np.float32),
            "lidar_pose": [5.0 * k + i, 2.0 * k, 1.9, 0.0, 10.0 * i, 0.0]}
            for k, car in enumerate(cars)} for i in range(len(frames))]
        return None, lidar, {"frame_ids": frames, "vehicle_ids": cars}, None


@pytest.fixture
def stub_attack(monkeypatch):
    monkeypatch.setitem(sys.modules, "attack", types.SimpleNamespace(
        GeneralAttacker=_StubAttacker))
    monkeypatch.setattr(sys, "path", list(sys.path))
    _StubAttacker.calls = []
    return _StubAttacker


@pytest.mark.parametrize("sequence_id", ["all", "650"])
def test_spoof_remove_matches_jax(tmp_path, stub_attack, sequence_id):
    offsets = tmp_path / "offsets.npy"
    np.save(offsets, np.random.default_rng(3).normal(size=(300, 2)))
    want, got = _read_both(
        tmp_path, "read_opv2v_info_spoof_remove", config=SPOOF,
        extra=[f"spoof_offset={offsets}", "attack_id=4",
               f"sequence_id='{sequence_id}'"])
    _assert_infos_equal(want, got)
    info, args = got
    assert args.frame_start == 80 and args.frames == 3
    n = 2 if sequence_id == "all" else 1
    assert len(info.train_cameras) + len(info.test_cameras) == 2 * 3 * n
    # the offset of attack 4 reached the attacker, from both packages
    assert [c["offset"] for c in stub_attack.calls] == \
        [np.load(offsets)[4].tolist()] * 2
    assert all(c["attack_frame_ids"] == [9] for c in stub_attack.calls)


def test_spoof_remove_writes_intensity_into_the_attackers_array(
        tmp_path, stub_attack, monkeypatch):
    """``rec["lidar"][:, 3] = 1.0`` writes into the attacker's own array
    (opv2v.py:256), as in gslidar_tpu."""
    import gslidar_tpu_torch.data.opv2v as T
    seen = []
    attack = _StubAttacker.attack

    def keep(self, **kw):
        out = attack(self, **kw)
        seen.append(out[1])
        return out
    monkeypatch.setattr(_StubAttacker, "attack", keep)
    args = _args("torch", tmp_path / "run", SPOOF,
                 [f"spoof_offset={tmp_path / 'none.npy'}"])
    np.random.seed(0)
    T.read_opv2v_info_spoof_remove(args)
    assert all((rec["lidar"][:, 3] == 1.0).all()
               for frame in seen[0] for rec in frame.values())


def test_opv2v_to_gs_writes_the_same_bytes(tmp_path):
    from gslidar_tpu.data.preprocess import opv2v_to_gs as J
    for name in ("jax", "port"):
        _write_tree(tmp_path / name)
    J.main(str(tmp_path / "jax"))
    r = subprocess.run(
        [sys.executable, "-m", "gslidar_tpu_torch.data.preprocess.opv2v_to_gs",
         "--base", str(tmp_path / "port")], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    sub = os.path.join("test_transform", "2021_08_18_19_48_05")
    names = sorted(os.listdir(tmp_path / "jax" / sub))
    assert len(names) == 3
    assert names == sorted(os.listdir(tmp_path / "port" / sub))
    for n in names:
        assert (tmp_path / "jax" / sub / n).read_bytes() == \
            (tmp_path / "port" / sub / n).read_bytes(), n
    frames = json.loads((tmp_path / "port" / sub / names[0]).read_text())
    assert [f["idx"] for f in frames["frames"]] == FRAME_IDS


def test_kitti360_to_gs_writes_the_same_bytes(tmp_path):
    from gslidar_tpu.data.kitti360 import SEQ_TABLE
    from gslidar_tpu.data.preprocess import kitti360_to_gs as J
    from test_dress_rehearsal import fabricate_kitti_raw
    s_frame, e_frame, _ = SEQ_TABLE["1908"]
    fabricate_kitti_raw(tmp_path, s_frame, e_frame)
    kitti = str(tmp_path / "KITTI-360")
    J.main("1908", kitti, str(tmp_path / "jax"))
    r = subprocess.run(
        [sys.executable, "-m",
         "gslidar_tpu_torch.data.preprocess.kitti360_to_gs", "--seq", "1908",
         "--kitti_root", kitti, "--out", str(tmp_path / "port")], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    name = os.path.join("1908", "transforms_1908_all.json")
    assert (tmp_path / "jax" / name).read_bytes() == \
        (tmp_path / "port" / name).read_bytes()


def test_build_scene_dispatches_opv2v(tree, tmp_path, stub_attack):
    from gslidar_tpu_torch.render import build_scene
    args = _args("torch", tmp_path / "a", extra=[f"source_path={tree}"])
    np.random.seed(0)
    scene = build_scene(args)
    assert len(scene.get_train_cameras()) == 96
    assert len(scene.get_test_cameras(1)) == 6
    assert scene.get_wh() == (HW[1], HW[0])
    args = _args("torch", tmp_path / "b", SPOOF,
                 [f"spoof_offset={tmp_path / 'none.npy'}"])
    scene = build_scene(args)
    assert len(scene.get_train_cameras()) + len(scene.get_test_cameras(1)) \
        == 12 and len(stub_attack.calls) == 1
    args.scene_type = "Waymo"
    with pytest.raises(ValueError, match="unknown scene_type"):
        build_scene(args)


def test_dynamic_opv2v_step_matches_jax(tree, tmp_path):
    """One step of opv2v_dynamic_2 (dynamic, its lambdas and learning
    rates) from create_from_pcd of the tiny scene's points, on its first
    training camera, with a nonzero self-supervision time shift."""
    import jax
    from torch_scenes import assert_step_matches
    from gslidar_tpu.engine import train as JT
    from gslidar_tpu.models import gaussians as JG
    from gslidar_tpu.models.raydrop_prior import init_raydrop_prior
    from gslidar_tpu_torch.engine import train as TT
    from gslidar_tpu_torch.render import build_scene, gaussian_config
    targs = _args("torch", tmp_path / "torch", extra=[f"source_path={tree}"])
    np.random.seed(0)
    scene = build_scene(targs)
    jargs = _args("jax", tmp_path / "jax", extra=[f"source_path={tree}"])
    jargs.scale_factor = targs.scale_factor
    cfg = gaussian_config(targs)
    cfg_kw = dict(t_init=cfg.t_init, cycle=cfg.cycle,
                  velocity_decay=cfg.velocity_decay,
                  time_duration=cfg.time_duration, random_init_point=0)
    pts, colors, _, times = scene.scene_info.point_cloud
    params, aux = JG.create_from_pcd(pts, colors, times,
                                     JG.GaussianConfig(**cfg_kw),
                                     capacity=4096)
    state0 = JT.init_train_state(params, aux, init_raydrop_prior(*HW))
    tstate = TT.state_from_numpy(jax.tree.map(np.asarray, state0), "cpu")
    c = scene.get_train_cameras()[0]
    cam = dict(viewmat=c.world_view_transform, campos=c.camera_center,
               timestamp=c.timestamp,
               towards_idx=0 if c.towards == "forward" else 1,
               pts_depth=c.pts_depth, pts_intensity=c.pts_intensity)
    time_shift = 3 * (0.8 - 0.5) * scene.time_interval
    ts = assert_step_matches(state0, tstate, cam, args=jargs, cfg_kw=cfg_kw,
                             time_shift=time_shift)
    for k in ("velocity", "t", "scaling_t"):
        assert not torch.equal(ts.params[k], tstate.params[k]), k


def test_debug_cuda_cuts_scales_and_frames(tree, tmp_path):
    """``--debug_cuda`` (root train.py:486,526-527): the last resolution
    scale only, and the loader stops each vehicle after 16 frames."""
    from gslidar_tpu_torch.train import parse_cli, prepare_run
    from gslidar_tpu_torch.render import build_scene
    argv = ["--config", DYNAMIC, "--base_config", BASE, "--device", "cpu",
            f"source_path={tree}", f"model_path={tmp_path / 'run'}",
            "num_pts=2000", f"hw=[{HW[0]},{HW[1]}]",
            "resolution_scales=[4,2,1]"]
    for flag, scales, pairs in ((["--debug_cuda"], [1], 48),
                                ([], [4, 2, 1], 51)):
        known, args = parse_cli(argv + flag)
        prepare_run(args)
        assert args.debug_cuda is bool(flag)
        assert args.resolution_scales == scales
        np.random.seed(0)
        scene = build_scene(args)
        n = len(scene.get_train_cameras()) + len(scene.get_test_cameras(1))
        assert n == 2 * pairs and args.frames == 17


def test_train_and_render_cli_on_opv2v(tree, tmp_path):
    """``python -m gslidar_tpu_torch.train`` on opv2v_dynamic_2 (the tiny
    tree, 4 steps, the final eval) and ``python -m gslidar_tpu_torch.
    render`` on its checkpoint: one 360-degree panorama per test pair."""
    from gslidar_tpu_torch import render as R
    from gslidar_tpu_torch import train as T
    run, out = tmp_path / "run", tmp_path / "out"
    T.main(["--config", DYNAMIC, "--base_config", BASE, "--device", "cpu",
            "--skip_refine", f"source_path={tree}", f"model_path={run}",
            "num_pts=2000", f"hw=[{HW[0]},{HW[1]}]", "iterations=4"])
    log = (run / "log.txt").read_text()
    assert "trained 4 steps to 2000 gaussians" in log, log[-2000:]
    for split in ("test", "train"):
        m = json.loads((run / "eval" / f"{split}_4_render" /
                        "metrics.json").read_text())
        assert 0 <= m["Ray drop"]["Acc"] <= 1
    R.main(["--config", DYNAMIC, "--base_config", BASE, "--device", "cpu",
            "--checkpoint", str(run / "ckpt" / "chkpnt4.npz"),
            "--out", str(out), f"source_path={tree}",
            f"hw=[{HW[0]},{HW[1]}]"])
    names = sorted(os.listdir(out / "render_test"))
    assert len(names) == 3 and names == sorted(os.listdir(out / "gt"))
    img = np.load(out / "render_test" / names[0])
    assert img.shape == (3, HW[0], 2 * HW[1]) and np.isfinite(img).all()
