"""The port's own copies of gslidar_tpu's numpy modules against the
originals: the run config, the Synthetic scene loader and the native
panorama z-buffer."""

import glob
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = os.path.join(REPO, "configs", "base.yaml")
CONFIGS = sorted(p for p in glob.glob(os.path.join(REPO, "configs", "*.yaml"))
                 if p != BASE)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_run_config_matches_jax(path):
    from gslidar_tpu.config import load_run_config as jax_load
    from gslidar_tpu_torch.config import Config, load_run_config
    overrides = ["iterations=5", "hw=[16,64]", "a.b.c=1e-4", "flag="]
    got = load_run_config(BASE, path, overrides)
    want = jax_load(BASE, path, overrides)
    assert isinstance(got, Config)
    assert got == want
    assert got.a.b.c == 1e-4 and got.flag is None and got.hw == [16, 64]
    Config.update(got, "model_path", "/x")
    assert got.model_path == "/x" and got.get("nope", 3) == 3


def _synthetic_args(config_mod, model_path):
    cfg = config_mod.Config
    return cfg.merge(cfg.load(BASE),
                     cfg.load(os.path.join(REPO, "configs",
                                           "synthetic_smoke.yaml")),
                     {"hw": [16, 64], "frames": 4, "num_pts": 3000,
                      "model_path": str(model_path)})


def test_read_synthetic_info_matches_jax(tmp_path):
    import gslidar_tpu.config as jax_config
    import gslidar_tpu_torch.config as torch_config
    from gslidar_tpu.data.synthetic import read_synthetic_info as jax_read
    from gslidar_tpu_torch.data.synthetic import read_synthetic_info
    infos = []
    for name, mod, read in (("jax", jax_config, jax_read),
                            ("torch", torch_config, read_synthetic_info)):
        (tmp_path / name).mkdir()
        args = _synthetic_args(mod, tmp_path / name)
        np.random.seed(0)
        infos.append((read(args), args))
    (want, want_args), (got, got_args) = infos
    assert got_args.scale_factor == want_args.scale_factor
    assert got_args.frames == want_args.frames
    for a, b in zip(got.point_cloud, want.point_cloud):
        np.testing.assert_array_equal(a, b)
    for split in ("train_cameras", "test_cameras"):
        gc, wc = getattr(got, split), getattr(want, split)
        assert len(gc) == len(wc) > 0
        for g, w in zip(gc, wc):
            assert (g.uid, g.timestamp, g.towards, g.sequence_id) == \
                (w.uid, w.timestamp, w.towards, w.sequence_id)
            for k in ("R", "T", "pointcloud_camera", "intensity"):
                np.testing.assert_array_equal(getattr(g, k), getattr(w, k))
    for k in ("translate", "radius"):
        np.testing.assert_array_equal(got.nerf_normalization[k],
                                      want.nerf_normalization[k])
    assert (got.time_interval, got.time_duration) == \
        (want.time_interval, want.time_duration)
    assert os.path.basename(got.ply_path) == "points3d.ply"


def test_cameras_match_jax():
    from gslidar_tpu.data import cameras as JC
    from gslidar_tpu_torch.data import cameras as TC
    rng = np.random.default_rng(4)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    infos = [TC.CameraInfo(uid=i, R=q, T=rng.normal(size=3))
             for i in range(3)]
    jinfos = [JC.CameraInfo(uid=c.uid, R=c.R, T=c.T) for c in infos]
    a, b = TC.get_nerfpp_norm(infos), JC.get_nerfpp_norm(jinfos)
    np.testing.assert_array_equal(a["translate"], b["translate"])
    assert a["radius"] == b["radius"]
    kw = dict(colmap_id=1, uid=0, R=q, T=infos[0].T, vfov=(-24.9, 2.0),
              hfov=(-90.0, 90.0), width=64, height=16)
    tc, jc = TC.Camera(**kw), JC.Camera(**kw)
    np.testing.assert_array_equal(tc.world_view_transform,
                                  jc.world_view_transform)
    np.testing.assert_array_equal(tc.camera_center, jc.camera_center)
    assert tc.name == jc.name


def test_native_project_pano_matches_numpy(monkeypatch):
    from gslidar_tpu_torch import native
    from gslidar_tpu_torch.ops import pano
    if native.get_native() is None:
        pytest.skip("the native extension does not build here")
    rng = np.random.default_rng(8)
    pts = rng.normal(size=(5000, 3)) * 20
    inten = rng.uniform(0, 1, 5000).astype(np.float32)
    args = (pts, inten, 16, 64, (-24.9, 2.0), (-180.0, 180.0))
    fast = pano.project_points_to_pano(*args)
    monkeypatch.setattr(native, "get_native", lambda: None)
    slow = pano.project_points_to_pano(*args)
    # the same nearest return per pixel; the C++ z-buffer takes the range
    # from float32 points, numpy in float64
    np.testing.assert_array_equal(fast[0] > 0, slow[0] > 0)
    assert (fast[0] > 0).any()
    for a, b in zip(fast, slow):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
