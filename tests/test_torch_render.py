"""Port parity for the serving slice as a whole: ``engine.render.render``
and ``engine.evaluate.render_range_map`` of gslidar_tpu_torch against
gslidar_tpu's (XLA backend), on the same numpy model, prior and cameras.

Tolerances are the compositor's (test_torch_composite.py): channels at
5e-4, features 2e-3, mean depth 2e-2. The median and the depth "mix"
channel pick one splat's depth, so a T_before within rounding of 0.5 can
flip them: they are held to a pixel-fraction bar, as
tests/test_eval.py::test_full360_matches_stitch holds the stitch.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

H, VFOV, HFOV = 32, (-24.9, 2.0), (-90.0, 90.0)


def _model(P=3000, seed=7, dynamic=False, init_only=False):
    """test_eval's model: points in every azimuth, create_from_pcd init
    (JAX), returned as the numpy params dict and alive mask. Unless
    ``init_only``, opacities and SH are then drawn from the seed so every
    channel carries signal."""
    from gslidar_tpu.models import gaussians as JG
    rng = np.random.default_rng(seed)
    az = rng.uniform(-np.pi, np.pi, P)
    el = rng.uniform(np.radians(-20), np.radians(1.5), P)
    r = rng.uniform(4.0, 40.0, P)
    pts = np.stack([r * np.cos(el) * np.sin(az), r * np.sin(el),
                    r * np.cos(el) * np.cos(az)], axis=1).astype(np.float32)
    colors = rng.uniform(0, 1, (P, 3)).astype(np.float32)
    params, aux = JG.create_from_pcd(pts, colors, None,
                                     JG.GaussianConfig(random_init_point=0),
                                     capacity=4096)
    params = {k: np.array(v) for k, v in params.items()}
    if init_only:
        return params, np.array(aux.alive)
    params["opacity"][:] = rng.normal(0.0, 1.0, params["opacity"].shape)
    params["f_rest"][:] = rng.normal(0, 0.1, params["f_rest"].shape)
    if dynamic:
        params["velocity"][:] = rng.normal(0, 0.5, params["velocity"].shape)
        params["t"][:] = rng.uniform(-0.5, 0.5, params["t"].shape)
    return params, np.array(aux.alive)


def _settings(w, **kw):
    from gslidar_tpu.raster.settings import RasterSettings as JS
    from gslidar_tpu_torch.raster.settings import RasterSettings as TS
    common = dict(height=H, width=w, vfov=VFOV, hfov=HFOV,
                  num_extra_features=4, **kw)
    return (JS(pair_cap=1 << 16, tile_chunk=32, tile_list_cap=1 << 12,
               backend="xla", **common), TS(**common))


def _cameras(w):
    from gslidar_tpu.data.cameras import Camera
    from gslidar_tpu.data.kitti360 import BACK_FLIP_R
    gt = np.full((1, H, w), 7.0, np.float32)
    gi = np.full((1, H, w), 0.5, np.float32)
    R = np.array([[0.9950042, 0.0, 0.0998334], [0.0, 1.0, 0.0],
                  [-0.0998334, 0.0, 0.9950042]])       # 5.7 deg yaw
    T = np.array([0.3, -0.1, 0.2])
    front = Camera(colmap_id=0, uid=0, R=R, T=T, vfov=VFOV, hfov=HFOV,
                   width=w, height=H, timestamp=0.1, pts_depth=gt,
                   pts_intensity=gi, towards="forward")
    back = Camera(colmap_id=1, uid=1, R=R @ BACK_FLIP_R,
                  T=T * np.array([-1, 1, -1]), vfov=VFOV, hfov=HFOV,
                  width=w, height=H, timestamp=0.1, pts_depth=gt,
                  pts_intensity=gi, towards="backward")
    return front, back


def _args(dynamic=False):
    from gslidar_tpu.config import Config
    return Config({"scale_factor": 1.0, "dynamic": dynamic,
                   "sky_depth": False, "depth_blend_mode": 0,
                   "median_depth": False, "frames": 1, "vfov": VFOV,
                   "hfov": HFOV})


def _frac_bad(a, b, tol):
    return float((np.abs(np.asarray(a) - np.asarray(b)) > tol).mean())


@pytest.mark.parametrize("full360,dynamic",
                         [(False, False), (True, False), (False, True)])
def test_render_matches_jax(full360, dynamic):
    import jax.numpy as jnp
    from gslidar_tpu.engine.render import render as jrender
    from gslidar_tpu.models import gaussians as JG
    from gslidar_tpu_torch.engine.render import render as trender
    from gslidar_tpu_torch.models import gaussians as TG

    w = 64
    params, alive = _model(dynamic=dynamic)
    js, ts = _settings(w)
    if full360:
        pix = (HFOV[1] - HFOV[0]) / w
        hmin = HFOV[0] - (w // 2) * pix
        wide = dict(width=2 * w, hfov=(hmin, hmin + 2 * w * pix),
                    wrap_x=True)
        js, ts = (dataclasses.replace(js, **wide),
                  dataclasses.replace(ts, **wide))
    rng = np.random.default_rng(3)
    prior = rng.normal(size=(1, H, 2 * w)).astype(np.float32)
    front, back = _cameras(w)
    cam = front if full360 else back
    bg = [0.0, 0.0, 0.0, 1.0]
    kw = dict(dynamic=dynamic, full360=full360)
    a = jrender({k: jnp.asarray(v) for k, v in params.items()},
                jnp.asarray(alive), jnp.asarray(cam.world_view_transform),
                jnp.asarray(cam.camera_center), jnp.float32(cam.timestamp),
                1, jnp.asarray(prior), jnp.asarray(bg), 3, 1.0,
                JG.GaussianConfig(random_init_point=0), js, **kw)
    assert int(a.num_dropped) == 0
    with torch.no_grad():
        b = trender(TG.params_from_numpy(params, "cpu"),
                    torch.as_tensor(alive),
                    torch.as_tensor(cam.world_view_transform),
                    torch.as_tensor(cam.camera_center), cam.timestamp, 1,
                    torch.as_tensor(prior), torch.tensor(bg), 3, 1.0,
                    TG.GaussianConfig(random_init_point=0), ts, **kw)
    assert b.num_pairs == int(a.num_pairs) > 0
    np.testing.assert_array_equal(b.visibility.numpy(),
                                  np.asarray(a.visibility))
    np.testing.assert_allclose(b.radii.numpy(), np.asarray(a.radii))
    for name, tol in [("alpha", 5e-4), ("intensity_sh", 5e-4),
                      ("raydrop", 5e-4), ("feature", 2e-3),
                      ("depth_mean", 2e-2)]:
        np.testing.assert_allclose(getattr(b, name).numpy(),
                                   np.asarray(getattr(a, name)), atol=tol,
                                   err_msg=name)
    covered = np.asarray(a.alpha)[0] > 0.5
    assert covered.mean() > 0.2
    np.testing.assert_allclose(b.normal.numpy()[:, covered],
                               np.asarray(a.normal)[:, covered], atol=2e-3)
    assert _frac_bad(b.depth_median, a.depth_median, 2e-2) < 2e-3


def test_model_activations_and_prior_match_jax():
    import jax.numpy as jnp
    from gslidar_tpu.models import gaussians as JG
    from gslidar_tpu.models import raydrop_prior as JR
    from gslidar_tpu_torch.models import gaussians as TG
    from gslidar_tpu_torch.models import raydrop_prior as TR
    params, _ = _model(P=500, dynamic=True)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = TG.params_from_numpy(params, "cpu")
    kw = dict(random_init_point=0, cycle=0.3, velocity_decay=0.7)
    jc, tc = JG.GaussianConfig(**kw), TG.GaussianConfig(**kw)
    pairs = [(JG.get_scaling(jp), TG.get_scaling(tp)),
             (JG.get_scaling_t(jp), TG.get_scaling_t(tp)),
             (JG.get_opacity(jp), TG.get_opacity(tp)),
             (JG.get_features(jp), TG.get_features(tp)),
             (JG.get_xyz_shm(jp, jnp.float32(0.2), jc),
              TG.get_xyz_shm(tp, 0.2, tc)),
             (JG.get_inst_velocity(jp, jc), TG.get_inst_velocity(tp, tc)),
             (JG.get_marginal_t(jp, jnp.float32(0.2)),
              TG.get_marginal_t(tp, 0.2))]
    for a, b in pairs:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_array_equal(TR.init_raydrop_prior(4, 6).numpy(),
                                  np.asarray(JR.init_raydrop_prior(4, 6)))
    logits = np.random.default_rng(1).normal(size=(1, 4, 12))
    logits = logits.astype(np.float32)
    for towards in ("forward", "backward"):
        np.testing.assert_allclose(
            TR.raydrop_prior_forward(torch.as_tensor(logits), towards),
            np.asarray(JR.raydrop_prior_forward(jnp.asarray(logits),
                                                towards)), rtol=1e-6)


@pytest.mark.parametrize("native", [True, False])
def test_pano_matches_jax(native, monkeypatch):
    import jax.numpy as jnp
    from gslidar_tpu import native as nat
    from gslidar_tpu.ops import pano as JP
    from gslidar_tpu_torch import native as tnat
    from gslidar_tpu_torch.ops import pano as TP
    if not native:
        monkeypatch.setattr(nat, "get_native", lambda: None)
        monkeypatch.setattr(tnat, "get_native", lambda: None)
    rng = np.random.default_rng(8)
    pts = rng.normal(size=(5000, 3)) * 20
    inten = rng.uniform(0, 1, 5000).astype(np.float32)
    for a, b in zip(JP.project_points_to_pano(pts, inten, H, 64, VFOV, HFOV),
                    TP.project_points_to_pano(pts, inten, H, 64, VFOV, HFOV)):
        np.testing.assert_array_equal(b, a)
    assert TP.fov_bounds(VFOV, HFOV) == JP.fov_bounds(VFOV, HFOV)
    rng_img = rng.uniform(0, 30, (1, H, 64)).astype(np.float32)
    rng_img[0, :4] = 0.0
    a_pts, a_mask = JP.pano_to_lidar(jnp.asarray(rng_img), VFOV, HFOV)
    b_pts, b_mask = TP.pano_to_lidar(torch.as_tensor(rng_img), VFOV, HFOV)
    np.testing.assert_allclose(b_pts.numpy(), np.asarray(a_pts), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(b_mask.numpy(), np.asarray(a_mask))


@functools.lru_cache(maxsize=None)
def _range_maps(w, jax_side, full360, init_only=False):
    """render_range_map of one package (front/back pair of _cameras);
    cached, so the tests below share each render."""
    params, alive = _model(P=4000 if init_only else 3000,
                           init_only=init_only)
    rng = np.random.default_rng(5)
    prior = rng.normal(size=(1, H, 2 * w)).astype(np.float32)
    front, back = _cameras(w)
    js, ts = _settings(w)
    args = _args()
    if jax_side:
        import jax.numpy as jnp
        from gslidar_tpu.engine import evaluate as E
        from gslidar_tpu.models import gaussians as G
        cfg = G.GaussianConfig(random_init_point=0)
        bg = jnp.asarray([0.0, 0.0, 0.0, 1.0])
        return E.render_range_map(
            args, front, back, E.make_eval_render(args, cfg, js, bg),
            {k: jnp.asarray(v) for k, v in params.items()},
            jnp.asarray(alive), jnp.asarray(prior), 3, [H, w],
            eval_render360=(E.make_eval_render360(args, cfg, js, bg)
                            if full360 else None))
    from gslidar_tpu_torch.engine import evaluate as E
    from gslidar_tpu_torch.models import gaussians as G
    cfg = G.GaussianConfig(random_init_point=0)
    bg = torch.tensor([0.0, 0.0, 0.0, 1.0])
    return E.render_range_map(
        args, front, back, E.make_eval_render(args, cfg, ts, bg),
        G.params_from_numpy(params, "cpu"), torch.as_tensor(alive),
        torch.as_tensor(prior), 3, [H, w],
        eval_render360=(E.make_eval_render360(args, cfg, ts, bg)
                        if full360 else None))


def _assert_range_maps_close(a, b, width):
    assert b[0].shape == (3, H, 2 * width)
    np.testing.assert_allclose(b[1], a[1], atol=5e-4)       # intensity
    np.testing.assert_allclose(b[2], a[2], atol=5e-4)       # raydrop
    np.testing.assert_allclose(b[0][1], a[0][1], atol=2e-2)  # mean depth
    for ch in (0, 2):                                        # mix, median
        assert _frac_bad(b[0][ch], a[0][ch], 2e-2) < 2e-3
    np.testing.assert_array_equal(b[3], a[3])
    np.testing.assert_array_equal(b[4], a[4])


@pytest.mark.parametrize("width", [64, 65])
def test_render_range_map_360_matches_jax(width):
    """The single-pass wrap_x 360 range map (odd width pins the half-pixel
    hfov anchoring and the w - w//2 prior split) against the JAX one."""
    _assert_range_maps_close(_range_maps(width, True, True),
                             _range_maps(width, False, True), width)


@pytest.mark.parametrize("width", [64, 65])
def test_render_range_map_stitch_matches_jax(width):
    """The front+back two-half stitch (the per-half depth-mix quantile,
    the back half wrapped around both ends) against the JAX one."""
    _assert_range_maps_close(_range_maps(width, True, False),
                             _range_maps(width, False, False), width)


def test_360_stitch_gap_is_the_references():
    """With _model's drawn opacities (sigmoid of N(0, 1) logits) the 360
    pass and the stitch differ at tile-column edges (the alpha >= 1/255 support overhangs the 12-sample
    tile rects, and the two layouts put their edges in other columns).
    The JAX package has the same gap, pixel for pixel: it belongs to the
    reference algorithm, not to the port."""
    w = 65
    gaps = []
    for jax_side in (True, False):
        stitch = _range_maps(w, jax_side, False)
        wrap = _range_maps(w, jax_side, True)
        gaps.append(np.concatenate(
            [np.abs(stitch[i] - wrap[i]) > tol
             for i, tol in ((0, 5e-2), (1, 1e-3), (2, 1e-3))]))
    assert gaps[0].mean() > 1e-3                  # there is a gap to match
    assert (gaps[0] != gaps[1]).mean() < 5e-4


def test_port_360_matches_port_stitch():
    """tests/test_eval.py::test_full360_matches_stitch on the port, with
    its model (create_from_pcd's init) and bars: one wrap_x pass equals
    the front+back two-half stitch. (The halves' tile edges sit in other
    columns than the 360 grid's, and the alpha >= 1/255 support overhangs
    the tile rects, so splats with larger opacities differ at tile edges;
    chip_smoke.py phase 4 measures that at full size.)"""
    w = 65
    stitch = _range_maps(w, jax_side=False, full360=False, init_only=True)
    wrap = _range_maps(w, jax_side=False, full360=True, init_only=True)
    for name, a, b, tol in [("depth", stitch[0], wrap[0], 5e-2),
                            ("intensity", stitch[1], wrap[1], 1e-3),
                            ("raydrop", stitch[2], wrap[2], 1e-3)]:
        assert _frac_bad(a, b, tol) < 2e-3, name
    np.testing.assert_array_equal(stitch[3], wrap[3])
