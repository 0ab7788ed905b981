"""The port's live viewer (gslidar_tpu_torch.engine.viewer and its render
callback in gslidar_tpu_torch.train) on the CPU:

* ``_orbit_c2w`` and ``_fly_c2w`` equal gslidar_tpu's bit for bit;
* the endpoints (page, orbit and fly ``/render``, ``/pause`` blocking
  ``checkin``, ``/stats``, the preview flag) behave as
  tests/test_viewer.py holds gslidar_tpu's to, on free ports; ``close``
  frees the port;
* ``train.viewer_render`` called from the server's thread renders with
  grad mode off (grad mode is per thread, and on in a new one); its depth
  matches gslidar_tpu's ``make_eval_render`` of the same camera, built as
  root train.py:254-268 builds it, at the render parity bars of
  tests/test_torch_render.py (mean depth within 2e-2), and its image is
  that depth's ``visualize_depth``; the preview renders at half size;
* ``training`` with ``viewer`` on serves a full and a preview render and
  a pause from a client thread while it trains, and closes its server at
  the end.
"""

import io
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.read(), r.headers.get("Content-Type")


def _post(port, path):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _assert_port_free(port):
    """No server listens on ``port`` (bound as the viewer binds it; the
    closed connections' TIME_WAIT does not count)."""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("0.0.0.0", port))


def _png_size(png):
    from PIL import Image
    return Image.open(io.BytesIO(png)).size          # (width, height)


def test_poses_match_jax_bitwise():
    from gslidar_tpu.engine import viewer as J
    from gslidar_tpu_torch.engine import viewer as T
    rng = np.random.default_rng(4)
    for az, el, dist in zip(rng.uniform(-180, 180, 16),
                            rng.uniform(-60, 60, 16), rng.uniform(2, 80, 16)):
        np.testing.assert_array_equal(T._orbit_c2w(az, el, dist),
                                      J._orbit_c2w(az, el, dist))
    for pos, yaw, pitch in zip(rng.normal(0, 10, (16, 3)),
                               rng.uniform(-180, 180, 16),
                               rng.uniform(-89, 89, 16)):
        np.testing.assert_array_equal(T._fly_c2w(pos, yaw, pitch),
                                      J._fly_c2w(pos, yaw, pitch))
    assert T._PAGE == J._PAGE


@pytest.fixture
def mgr():
    from gslidar_tpu_torch.engine.viewer import VisManager
    calls = []

    def render_fn(c2w, frame):
        calls.append((np.asarray(c2w), frame))
        return np.full((3, 8, 16), 0.5, np.float32)

    m = VisManager({"port": _free_port(), "enabled": True, "max_frame": 4,
                    "pixels_per_step": 128}, render_fn)
    assert m.server is not None, "viewer server failed to start"
    m.calls = calls
    yield m
    m.close()


def test_viewer_endpoints(mgr):
    from gslidar_tpu_torch.engine.viewer import _fly_c2w, _orbit_c2w
    body, ctype = _get(mgr.port, "/")
    assert b"gslidar_tpu viewer" in body and "html" in ctype
    assert b"max=3 value=0" in body                      # max_frame - 1

    png, ctype = _get(mgr.port, "/render?mode=orbit&az=30&el=10&dist=20"
                                "&frame=2")
    assert png[:4] == b"\x89PNG" and ctype == "image/png"
    assert _png_size(png) == (16, 8)
    c2w, frame = mgr.calls[-1]
    assert frame == 2
    np.testing.assert_array_equal(c2w, _orbit_c2w(30.0, 10.0, 20.0))

    png, _ = _get(mgr.port, "/render?mode=fly&px=1&py=-2&pz=3"
                            "&yaw=45&pitch=-10&frame=0")
    assert png[:4] == b"\x89PNG"
    c2w, _f = mgr.calls[-1]
    np.testing.assert_array_equal(c2w, _fly_c2w(np.array([1.0, -2.0, 3.0]),
                                                45.0, -10.0))
    np.testing.assert_allclose(c2w[:3, 3], [1, -2, 3], atol=1e-6)

    # pause blocks checkin until resumed (nerfview's paused state)
    assert _post(mgr.port, "/pause")["paused"] is True
    entered = threading.Event()

    def worker():
        mgr.checkin()
        entered.set()
        mgr.checkout()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    time.sleep(0.2)
    assert not entered.is_set(), "checkin must block while paused"
    assert _post(mgr.port, "/pause")["paused"] is False
    assert entered.wait(5.0)
    t.join(5.0)
    assert not t.is_alive()

    stats = json.loads(_get(mgr.port, "/stats")[0])
    assert stats["rays_per_sec"] > 0 and stats["paused"] is False
    with pytest.raises(urllib.error.HTTPError):
        _get(mgr.port, "/nope")


def test_close_frees_the_port():
    from gslidar_tpu_torch.engine.viewer import VisManager
    port = _free_port()
    m = VisManager({"port": port, "enabled": True},
                   lambda c2w, frame: np.zeros((3, 2, 2)))
    assert m.server is not None
    m.close()
    assert m.server is None
    m.close()                                        # a second close is fine
    _assert_port_free(port)
    off = VisManager({"port": port, "enabled": False},
                     lambda c2w, frame: None)
    assert off.server is None
    off.close()


def test_moving_resolution_preview():
    """/render?preview=1 reaches a 3-parameter callback as preview=True;
    2-parameter callbacks keep working at full resolution."""
    from gslidar_tpu_torch.engine.viewer import _PAGE, VisManager
    calls = []

    def render_fn(c2w, frame, preview):
        calls.append(preview)
        h = 4 if preview else 8
        return np.full((3, h, 2 * h), 0.5, np.float32)

    m = VisManager({"port": _free_port(), "enabled": True, "max_frame": 2,
                    "pixels_per_step": 128}, render_fn)
    assert m.server is not None
    try:
        png, _ = _get(m.port, "/render?mode=orbit&az=0&el=0&dist=10"
                              "&frame=0&preview=1")
        assert png[:4] == b"\x89PNG" and calls[-1] is True
        assert _png_size(png) == (8, 4)
        _get(m.port, "/render?mode=orbit&az=0&el=0&dist=10&frame=0")
        assert calls[-1] is False
    finally:
        m.close()
    assert "preview=1" in _PAGE


H, W = 32, 64
VFOV, HFOV = (-24.9, 2.0), (-90.0, 90.0)


def _viewer_model(P=3000, seed=5):
    """A dynamic model around the origin, where the orbit camera looks:
    create_from_pcd (JAX) with drawn opacities, SH, velocities and times;
    numpy params and alive mask."""
    from gslidar_tpu.models import gaussians as JG
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-8, 8, (P, 3)).astype(np.float32)
    colors = rng.uniform(0, 1, (P, 3)).astype(np.float32)
    times = rng.uniform(-0.5, 0.5, (P, 1)).astype(np.float32)
    params, aux = JG.create_from_pcd(pts, colors, times,
                                     JG.GaussianConfig(random_init_point=0),
                                     capacity=4096)
    params = {k: np.array(v) for k, v in params.items()}
    params["opacity"][:] = rng.normal(0.0, 1.0, params["opacity"].shape)
    params["f_rest"][:] = rng.normal(0, 0.1, params["f_rest"].shape)
    params["velocity"][:] = rng.normal(0, 0.5, params["velocity"].shape)
    return params, np.array(aux.alive)


def _viewer_args():
    from gslidar_tpu.config import Config
    return Config({"scale_factor": 0.1, "dynamic": True, "sky_depth": False,
                   "median_depth": False, "frames": 17, "sh_degree": 3,
                   "vfov": VFOV, "hfov": HFOV})


def test_viewer_render_matches_jax_from_a_server_thread():
    import jax.numpy as jnp
    from gslidar_tpu.engine.evaluate import make_eval_render as jax_eval
    from gslidar_tpu.engine.train import CameraBatch
    from gslidar_tpu.engine.viewer import _orbit_c2w
    from gslidar_tpu.models import gaussians as JG
    from gslidar_tpu.raster.settings import RasterSettings as JS
    from gslidar_tpu.utils.general import visualize_depth as jax_vd
    from gslidar_tpu_torch.engine.evaluate import make_eval_render
    from gslidar_tpu_torch.engine.viewer import VisManager
    from gslidar_tpu_torch.models import gaussians as TG
    from gslidar_tpu_torch.raster.settings import RasterSettings as TS
    from gslidar_tpu_torch.train import viewer_render
    from gslidar_tpu_torch.utils.general import visualize_depth

    args = _viewer_args()
    params, alive = _viewer_model()
    prior = np.random.default_rng(1).normal(size=(1, H, 2 * W)).astype(
        np.float32)
    bg = [0.0, 0.0, 0.0, 1.0]
    fov = dict(vfov=VFOV, hfov=HFOV, num_extra_features=4)
    tparams = TG.params_from_numpy(params, "cpu")
    talive, tprior = torch.as_tensor(alive), torch.as_tensor(prior)
    full = make_eval_render(args, TG.GaussianConfig(random_init_point=0),
                            TS(height=H, width=W, **fov), torch.tensor(bg))
    half = make_eval_render(args, TG.GaussianConfig(random_init_point=0),
                            TS(height=H // 2, width=W // 2, **fov),
                            torch.tensor(bg))
    seen = {}

    def recorded(fn):
        def render_fn(*a):
            seen["grad"] = torch.is_grad_enabled()
            seen["thread"] = threading.current_thread()
            pkg = fn(*a)
            seen["depth"] = pkg.depth.numpy()
            return pkg
        return render_fn

    def on_viewer(c2w, frame, preview=False):
        seen["image"] = viewer_render(
            args, "cpu", recorded(half if preview else full), tparams,
            talive, None if preview else tprior, c2w, frame)
        return seen["image"]

    m = VisManager({"port": _free_port(), "enabled": True,
                    "max_frame": args.frames}, on_viewer)
    try:
        png, _ = _get(m.port, "/render?mode=orbit&az=20&el=10&dist=25"
                              "&frame=5")
        assert _png_size(png) == (W, H)
        assert seen["grad"] is False
        assert seen["thread"] is not threading.current_thread()
        depth, image = seen["depth"], seen["image"]
        _get(m.port, "/render?mode=orbit&az=20&el=10&dist=25&frame=5"
                     "&preview=1")
        assert seen["grad"] is False
        assert seen["image"].shape == (3, H // 2, W // 2)
    finally:
        m.close()

    # gslidar_tpu's viewer render of the same camera (train.py:254-268)
    c2w = _orbit_c2w(20.0, 10.0, 25.0)
    w2c = np.linalg.inv(c2w).astype(np.float32)
    cam = CameraBatch(
        viewmat=jnp.asarray(w2c), campos=jnp.asarray(c2w[:3, 3], jnp.float32),
        timestamp=jnp.asarray(-0.5 + 5 / 16, jnp.float32),
        towards_idx=jnp.asarray(0, jnp.int32),
        pts_depth=jnp.zeros((1, 1, 1)), pts_intensity=jnp.zeros((1, 1, 1)))
    ev = jax_eval(args, JG.GaussianConfig(random_init_point=0),
                  JS(height=H, width=W, pair_cap=1 << 16, tile_chunk=32,
                     tile_list_cap=1 << 12, backend="xla", **fov),
                  jnp.asarray(bg))
    pkg = ev({k: jnp.asarray(v) for k, v in params.items()},
             jnp.asarray(alive), jnp.asarray(prior), cam,
             jnp.asarray(args.sh_degree, jnp.int32))
    want = np.asarray(pkg.depth)
    assert (want > 0).mean() > 0.2
    np.testing.assert_allclose(depth, want, atol=2e-2)
    np.testing.assert_array_equal(
        image, visualize_depth(depth, scale_factor=args.scale_factor))
    diff = np.abs(image - jax_vd(want, scale_factor=args.scale_factor))
    assert (diff.max(0) > 1e-6).mean() < 2e-3   # pixels at a turbo bin edge


def test_training_serves_the_viewer(tmp_path):
    """``training`` with ``viewer`` on: from a client thread started in
    the step hook of iteration 2, a pause (the loop then waits in its next
    ``checkin``), a full and a preview render of the model at that
    iteration (h x w and half of it), the resume and the stats; the loop
    takes no step while paused, and its server is closed at the end."""
    import os
    from gslidar_tpu_torch.train import load_args, training
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    args = load_args(os.path.join(repo, "configs", "synthetic_smoke.yaml"),
                     os.path.join(repo, "configs", "base.yaml"),
                     ["hw=[16,64]", "num_pts=1500", "frames=4",
                      "iterations=4", "vis_step=100", "viewer=true",
                      f"viewer_port={port}", f"model_path={tmp_path}"])
    steps, got, paused = [], {}, threading.Event()

    def client():
        try:
            got["pause"] = _post(port, "/pause")["paused"]
            paused.set()
            n = len(steps)
            for q in ("", "&preview=1"):
                png, _ = _get(port, "/render?mode=orbit&az=0&el=15&dist=25"
                                    "&frame=1" + q)
                got["size" + q] = _png_size(png)
            got["steps while paused"] = len(steps) - n
            got["resume"] = _post(port, "/pause")["paused"]
            got["stats"] = json.loads(_get(port, "/stats")[0])
        finally:
            paused.set()

    def on_step(iteration, *_):
        steps.append(iteration)
        if iteration == 2:
            got["thread"] = threading.Thread(target=client, daemon=True)
            got["thread"].start()
            assert paused.wait(60)

    np.random.seed(0)
    training(args, "cpu", on_step=on_step)
    got["thread"].join(60)
    assert not got["thread"].is_alive()
    assert steps == [1, 2, 3, 4]
    assert got["pause"] is True and got["resume"] is False
    assert got["size"] == (64, 16) and got["size&preview=1"] == (32, 8)
    assert got["steps while paused"] == 0
    assert got["stats"]["rays_per_sec"] > 0
    _assert_port_free(port)                          # the server is closed
