"""Port parity for the eval slice: gslidar_tpu_torch's meters, F-score,
LPIPS and ``complete_eval`` against gslidar_tpu's, on seeded numpy inputs.

* the meters on the same arrays: RMSE, MedAE, SSIM, PSNR, Acc and F1
  within 1e-9 relative (both are float64 numpy); ``PointsMeter``'s C-D
  within 1e-5 relative (the ray directions come from each package's own
  float32 sin/cos); its F-score within what one point per cloud changing
  side of the threshold can move it;
* ``fscore`` on the same distances: equal;
* LPIPS with test-written random AlexNet weights, in the npz key layout
  and in the ``lpips`` state_dict layout: within 1e-5 relative; a weights
  file that is there but does not load raises, where the JAX package
  reports NaN; without one the meters report NaN and metrics.json null;
* ``complete_eval`` end to end on a small Synthetic scene (32-row
  halves, so the LPIPS branch runs, with random weights) from one model
  loaded into both packages: the ``ray_drop_datasets`` arrays at
  tests/test_torch_render.py's render bars, and metrics.json key for key
  within bounds that follow from the arrays' differences (see
  ``_metric_bounds``).
"""

import json
import os
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VFOV = (-24.9, 2.0)


def _panos(seed, shape=(1, 40, 96)):
    """A depth / intensity / raydrop set of panoramas with dropped GT
    pixels, predictions near the GT and some far (> 80 m) returns."""
    rng = np.random.default_rng(seed)
    gt_d = rng.uniform(1.0, 60.0, shape).astype(np.float32)
    gt_d[rng.uniform(size=shape) < 0.2] = 0
    gt_d[rng.uniform(size=shape) < 0.02] = 90.0
    pred_d = np.clip(gt_d + rng.normal(0, 0.3, shape), 0, None) \
        .astype(np.float32)
    gt_i = rng.uniform(0, 1, shape).astype(np.float32)
    pred_i = np.clip(gt_i + rng.normal(0, 0.05, shape), 0, 1) \
        .astype(np.float32)
    gt_r = np.where(gt_d > 0, 0.0, 1.0)
    pred_r = np.clip(gt_r + rng.normal(0, 0.4, shape), 0, 1) \
        .astype(np.float32)
    return pred_d, gt_d, pred_i, gt_i, pred_r, gt_r


@pytest.mark.parametrize("seed", [0, 1])
def test_meters_match_jax(seed, monkeypatch):
    from gslidar_tpu.utils import metrics as JM
    from gslidar_tpu_torch.utils import metrics as TM
    monkeypatch.delenv("GSLIDAR_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setattr(JM._LpipsProxy, "_tried", False)
    monkeypatch.setattr(JM._LpipsProxy, "_fn", None)
    scale = 0.1
    pairs = [_panos(seed + 10 * k) for k in range(2)]
    meters = {}
    for pkg, M in (("jax", JM), ("torch", TM)):
        ms = [M.RaydropMeter(), M.IntensityMeter(scale=1),
              M.DepthMeter(scale=scale),
              M.PointsMeter(scale=scale, vfov=VFOV)]
        for pred_d, gt_d, pred_i, gt_i, pred_r, gt_r in pairs:
            ms[0].update(pred_r, gt_r)
            ms[1].update(pred_i, gt_i)
            ms[2].update(pred_d * scale, gt_d * scale)
            ms[3].update(pred_d * scale, gt_d * scale)
        meters[pkg] = [m.measure() for m in ms]
    j, t = meters["jax"], meters["torch"]
    np.testing.assert_allclose(t[0], j[0], rtol=1e-9, atol=0)
    for k in (1, 2):                 # RMSE, MedAE, LPIPS, SSIM, PSNR
        keep = [0, 1, 3, 4]
        np.testing.assert_allclose(t[k][keep], j[k][keep], rtol=1e-9,
                                   atol=0)
        assert np.isnan(t[k][2]) and np.isnan(j[k][2])
        assert TM.lpips_json(t[k][2]) is None
    assert abs(t[3][0] - j[3][0]) <= 1e-5 * j[3][0]         # C-D
    # one point per cloud on the other side of the threshold moves each
    # precision by 1/n; f = 2 p1 p2 / (p1 + p2) moves by at most twice
    n = min(int((p[1] > 0).sum()) for p in pairs)
    assert abs(t[3][1] - j[3][1]) <= 4.0 / n
    assert 0 < j[3][1] < 1 and j[3][0] > 0


def test_fscore_matches_jax():
    import jax.numpy as jnp
    from gslidar_tpu.ops.chamfer import fscore as jf
    from gslidar_tpu_torch.ops.chamfer import fscore as tf
    rng = np.random.default_rng(3)
    d1 = rng.uniform(0, 0.1, 500).astype(np.float32)
    d2 = rng.uniform(0, 0.2, 700).astype(np.float32)
    m1, m2 = rng.uniform(size=500) < 0.8, rng.uniform(size=700) < 0.6
    for args in ((d1, d2), (d1, d2, m1, m2), (d1 + 1, d2 + 1, m1, m2)):
        want = jf(*(jnp.asarray(a) for a in args))
        got = tf(*(torch.as_tensor(a) for a in args))
        for a, b in zip(got, want):
            assert float(a) == float(b)
    assert float(tf(torch.as_tensor(d1 + 1), torch.as_tensor(d2 + 1))[0]) \
        == 0.0


def _write_lpips(path, seed, layout):
    """Random AlexNet-LPIPS weights (tests/test_eval.py's recipe), in the
    npz key layout or in the lpips state_dict layout."""
    rng = np.random.default_rng(seed)
    chans = [(3, 64, 11), (64, 192, 5), (192, 384, 3), (384, 256, 3),
             (256, 256, 3)]
    w = {}
    for i, (cin, cout, k) in enumerate(chans):
        conv_w = (rng.normal(size=(cout, cin, k, k)) * 0.05).astype(
            np.float32)
        conv_b = rng.normal(0, 0.02, cout).astype(np.float32)
        lin_w = rng.uniform(0, 1, (1, cout, 1, 1)).astype(np.float32)
        if layout == "npz":
            w[f"conv{i}_w"], w[f"conv{i}_b"], w[f"lin{i}_w"] = \
                conv_w, conv_b, lin_w
        else:
            ci = [0, 3, 6, 8, 10][i]
            w[f"net.slice{i + 1}.{ci}.weight"] = conv_w
            w[f"net.slice{i + 1}.{ci}.bias"] = conv_b
            w[f"lins.{i}.model.1.weight"] = lin_w
    np.savez(path, **w)
    return str(path)


@pytest.mark.parametrize("layout", ["npz", "state_dict"])
def test_lpips_matches_jax(layout, tmp_path):
    from gslidar_tpu.utils.lpips_jax import load_lpips as jl
    from gslidar_tpu_torch.utils.lpips import load_lpips as tl
    path = _write_lpips(tmp_path / "w.npz", 4, layout)
    fj, ft = jl(path), tl(path, "cpu")
    rng = np.random.default_rng(5)
    for shape in ((1, 66, 128), (1, 33, 96)):
        a = rng.uniform(0, 1, shape)
        b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1)
        want, got = float(fj(a, b)), ft(a, b)
        assert want > 0 and abs(got - want) <= 1e-5 * want
        assert abs(ft(a, a)) < 1e-6


def test_lpips_weights_that_do_not_load_raise(tmp_path, monkeypatch):
    from gslidar_tpu_torch.utils.lpips import lpips_from_env
    from gslidar_tpu_torch.utils.metrics import IntensityMeter
    monkeypatch.delenv("GSLIDAR_LPIPS_WEIGHTS", raising=False)
    assert lpips_from_env("cpu") is None
    monkeypatch.setenv("GSLIDAR_LPIPS_WEIGHTS", str(tmp_path / "none.npz"))
    assert lpips_from_env("cpu") is None
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not an npz")
    monkeypatch.setenv("GSLIDAR_LPIPS_WEIGHTS", str(bad))
    a = np.full((1, 40, 64), 0.5)
    with pytest.raises(Exception):
        IntensityMeter(scale=1).update(a, a)
    partial = tmp_path / "partial.npz"
    np.savez(partial, conv0_w=np.zeros((64, 3, 11, 11), np.float32))
    monkeypatch.setenv("GSLIDAR_LPIPS_WEIGHTS", str(partial))
    with pytest.raises(KeyError):
        IntensityMeter(scale=1).update(a, a)


# ---------------------------------------------------------- complete_eval
HW = (32, 64)


def _scene_args(model_path):
    from gslidar_tpu.config import Config
    return Config.merge(
        Config.load(os.path.join(REPO, "configs", "base.yaml")),
        Config.load(os.path.join(REPO, "configs", "synthetic_smoke.yaml")),
        {"hw": list(HW), "frames": 4, "model_path": str(model_path),
         "test_only": False})


def _jax_eval(tmp_path, params, alive, prior, sh_degree, full360=True):
    import jax.numpy as jnp
    from gslidar_tpu.data.scene import Scene
    from gslidar_tpu.data.synthetic import read_synthetic_info
    from gslidar_tpu.engine import evaluate as E
    from gslidar_tpu.models import gaussians as G
    from gslidar_tpu.raster.settings import RasterSettings
    args = _scene_args(tmp_path / ("jax" if full360 else "jax_stitch"))
    os.makedirs(args.model_path)
    np.random.seed(0)
    scene = Scene(args, read_synthetic_info(args), shuffle=False)
    for sub in ("gt", "render_train", "render_test"):
        os.makedirs(os.path.join(args.model_path, "ray_drop_datasets", sub))
    settings = RasterSettings(
        height=HW[0], width=HW[1], vfov=tuple(args.vfov),
        hfov=tuple(args.hfov), num_extra_features=4, pair_cap=1 << 16,
        tile_chunk=32, tile_list_cap=1 << 12, backend="xla")
    cfg = G.GaussianConfig(sh_degree=args.sh_degree, random_init_point=0)
    bg = jnp.asarray([0.0, 0.0, 0.0, 1.0])
    state = types.SimpleNamespace(
        params={k: jnp.asarray(v) for k, v in params.items()},
        aux=types.SimpleNamespace(alive=jnp.asarray(alive)),
        prior=jnp.asarray(prior))
    res = E.complete_eval(7, args, scene, state, sh_degree,
                          E.make_eval_render(args, cfg, settings, bg),
                          is_final=True, save_raydrop_data=True,
                          eval_render360=E.make_eval_render360(
                              args, cfg, settings, bg) if full360 else None)
    return args, res


def _torch_eval(tmp_path, params, alive, prior, sh_degree, full360=True):
    from gslidar_tpu_torch.engine import evaluate as E
    from gslidar_tpu_torch.models import gaussians as G
    from gslidar_tpu_torch.render import build_scene, raster_settings
    args = _scene_args(tmp_path / ("torch" if full360 else "torch_stitch"))
    os.makedirs(args.model_path)
    np.random.seed(0)
    scene = build_scene(args)
    settings = raster_settings(args, *HW)
    cfg = G.GaussianConfig(sh_degree=args.sh_degree, random_init_point=0)
    bg = torch.tensor([0.0, 0.0, 0.0, 1.0])
    state = types.SimpleNamespace(
        params=G.params_from_numpy(params, "cpu"),
        aux=types.SimpleNamespace(alive=torch.as_tensor(alive)),
        prior=torch.as_tensor(prior))
    res = E.complete_eval(7, args, scene, state, sh_degree,
                          E.make_eval_render(args, cfg, settings, bg),
                          is_final=True, save_raydrop_data=True,
                          eval_render360=E.make_eval_render360(
                              args, cfg, settings, bg) if full360 else None)
    return args, res


def _model(args_points, seed=7):
    """create_from_pcd (JAX) on a subsample of the scene's points, with
    opacities and SH drawn from the seed so every channel has signal."""
    from gslidar_tpu.models import gaussians as JG
    rng = np.random.default_rng(seed)
    pts = args_points[rng.permutation(len(args_points))[:2500]]
    params, aux = JG.create_from_pcd(
        pts.astype(np.float32), rng.uniform(0, 1, (len(pts), 3))
        .astype(np.float32), None, JG.GaussianConfig(random_init_point=0),
        capacity=4096)
    params = {k: np.array(v) for k, v in params.items()}
    params["opacity"][:] = rng.normal(0.5, 1.0, params["opacity"].shape)
    params["f_rest"][:] = rng.normal(0, 0.1, params["f_rest"].shape)
    return params, np.array(aux.alive)


def _metric_bounds(a, b, gt, vmax):
    """Bounds on how far two panoramas' RMSE, MedAE and PSNR against ``gt``
    can lie apart: RMSE is 1-Lipschitz in the RMS of a - b, MedAE moves by
    at most max |a - b|, and PSNR = 10 log10(vmax^2 / MSE) by
    (20 / ln 10) |dRMSE| / RMSE to first order."""
    clip = (lambda x: np.clip(x, 1e-6, vmax))
    a, b, gt = clip(a), clip(b), clip(gt)
    d_rms = float(np.sqrt(np.mean((a - b) ** 2)))
    rmse = float(np.sqrt(np.mean((a - gt) ** 2)))
    return dict(RMSE=d_rms, MedAE=float(np.abs(a - b).max()),
                PSNR=2.5 * 20 / np.log(10) * d_rms / rmse)


def _eval_inputs(tmp_path, monkeypatch):
    """Random LPIPS weights under GSLIDAR_LPIPS_WEIGHTS, and a model and
    a ray-drop prior for both packages."""
    from gslidar_tpu.data.synthetic import read_synthetic_info
    from gslidar_tpu.utils import metrics as JM
    path = _write_lpips(tmp_path / "lpips.npz", 8, "npz")
    monkeypatch.setenv("GSLIDAR_LPIPS_WEIGHTS", path)
    monkeypatch.setattr(JM._LpipsProxy, "_tried", False)
    monkeypatch.setattr(JM._LpipsProxy, "_fn", None)
    args = _scene_args(tmp_path / "pts")
    os.makedirs(args.model_path)
    np.random.seed(0)
    params, alive = _model(read_synthetic_info(args).point_cloud[0])
    prior = np.random.default_rng(9).normal(
        -1.5, 1.0, (1, HW[0], 2 * HW[1])).astype(np.float32)
    return params, alive, prior


def test_complete_eval_matches_jax(tmp_path, monkeypatch):
    params, alive, prior = _eval_inputs(tmp_path, monkeypatch)
    ja, jres = _jax_eval(tmp_path, params, alive, prior, 3)
    ta, tres = _torch_eval(tmp_path, params, alive, prior, 3)
    _check_eval(ja, jres, ta, tres)


def test_complete_eval_stitch_matches_jax(tmp_path, monkeypatch):
    """``eval_render360=None`` (root train.py's ``eval_full360=false``):
    both packages render the two halves and stitch them; the port's
    arrays match JAX's stitched ones and are not its own 360-degree
    pass's, which differs at tile-column edges."""
    params, alive, prior = _eval_inputs(tmp_path, monkeypatch)
    ja, jres = _jax_eval(tmp_path, params, alive, prior, 3, full360=False)
    ta, tres = _torch_eval(tmp_path, params, alive, prior, 3, full360=False)
    _check_eval(ja, jres, ta, tres)
    t360, _ = _torch_eval(tmp_path, params, alive, prior, 3)
    rd = "ray_drop_datasets/render_test"
    names = sorted(os.listdir(os.path.join(ta.model_path, rd)))
    stitched = [np.load(os.path.join(ta.model_path, rd, n)) for n in names]
    one_pass = [np.load(os.path.join(t360.model_path, rd, n))
                for n in names]
    assert not all(np.array_equal(a, b) for a, b in zip(stitched, one_pass))


def test_training_passes_eval_full360(tmp_path, monkeypatch):
    """The training loop hands ``complete_eval`` the one-pass 360-degree
    render only under ``eval_full360`` (root train.py:220-221); with
    false it hands None, and the halves are stitched."""
    import gslidar_tpu_torch.train as T
    seen = []

    def fake_eval(*a, eval_render360=None, **k):
        seen.append(eval_render360)
        return {}
    monkeypatch.setattr(T, "complete_eval", fake_eval)
    for flag in ("true", "false"):
        args = T.load_args(
            os.path.join(REPO, "configs", "synthetic_smoke.yaml"),
            os.path.join(REPO, "configs", "base.yaml"),
            ["hw=[16,64]", "num_pts=500", "frames=4", "iterations=0",
             f"model_path={tmp_path / flag}", f"eval_full360={flag}"])
        T.training(args, torch.device("cpu"))
    assert len(seen) == 2
    assert callable(seen[0]) and seen[1] is None


def _check_eval(ja, jres, ta, tres):
    assert sorted(jres) == sorted(tres) == ["test", "train"]

    # the refinement's inputs, at the render bars
    rd = "ray_drop_datasets"
    names = {}
    for sub in ("gt", "render_train", "render_test"):
        names[sub] = sorted(os.listdir(os.path.join(ja.model_path, rd, sub)))
        assert names[sub] == sorted(os.listdir(os.path.join(
            ta.model_path, rd, sub))) and names[sub]
    arrays = {}
    for sub in ("render_train", "render_test"):
        for n in names[sub]:
            j = np.load(os.path.join(ja.model_path, rd, sub, n))
            t = np.load(os.path.join(ta.model_path, rd, sub, n))
            g = np.load(os.path.join(ta.model_path, rd, "gt", n))
            np.testing.assert_array_equal(
                g, np.load(os.path.join(ja.model_path, rd, "gt", n)))
            assert t.shape == j.shape == (3, HW[0], 2 * HW[1])
            assert t.dtype == j.dtype and g.dtype == np.float64
            np.testing.assert_allclose(t[:2], j[:2], atol=5e-4)
            assert (np.abs(t[2] - j[2]) > 2e-2).mean() < 2e-3
            arrays.setdefault(sub[7:], []).append((j, t, g))

    for split in ("test", "train"):
        with open(os.path.join(ja.model_path, "eval", f"{split}_7_render",
                               "metrics.json")) as f:
            jm = json.load(f)
        with open(os.path.join(ta.model_path, "eval", f"{split}_7_render",
                               "metrics.json")) as f:
            tm = json.load(f)
        assert tm == tres[split] or json.loads(json.dumps(tres[split])) == tm
        assert jm.keys() == tm.keys()
        assert all(jm[k].keys() == tm[k].keys() for k in jm
                   if isinstance(jm[k], dict))
        _check_metrics(jm, tm, arrays[split], ta.scale_factor)


def _check_metrics(jm, tm, pairs, sf):
    """metrics.json of the port (tm) against JAX's (jm) on one split,
    within bounds derived from the saved arrays' differences (pairs of
    (jax, port, gt) [3, h, 2w] arrays): the ray-drop masks must be the
    same, so Acc and F1 are equal; RMSE, MedAE and PSNR within
    ``_metric_bounds`` of the masked channels. SSIM and LPIPS are smooth
    in unit-range channels with slopes of order 1, so the 5e-4 channel
    bar allows them 1e-3 relative; C-D and F-score get 1e-3 relative, the
    mean-depth bar (2e-2) over ~20-unit depths. (Seen here: at most 2e-6
    relative on every metric.)"""
    masks = [(j[0] > 0.5, t[0] > 0.5) for j, t, _ in pairs]
    assert all(np.array_equal(a, b) for a, b in masks)
    rd = tm["Ray drop"]
    assert rd["Acc"] == pytest.approx(jm["Ray drop"]["Acc"], abs=1e-12)
    assert rd["F1"] == pytest.approx(jm["Ray drop"]["F1"], abs=1e-12)
    assert abs(rd["RMSE"] - jm["Ray drop"]["RMSE"]) <= max(
        float(np.abs(j[0] - t[0]).max()) for j, t, _ in pairs) + 1e-12
    for key, ch, scale, vmax in (("Intensity SH", 1, 1.0, 1.0),
                                 ("Depth", 2, sf, 80.0)):
        bounds = [_metric_bounds(t[ch] * (1 - m) / scale,
                                 j[ch] * (1 - m) / scale,
                                 g[1 if ch == 1 else 2] / scale, vmax)
                  for (j, t, g), (m, _) in zip(pairs, masks)]
        for name in ("RMSE", "MedAE", "PSNR"):
            tol = max(b[name] for b in bounds) + 1e-9
            assert abs(tm[key][name] - jm[key][name]) <= tol, (key, name)
        assert tm[key]["SSIM"] == pytest.approx(jm[key]["SSIM"], rel=1e-3)
        assert jm[key]["LPIPS"] is not None and tm[key]["LPIPS"] > 0
        assert tm[key]["LPIPS"] == pytest.approx(jm[key]["LPIPS"], rel=1e-3)
    for key in ("Point Cloud mix", "Point Cloud mean", "Point Cloud median"):
        for name in ("C-D", "F-score"):
            assert tm[key][name] == pytest.approx(jm[key][name], rel=1e-3,
                                                  abs=1e-9), (key, name)
