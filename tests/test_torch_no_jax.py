"""The port runs without JAX and without gslidar_tpu, and the on-card
smoke test refuses to run without a card.

* no module of gslidar_tpu_torch (nor chip_smoke.py) imports jax or
  gslidar_tpu;
* the serving entry point, ``python -m gslidar_tpu_torch.render``, renders
  a gslidar_tpu checkpoint of a tiny Synthetic scene on the CPU in a
  subprocess where ``import jax`` and ``import gslidar_tpu`` fail;
* the training entry point, ``python -m gslidar_tpu_torch.train``, trains
  a tiny Synthetic scene on the CPU the same way (after importing the
  OPV2V loader, its tree writer, the preprocess scripts, the viewer and
  the numpy utilities there), past a densify, writes
  a checkpoint that gslidar_tpu reads, evaluates it, refines its ray drop
  with a U-Net whose refine.npz gslidar_tpu reads and scores it, logging
  to log.txt; ``--test_only`` and ``--skip_refine`` do what the root
  train.py's do;
* the parallel layer (``parallel.{comm,shard,pano_shard}``,
  ``raster.oracle``) imports and runs a data-parallel step and a
  gaussian-sharded render over its loopback the same way;
* the raw KITTI-360 tree writer and converter, the dense oracle's
  gradients and ``scripts.compare_2dgs_3dgs`` run the same way;
* the bench and the measurement scripts (``gslidar_tpu_torch.bench``,
  ``scripts.{bench_train_step,profile_render,profile_train_step,
  tile_stats,measure_tight_rects,profile_preprocess}``) run the same way
  on the CPU, and each refuses to start without a card unless given
  ``--device cpu``;
* ``python3 chip_smoke.py`` with CUDA hidden exits non-zero with a clear
  message and prints no result line.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK_JAX = ("import sys; sys.modules['jax'] = None; "
             "sys.modules['jaxlib'] = None; "
             "sys.modules['gslidar_tpu'] = None; ")
NONE_LOADED = ("assert not [m for m in sys.modules if (m.startswith('jax') "
               "or m.split('.')[0] == 'gslidar_tpu') "
               "and sys.modules[m] is not None]; ")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.update(extra)
    return env


def test_sources_import_no_jax():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    pkg = re.compile(r"^\s*(from|import)\s+gslidar_tpu(\.|\s|$)", re.M)
    assert pkg.search("from gslidar_tpu.config import Config")
    assert pkg.search("  import gslidar_tpu as g")
    assert not pkg.search("from gslidar_tpu_torch.config import Config")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "gslidar_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 10
    for p in paths:
        with open(p) as f:
            src = f.read()
        assert not pat.search(src), p
        assert not pkg.search(src), p


def _trained_model_dir(tmp_path, hw=(16, 64), frames=4):
    """A gslidar_tpu run directory of a tiny Synthetic scene: the files
    ``train.py`` leaves (points3d.ply, transform_poses_pca.npz,
    scale_factor.txt) and a checkpoint of create_from_pcd's model."""
    from gslidar_tpu.config import Config
    from gslidar_tpu.data.synthetic import read_synthetic_info
    from gslidar_tpu.engine.checkpoint import save_checkpoint
    from gslidar_tpu.engine.train import init_train_state
    from gslidar_tpu.models import gaussians as G
    from gslidar_tpu.models.raydrop_prior import init_raydrop_prior
    model = tmp_path / "run"
    (model / "ckpt").mkdir(parents=True)
    args = Config.merge(
        Config.load(os.path.join(REPO, "configs", "base.yaml")),
        Config.load(os.path.join(REPO, "configs", "synthetic_smoke.yaml")),
        {"hw": list(hw), "frames": frames, "model_path": str(model)})
    np.random.seed(0)
    info = read_synthetic_info(args)
    (model / "scale_factor.txt").write_text(str(args.scale_factor))
    pts = info.point_cloud[0][::20][:3000].astype(np.float32)
    params, aux = G.create_from_pcd(
        pts, np.full((len(pts), 3), 0.5, np.float32), None,
        G.GaussianConfig(random_init_point=0), capacity=4096)
    state = init_train_state(params, aux, init_raydrop_prior(*hw))
    ckpt = model / "ckpt" / "chkpnt300.npz"
    save_checkpoint(str(ckpt), state, 300)
    return model, ckpt


def test_render_cli_runs_without_jax(tmp_path):
    hw = (16, 64)
    _, ckpt = _trained_model_dir(tmp_path, hw)
    out = tmp_path / "out"
    argv = ["-m", "gslidar_tpu_torch.render",
            "--config", os.path.join(REPO, "configs", "synthetic_smoke.yaml"),
            "--base_config", os.path.join(REPO, "configs", "base.yaml"),
            "--checkpoint", str(ckpt), "--out", str(out), "--device", "cpu",
            "hw=[16,64]", "frames=4"]
    code = (BLOCK_JAX + "import runpy, torch; torch.set_num_threads(2); "
            f"sys.argv = {argv!r}; "
            "runpy.run_module('gslidar_tpu_torch.render', "
            "run_name='__main__', alter_sys=True); "
            + NONE_LOADED + "print('NO_JAX_OK')")
    r = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO_JAX_OK" in r.stdout
    rendered = sorted(os.listdir(out / "render_test"))
    assert rendered and rendered == sorted(os.listdir(out / "gt"))
    for name in rendered:
        img = np.load(out / "render_test" / name)
        gt = np.load(out / "gt" / name)
        pts = np.load(out / "points_test" / name)
        assert img.shape == gt.shape == (3, hw[0], 2 * hw[1])
        assert np.isfinite(img).all() and pts.ndim == 2 and pts.shape[1] == 3
        assert 0 <= img[0].min() and img[0].max() <= 1      # raydrop
        assert (img[2] > 0).any()                             # depth


TRAIN_ARGS = ["--config",
              os.path.join(REPO, "configs", "synthetic_smoke.yaml"),
              "--base_config", os.path.join(REPO, "configs", "base.yaml"),
              "--device", "cpu", "iterations=12", "densify_from_iter=4",
              "densification_interval=4", "densify_until_iter=10",
              "hw=[16,64]", "frames=4", "num_pts=1500", "refine_epochs=2"]


# the modules no entry point above imports on the Synthetic scene
EXTRA_MODULES = ("gslidar_tpu_torch.data.opv2v",
                 "gslidar_tpu_torch.data.opv2v_tree",
                 "gslidar_tpu_torch.data.preprocess.opv2v_to_gs",
                 "gslidar_tpu_torch.data.preprocess.kitti360_to_gs",
                 "gslidar_tpu_torch.engine.viewer",
                 "gslidar_tpu_torch.utils.misc",
                 "gslidar_tpu_torch.utils.system")


def _run_train_cli(run, *flags):
    """``python -m gslidar_tpu_torch.train`` on the CPU with ``import jax``
    blocked, after importing EXTRA_MODULES there; returns (the subprocess,
    the run's log.txt)."""
    argv = ["-m", "gslidar_tpu_torch.train", *TRAIN_ARGS,
            f"model_path={run}", *flags]
    code = (BLOCK_JAX + "import importlib, runpy, torch; "
            f"[importlib.import_module(m) for m in {EXTRA_MODULES!r}]; "
            "torch.set_num_threads(2); "
            f"sys.argv = {argv!r}; "
            "runpy.run_module('gslidar_tpu_torch.train', "
            "run_name='__main__', alter_sys=True); "
            + NONE_LOADED + "print('NO_JAX_OK')")
    r = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO_JAX_OK" in r.stdout        # stdout is back after the run
    with open(run / "log.txt") as f:
        return r, f.read()


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """The training CLI's run of TRAIN_ARGS: 12 steps, the final eval,
    2 refine epochs and refine_test."""
    run = tmp_path_factory.mktemp("cli") / "run"
    return run, _run_train_cli(run)[1]


def _metrics(run, name):
    with open(run / "eval" / name / "metrics.json") as f:
        return json.load(f)


def test_train_cli_runs_without_jax(trained_run, monkeypatch):
    """12 steps past densify_from_iter, with a densify at 8 and the
    checkpoint at 12, which gslidar_tpu's load_checkpoint then reads; the
    final eval at 12 (both splits, ray_drop_datasets), 2 refine epochs
    whose refine.npz gslidar_tpu's _load_unet reads, and refine_test. The
    log goes to log.txt."""
    import jax
    from gslidar_tpu.config import Config
    from gslidar_tpu.engine.checkpoint import load_checkpoint
    from gslidar_tpu.engine.refine import _load_unet
    from gslidar_tpu.engine.train import init_train_state
    from gslidar_tpu.models import gaussians as G
    from gslidar_tpu.models import unet as JU
    from gslidar_tpu.models.raydrop_prior import init_raydrop_prior
    run, log = trained_run
    assert "[8] densify: 1500 -> " in log, log
    m = re.search(r"trained 12 steps to (\d+) gaussians", log)
    assert m, log
    assert (run / "scale_factor.txt").exists()
    assert (run / "setting.txt").exists()
    assert os.listdir(run / "visualization")
    # gslidar_tpu reads the checkpoint; the template only gives the tree
    p, a = G.create_from_pcd(np.zeros((4, 3), np.float32),
                             np.zeros((4, 3), np.float32), None,
                             G.GaussianConfig(random_init_point=0))
    state, it = load_checkpoint(str(run / "ckpt" / "chkpnt12.npz"),
                                init_train_state(p, a,
                                                 init_raydrop_prior(16, 64)))
    n = int(m.group(1))
    assert it == 12 and state.params["xyz"].shape == (n, 3)
    assert bool(state.aux.alive.all()) and int(state.opt.count) == 11
    assert all(bool(jax.numpy.isfinite(x).all())
               for x in jax.tree.leaves(state.params))

    # the final eval, its ray-drop datasets, refine and refine_test
    for split in ("test", "train"):
        got = _metrics(run, f"{split}_12_render")
        assert got["split"] == split and got["iteration"] == 12
        assert 0 <= got["Ray drop"]["Acc"] <= 1
        assert got["Depth"]["LPIPS"] == 1.0       # 16 rows: no LPIPS
        assert os.listdir(run / "ray_drop_datasets" / f"render_{split}")
        got = _metrics(run, f"{split}_refine_render")
        assert got["iteration"] == "refine" and set(got) == {
            "split", "iteration", "Ray drop", "Point Cloud", "Depth",
            "Intensity"}
    assert "Start UNet Optimization" in log and "Refine complete." in log
    init = JU.UNet.init
    monkeypatch.setattr(JU.UNet, "init", lambda self, r, x, train=True:
                        jax.jit(lambda r, x: init(self, r, x,
                                                  train=train))(r, x))
    model, params, stats = _load_unet(Config({"model_path": str(run)}))
    x = np.load(run / "ray_drop_datasets" / "render_test" / sorted(
        os.listdir(run / "ray_drop_datasets" / "render_test"))[0])[None]
    out = np.asarray(model.apply({"params": params, "batch_stats": stats},
                                 x.astype(np.float32), train=False))
    assert out.shape == (1, 1, 16, 128) and np.isfinite(out).all()


def test_train_cli_test_only_and_skip_refine_without_jax(trained_run):
    """``--test_only`` evaluates the newest checkpoint (chkpnt12) and runs
    refine_test on the refine.npz there without refining again;
    ``--test_only --skip_refine`` evaluates only."""
    run, _ = trained_run
    npz = run / "ckpt" / "refine.npz"
    stamp = os.stat(npz).st_mtime_ns
    before = _metrics(run, "test_12_render")
    _, log = _run_train_cli(run, "--test_only")
    assert "trained" not in log and "Start UNet Optimization" not in log
    assert "[ITER 12] eval test" in log and "[refine] test" in log
    assert os.stat(npz).st_mtime_ns == stamp
    assert _metrics(run, "test_12_render") == before
    os.remove(run / "eval" / "test_refine_render" / "metrics.json")
    _, log = _run_train_cli(run, "--test_only", "--skip_refine")
    assert "[ITER 12] eval test" in log and "[refine]" not in log
    assert not (run / "eval" / "test_refine_render" / "metrics.json").exists()


def test_parallel_layer_runs_without_jax():
    """The parallel modules import, and a data-parallel step and a
    gaussian-sharded render run over the loopback, where ``import jax``
    and ``import gslidar_tpu`` fail."""
    code = (BLOCK_JAX + "import torch; torch.set_num_threads(2); "
            "import gslidar_tpu_torch.parallel.comm, "
            "gslidar_tpu_torch.parallel.pano_shard, "
            "gslidar_tpu_torch.raster.oracle; "
            "from gslidar_tpu_torch.parallel.shard import dryrun_multichip; "
            "dryrun_multichip(2, 'cpu', loopback=True); "
            + NONE_LOADED + "print('NO_JAX_OK')")
    r = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "gshard_dropped=0 ok (loopback)" in r.stdout
    assert "NO_JAX_OK" in r.stdout


def test_kitti360_tree_oracle_and_comparison_run_without_jax(tmp_path):
    """The raw KITTI-360 tree writer and its converter, the dense oracle's
    gradients and the 2DGS / 3DGS comparison script run where ``import
    jax`` and ``import gslidar_tpu`` fail."""
    code = (BLOCK_JAX + "import torch; torch.set_num_threads(2); "
            "from gslidar_tpu_torch.data.kitti360_tree import "
            "write_kitti360_tree; "
            "from gslidar_tpu_torch.data.preprocess import kitti360_to_gs; "
            "from gslidar_tpu_torch.raster.oracle import rasterize_dense; "
            "from gslidar_tpu_torch.raster.scenes import splat_scene; "
            "from gslidar_tpu_torch.raster.settings import RasterSettings; "
            "from gslidar_tpu_torch.scripts import compare_2dgs_3dgs; "
            f"root = {str(tmp_path / 'data')!r}; "
            "kitti, n = write_kitti360_tree(root, 1908, 1971, 100); "
            "kitti360_to_gs.main('1908', kitti, root); "
            "import numpy as np; "
            "sc = {k: torch.as_tensor(v) for k, v in "
            "splat_scene(np.random.default_rng(0), 16).items()}; "
            "m = sc['means'].requires_grad_(); "
            "st = RasterSettings(height=16, width=32, vfov=(-20.0, 20.0), "
            "hfov=(-60.0, 60.0), num_extra_features=sc['feats'].shape[1]); "
            "out = rasterize_dense(m, sc['scales'], sc['quats'], sc['opac'], "
            "sc['shs'], sc['feats'], sc['mask'], sc['viewmat'], "
            "sc['campos'], torch.tensor([0.0, 0.0, 0.0, 1.0]), 3, 1.0, st); "
            "g, = torch.autograd.grad(out['color'].sum(), m); "
            "assert bool(torch.isfinite(g).all()); "
            "compare_2dgs_3dgs.main(['--device', 'cpu', '--out', "
            f"{str(tmp_path / 'cmp')!r}]); "
            + NONE_LOADED + "print('NO_JAX_OK', n)")
    r = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO_JAX_OK 6400" in r.stdout
    assert (tmp_path / "data" / "1908" / "transforms_1908_all.json").exists()
    assert (tmp_path / "cmp" / "case1.png").exists()
    assert (tmp_path / "cmp" / "case2.png").exists()


ENTRY_POINTS = ("gslidar_tpu_torch.bench",
                "gslidar_tpu_torch.scripts.bench_train_step",
                "gslidar_tpu_torch.scripts.profile_render",
                "gslidar_tpu_torch.scripts.profile_train_step",
                "gslidar_tpu_torch.scripts.tile_stats",
                "gslidar_tpu_torch.scripts.measure_tight_rects",
                "gslidar_tpu_torch.scripts.profile_preprocess")


def test_bench_and_scripts_run_without_jax():
    """Each measurement entry point's ``main`` on the CPU at 512 gaussians
    (the train-step scripts on a 16x64 panorama), where ``import jax`` and
    ``import gslidar_tpu`` fail."""
    cpu = "'--device', 'cpu', '--points', '512'"
    code = (BLOCK_JAX + "import importlib, torch; torch.set_num_threads(2); "
            f"mods = [importlib.import_module(m) for m in {ENTRY_POINTS!r}]; "
            "mods[1].H, mods[1].W = 16, 64; "
            f"mods[0].main([{cpu}, '--renders', '1']); "
            f"mods[1].main([{cpu}, '--steps', '1']); "
            f"mods[2].main([{cpu}, '--reps', '1']); "
            f"mods[3].main([{cpu}, '--reps', '1']); "
            f"mods[4].main([{cpu}, '--tiles', '16x16']); "
            f"mods[5].main([{cpu}]); "
            f"mods[6].main([{cpu}, '--calls', '1', '--plain']); "
            + NONE_LOADED + "print('NO_JAX_OK')")
    r = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    assert '"backend": "cpu"' in out and "ms/step" in out
    assert "FULL 360 single-pass render" in out and "FULL train step" in out
    assert "tile 16x16: grid 5x65" in out and "K per-row" in out
    assert "preprocess_reference of 512 gaussians" in out
    assert out.strip().endswith("NO_JAX_OK")


@pytest.mark.parametrize("module", ENTRY_POINTS)
def test_entry_points_refuse_without_a_card(module):
    r = subprocess.run([sys.executable, "-m", module, "--points", "64"],
                       cwd=REPO, env=_env(CUDA_VISIBLE_DEVICES=""),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert '"metric"' not in r.stdout


def test_chip_smoke_fails_without_a_card():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=_env(CUDA_VISIBLE_DEVICES=""),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "torch.cuda.is_available() is False" in r.stderr
