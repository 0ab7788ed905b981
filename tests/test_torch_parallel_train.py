"""The port's data-parallel layer (gslidar_tpu_torch.parallel.{comm,shard}
and the data-parallel branch of gslidar_tpu_torch.train) on the CPU, over
spawned gloo ranks (tests/torch_dist.py) and the in-process loopback:

* the four collectives over gloo (1 and 3 ranks) equal the loopback's
  (bit for bit but the 3-rank sum, which gloo adds in its own order),
  counted on every call, with uneven and empty all_to_all segments;
* one data-parallel step of B = 4 cameras over 2 gloo ranks against
  gslidar_tpu's ``make_parallel_train_step`` (B = 4 on a 2-device CPU
  mesh) at tests/torch_scenes.py::assert_step_matches's tolerances, and
  bit for bit the loopback's;
* the step's densification statistics against 4 sequential
  single-camera port steps from the same state (``denom`` and
  ``max_radii2D`` equal, the accumulators within 2e-4 relative, as
  tests/test_parallel_train_e2e.py holds JAX's), and the mean of their
  gradients against the step's;
* every rank's state bit for bit equal after 2 steps, a densify and
  another step;
* ``python -m torch.distributed.run --nproc_per_node=2 -m
  gslidar_tpu_torch.train ... --device cpu data_parallel=true`` with the
  JAX CLI test's overrides;
* a group of one rank without ``torch.distributed.run``, the guards,
  ``dryrun_multichip`` over the loopback, and ``parallel.check`` over 2
  ranks.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_dist import run_ranks
from torch_scenes import STEP_H as H, STEP_W as W, step_args, step_pcd

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4
ITERATION = 7001          # every loss schedule on


# ------------------------------------------------------------ collectives
def _collective_inputs(rank, n):
    g = torch.Generator().manual_seed(100 + rank)
    x = torch.randn(5, 3, generator=g)
    segs = [torch.randn((rank + s) % 3, 2, generator=g) for s in range(n)]
    return x, segs


def _collectives(group, inputs):
    out = {
        "sum": group.all_reduce([x for x, _ in inputs], "sum"),
        "max": group.all_reduce([x for x, _ in inputs], "max"),
        "gather0": group.all_gather([x for x, _ in inputs], 0),
        "gather1": group.all_gather([x for x, _ in inputs], -1),
        "a2a": group.all_to_all([segs for _, segs in inputs]),
    }
    group.barrier()
    return out, dict(group.calls)


def _gloo_collectives(rank, n):
    from gslidar_tpu_torch.parallel.comm import ProcessGroup
    out, calls = _collectives(ProcessGroup(), [_collective_inputs(rank, n)])
    return ({k: ([t.numpy() for t in v[0]] if k == "a2a" else v[0].numpy())
             for k, v in out.items()}, calls)


@pytest.mark.parametrize("n", [1, 3])
def test_collectives_match_loopback(n):
    from gslidar_tpu_torch.parallel.comm import Loopback
    loop = Loopback(n)
    want, calls = _collectives(loop, [_collective_inputs(r, n)
                                      for r in range(n)])
    assert calls == {"all_reduce": 2, "all_gather": 2, "all_to_all": 1,
                     "barrier": 1}
    for rank, (got, gcalls) in enumerate(run_ranks(_gloo_collectives, n,
                                                   timeout=90)):
        assert gcalls == calls
        # gloo sums 3 ranks in its own order, the loopback in rank order
        np.testing.assert_allclose(got["sum"], want["sum"][rank].numpy(),
                                   rtol=1e-6, atol=1e-6)
        for k in ("max", "gather0", "gather1"):
            np.testing.assert_array_equal(got[k], want[k][rank].numpy(), k)
        assert [s.shape[0] for s in got["a2a"]] == \
            [(s + rank) % 3 for s in range(n)]
        for s in range(n):
            np.testing.assert_array_equal(got["a2a"][s],
                                          want["a2a"][rank][s].numpy())
    assert want["gather1"][0].shape == (5, 3 * n)


# ------------------------------------------------------- the step's inputs
def _np_args():
    a = dict(step_args())
    a.update(densify_grad_threshold=0.0002, densify_grad_t_threshold=0.002,
             thresh_opa_prune=0.005)
    return a


def _init_jax():
    """gslidar_tpu's create_from_pcd of the step's point cloud."""
    from gslidar_tpu.models import gaussians as JG
    pts, cols = step_pcd(np.random.default_rng(0))
    return JG.create_from_pcd(pts, cols, None,
                              JG.GaussianConfig(random_init_point=0),
                              capacity=4096)


def _init_params():
    """``_init_jax``'s params (numpy) and alive mask."""
    params, aux = _init_jax()
    return {k: np.asarray(v) for k, v in params.items()}, \
        np.asarray(aux.alive)


def _port_setup(np_args, params, alive, group, **over):
    from gslidar_tpu_torch.config import Config
    from gslidar_tpu_torch.engine.train import init_train_state
    from gslidar_tpu_torch.models import gaussians as G
    from gslidar_tpu_torch.models.raydrop_prior import init_raydrop_prior
    from gslidar_tpu_torch.parallel.shard import (_toy_camera_batch,
                                                  make_parallel_train_step)
    from gslidar_tpu_torch.raster.settings import RasterSettings
    args = Config({**np_args, **over})
    cfg = G.GaussianConfig(random_init_point=0)
    p = G.params_from_numpy(params, "cpu", alive)
    state = init_train_state(p, G.GaussianAux.zeros(p["xyz"].shape[0],
                                                    "cpu"),
                             init_raydrop_prior(H, W))
    st = RasterSettings(height=H, width=W, vfov=tuple(args.vfov),
                        hfov=tuple(args.hfov), num_extra_features=4)
    bg = torch.tensor([0, 0, 0, 1.0])
    step = make_parallel_train_step(args, cfg, st, bg, group, n_cameras=B)
    return args, cfg, st, bg, state, step, _toy_camera_batch(B, H, W)


def _as_numpy(state, loss, log, grads):
    from gslidar_tpu_torch.engine.train import state_to_numpy
    s = state_to_numpy(state)
    return dict(params=s.params, aux=vars(s.aux), prior=s.prior,
                loss=float(loss),
                log={k: float(v) for k, v in log.items()},
                grads={k: v.numpy().copy() for k, v in grads.items()})


def _gloo_dp(rank, n, np_args, params, alive):
    """One B = 4 step at ITERATION, then, from the initial state, 2 steps
    with statistics, a densify and a third step."""
    from gslidar_tpu_torch.engine.train import make_densify_fn
    from gslidar_tpu_torch.parallel.comm import ProcessGroup
    group = ProcessGroup()
    args, cfg, _, _, state0, step, cams = _port_setup(np_args, params,
                                                      alive, group)
    one = _as_numpy(*step(state0, cams, ITERATION, 3, [0.0] * B, True))
    state, shifts = state0, [0.0, 0.05, -0.1, 0.0]
    for it in (1, 2):
        state = step(state, cams, 100 + it, 3, shifts, True)[0]
    gen = torch.Generator().manual_seed(3)
    state, counts = make_densify_fn(args, cfg)(state, gen, 5.0, None)
    after = _as_numpy(*step(state, cams, 103, 3, shifts, True))
    return one, after, counts, dict(group.calls)


@pytest.fixture(scope="module")
def dp_runs():
    np_args = _np_args()
    params, alive = _init_params()
    return (np_args, params, alive,
            run_ranks(_gloo_dp, 2, np_args, params, alive, timeout=240))


def test_dp_step_matches_jax(dp_runs):
    import jax
    import jax.numpy as jnp
    from gslidar_tpu.config import Config as JConfig
    from gslidar_tpu.engine.train import init_train_state
    from gslidar_tpu.models import gaussians as JG
    from gslidar_tpu.models.raydrop_prior import init_raydrop_prior
    from gslidar_tpu.parallel.shard import (_toy_camera_batch, make_mesh,
                                            make_parallel_train_step)
    from gslidar_tpu.raster.settings import RasterSettings as JS
    from gslidar_tpu_torch.models.gaussians import PARAM_KEYS
    np_args, params, alive, ranks = dp_runs
    got = ranks[0][0]

    jstate = init_train_state(*_init_jax(), init_raydrop_prior(H, W))
    args = JConfig(np_args)
    js = JS(height=H, width=W, vfov=tuple(args.vfov), hfov=tuple(args.hfov),
            num_extra_features=4, pair_cap=1 << 14, tile_chunk=16,
            tile_list_cap=4096, backend="xla")
    mesh = make_mesh(2)
    step = make_parallel_train_step(args, JG.GaussianConfig(
        random_init_point=0), js, jnp.asarray([0, 0, 0, 1.0]), mesh,
        n_cameras=B)
    with mesh:
        new, loss, log = step(jstate, _toy_camera_batch(B, H, W),
                              jnp.asarray(float(ITERATION)),
                              jnp.asarray(3, jnp.int32),
                              jnp.zeros(B, jnp.float32), jnp.asarray(True))
    assert int(log["num_dropped"]) == 0
    new = jax.tree.map(np.asarray, new)
    j0 = jax.tree.map(np.asarray, jstate)

    def rel(a, b, rtol, name):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-30), \
            name

    rel(got["loss"], float(loss), 1e-3, "loss")
    for k, v in log.items():
        if k.startswith("loss"):
            rel(got["log"][k], float(v), 1e-3, k)
    assert got["log"]["num_pairs"] == int(log["num_pairs"]) > 0
    f01, f09 = np.float32(0.1), np.float32(0.9)
    for k in PARAM_KEYS:
        g_jax = ((new.opt.mu[k] - f09 * j0.opt.mu[k]) / f01)[alive]
        g = got["grads"][k]
        assert np.isfinite(g).all(), k
        ref = np.linalg.norm(g_jax)
        if k == "intensity":
            assert ref == 0 and not g.any()
            continue
        assert ref > 0 and np.linalg.norm(g - g_jax) <= 1e-3 * ref, k
        big = np.abs(g_jax) >= 1e-3 * np.abs(g_jax).max()
        np.testing.assert_allclose(got["params"][k][big],
                                   new.params[k][alive][big], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    g_jax = (new.prior_opt[0] - f09 * j0.prior_opt[0]) / f01
    assert np.linalg.norm(got["grads"]["prior"] - g_jax) <= \
        1e-3 * np.linalg.norm(g_jax)
    rel(got["prior"], new.prior, 1e-5, "prior")
    for k in ("max_radii2D", "denom"):
        np.testing.assert_array_equal(got["aux"][k],
                                      getattr(new.aux, k)[alive], k)
    assert got["aux"]["denom"].max() == B
    for k in ("xyz_gradient_accum", "t_gradient_accum"):
        a = getattr(new.aux, k)[alive]
        assert np.linalg.norm(got["aux"][k] - a) <= \
            1e-3 * np.linalg.norm(a), k


def _same(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_gloo_step_matches_loopback_bitwise(dp_runs):
    from gslidar_tpu_torch.parallel.comm import Loopback
    np_args, params, alive, ranks = dp_runs
    group = Loopback(2)
    *_, state0, step, cams = _port_setup(np_args, params, alive, group)
    want = _as_numpy(*step(state0, cams, ITERATION, 3, [0.0] * B, True))
    for rank, (got, *_rest) in enumerate(ranks):
        _same(got, want, f"rank {rank}")
    # one flat bucket and the instance count, then the statistics
    assert group.calls == {"all_reduce": 2, "all_gather": 1}


def test_ranks_identical_after_densify(dp_runs):
    *_, ranks = dp_runs
    (_, a, counts_a, calls_a), (_, b, counts_b, calls_b) = ranks
    assert counts_a == counts_b
    assert counts_a["after"] != counts_a["before"]
    assert a["params"]["xyz"].shape[0] == counts_a["after"]
    _same(a, b)
    # 4 steps, each 2 all-reduces and a gather of the statistics
    assert calls_a == calls_b == {"all_reduce": 8, "all_gather": 4}


def test_dp_stats_match_sequential_steps():
    from gslidar_tpu_torch.engine.train import make_train_step
    from gslidar_tpu_torch.parallel.comm import Loopback
    from gslidar_tpu_torch.parallel.shard import camera_at
    params, alive = _init_params()
    # a frozen prior: the sequential steps see the DP step's inputs
    args, cfg, st, bg, state0, step, cams = _port_setup(
        _np_args(), params, alive, Loopback(2), raydrop_prior_lr=0.0)
    shifts = [0.0, 0.05, -0.1, 0.0]
    dp, _, _, grads = step(state0, cams, 100, 3, shifts, True)
    seq = make_train_step(args, cfg, st, bg)
    s, seq_grads = state0, []
    for i in range(B):
        s, _, _, g = seq(s, camera_at(cams, i), 100, 3, shifts[i], True,
                         apply_update=False)
        seq_grads.append(g)
    for k in ("denom", "max_radii2D"):
        np.testing.assert_array_equal(getattr(dp.aux, k).numpy(),
                                      getattr(s.aux, k).numpy(), k)
    assert float(s.aux.denom.max()) == B
    for k in ("xyz_gradient_accum", "t_gradient_accum"):
        np.testing.assert_allclose(getattr(dp.aux, k).numpy(),
                                   getattr(s.aux, k).numpy(), rtol=2e-4,
                                   atol=1e-9, err_msg=k)
    for k, g in grads.items():
        mean = sum(sg[k] for sg in seq_grads) / B
        assert float((g - mean).norm()) <= 2e-4 * float(mean.norm()) + \
            1e-12, k


def test_step_guards():
    from gslidar_tpu_torch.parallel.comm import Loopback
    from gslidar_tpu_torch.parallel.shard import make_parallel_train_step
    with pytest.raises(ValueError, match="do not divide over 2 ranks"):
        make_parallel_train_step({}, None, None, None, Loopback(2),
                                 n_cameras=3)
    params, alive = _init_params()
    *_, state0, step, cams = _port_setup(_np_args(), params, alive,
                                         Loopback(2))
    with pytest.raises(ValueError, match="takes 4 cameras"):
        step(state0, cams, 100, 3, [0.0] * 3, True)


def test_one_rank_group_without_launcher():
    code = (
        "import os, torch\n"
        "assert 'RANK' not in os.environ\n"
        "from gslidar_tpu_torch.parallel.shard import make_mesh\n"
        "g = make_mesh(device='cpu')\n"
        "assert (g.rank, g.size, g.backend) == (0, 1, 'gloo'), vars(g)\n"
        "x = g.all_reduce([torch.ones(3)])[0]\n"
        "assert x.tolist() == [1.0] * 3 and g.calls['all_reduce'] == 1\n"
        "try:\n"
        "    make_mesh(2, 'cpu')\n"
        "except ValueError as e:\n"
        "    print('GUARD', e)\n"
        "print('ONE_RANK_OK')\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ONE_RANK_OK" in r.stdout
    assert "GUARD 2 devices asked, the group has 1 ranks" in r.stdout


def test_dryrun_multichip_loopback(capsys):
    from gslidar_tpu_torch.parallel.shard import dryrun_multichip
    dryrun_multichip(2, "cpu", loopback=True)
    assert "gshard_dropped=0 ok (loopback)" in capsys.readouterr().out


def test_data_parallel_cli_under_torchrun(tmp_path):
    out = tmp_path / "run"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=2", "-m", "gslidar_tpu_torch.train",
           "--config", "configs/synthetic_smoke.yaml", "--device", "cpu",
           "--skip_refine", "--show_log", f"model_path={out}",
           "data_parallel=true", "iterations=12", "hw=[32,64]",
           "num_pts=1500", "frames=4", "densify_from_iter=4",
           "densification_interval=6", "densify_until_iter=11",
           "test_iterations=[12]", "checkpoint_iterations=[12]",
           "vis_step=12", "raster_pair_cap=16384",
           "densify_until_num_points=8000", "eval_full360=false"]
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=600)
    tail = r.stderr[-2000:] + r.stdout[-2000:]
    assert r.returncode == 0, tail
    assert "[data_parallel] 2 cameras/iter over 2 ranks (gloo)" in r.stdout, \
        tail
    assert r.stdout.count("[6] densify:") == 2, tail     # on both ranks
    m = json.loads((out / "eval" / "test_12_render" /
                    "metrics.json").read_text())
    assert "Ray drop" in m
    assert (out / "ckpt" / "chkpnt12.npz").exists()
    assert r.stdout.count("Saving Checkpoint") == 1, tail  # rank 0 only


def test_multichip_check_over_two_gloo_ranks():
    """``gslidar_tpu_torch.parallel.check`` (what the 4-card call runs)
    over 2 CPU ranks at a tiny size: the step and the three renders over
    the group agree with the loopback and every rank's state is the
    same."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "gslidar_tpu_torch.parallel.check",
         "--device", "cpu", "--gaussians", "1000", "--height", "16",
         "--slice-width", "32"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert (out["world_size"], out["backend"]) == (2, "gloo")
    assert out["step"]["ok"] and out["step"]["ranks_bitwise"]
    assert all(v["bitwise_vs_loopback"] and v["num_dropped"] == 0
               for k, v in out["renders"].items() if k != "unsliced ms")
