"""The port's training loop (gslidar_tpu_torch.train.training) on the CPU,
on a tiny Synthetic scene (16x64 halves, 2000 points), driven through its
hooks:

* the densify, opacity reset, time-split flip, coarse-to-fine and
  checkpoint events fire at exactly the iterations the root train.py's
  conditions give (train.py:304-309,329,335-338,356-358,451,461),
  transcribed here from it, for two configs; one has a white background,
  and sees no reset at ``densify_from_iter`` (JAX's window is strict
  there), one closes the window on ``densify_until_num_points``;
* ``schedule``, the function chip_smoke.py checks the card's run with,
  gives the same events;
* each densify's counts add up, its aux accumulators and new moments are
  zero, each reset leaves opacity at most ``init_opacity`` with zero
  opacity moments, the prior takes the finer grid at the coarse-to-fine
  step with fresh moments;
* a resume from a checkpoint loads every leaf as it was saved, replays
  the coarse-to-fine steps and takes the remaining steps.
"""

import math
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVENTS = ("flip", "densify", "reset", "upscale", "checkpoint")

CONFIGS = {
    # the cadence chip_smoke.py's training phase uses, at 16x64
    "cadence": ["iterations=16", "densify_from_iter=4",
                "densification_interval=4", "densify_until_iter=14",
                "opacity_reset_interval=6", "scale_increase_interval=10",
                "checkpoint_iterations=[12]", "vis_step=8",
                "resolution_scales=[1,2]"],
    # white background; no time split to flip; the window closes on the
    # count after the first densify
    "white_background": ["iterations=11", "densify_from_iter=3",
                         "densification_interval=3", "densify_until_iter=11",
                         "opacity_reset_interval=5", "white_background=true",
                         "no_time_split=false",
                         "densify_until_num_points=2100",
                         "scale_increase_interval=4", "vis_step=100",
                         "checkpoint_iterations=[5]"],
}


def _args(name, tmp_path, extra=()):
    from gslidar_tpu_torch.train import load_args
    return load_args(os.path.join(REPO, "configs", "synthetic_smoke.yaml"),
                     os.path.join(REPO, "configs", "base.yaml"),
                     ["hw=[16,64]", "num_pts=2000", "frames=4",
                      f"model_path={tmp_path / name}", *CONFIGS[name],
                      *extra])


def _jax_loop_events(args, iteration, n_alive, no_time_split):
    """The root train.py's conditions, as written there."""
    in_window = (args.densify_from_iter < iteration < args.densify_until_iter
                 and (args.densify_until_num_points < 0
                      or n_alive < args.densify_until_num_points))
    is_densify = (in_window
                  and iteration % args.densification_interval == 0)
    out = []
    if no_time_split and \
            iteration > args.densify_until_iter * args.time_split_frac:
        out.append("flip")
    if is_densify:
        out.append("densify")
    if (in_window and (iteration % args.opacity_reset_interval == 0
                       or (args.white_background
                           and iteration == args.densify_from_iter))):
        out.append("reset")
    if iteration % args.scale_increase_interval == 0:
        out.append("upscale")
    if iteration in args.checkpoint_iterations:
        out.append("checkpoint")
    return out


def _drive(args):
    """Train, recording the count before each step, each event and what
    the checks need."""
    from gslidar_tpu_torch.engine.train import state_to_numpy
    from gslidar_tpu_torch.train import training
    rec = dict(n={}, events={}, densify={}, reset={}, upscale={}, ckpt={})

    def on_step(it, state, loss, log, grads):
        rec["n"][it] = state.params["xyz"].shape[0]
        rec["events"][it] = []
        assert math.isfinite(float(loss))

    def on_event(it, name, state, info):
        rec["events"][it].append(name)
        if name == "densify":
            rec["densify"][it] = (dict(info), state)
        elif name == "reset":
            rec["reset"][it] = state
        elif name == "upscale":
            rec["upscale"][it] = state
        elif name == "checkpoint":
            rec["ckpt"][it] = (info, state_to_numpy(state))

    state, scene, losses = training(args, "cpu", on_step=on_step,
                                    on_event=on_event)
    return state, scene, losses, rec


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loop_fires_the_jax_loops_events(name, tmp_path):
    from gslidar_tpu_torch.render import gaussian_config
    from gslidar_tpu_torch.train import schedule
    args = _args(name, tmp_path)
    state, scene, losses, rec = _drive(args)
    assert len(losses) == args.iterations
    nts = bool(args.no_time_split)
    fired_any = set()
    for it in range(1, args.iterations + 1):
        want = _jax_loop_events(args, it, rec["n"][it], nts)
        assert want == schedule(args, it, rec["n"][it], nts), it
        got = [e for e in rec["events"][it] if e in EVENTS]
        assert got == want, (it, got, want)
        nts = nts and "flip" not in got
        fired_any |= set(got)
        vis = it % args.vis_step == 0 or it == 1
        assert ("vis" in rec["events"][it]) == vis, it
        assert ("eval" in rec["events"][it]) == (it in args.test_iterations)
    init_opacity = gaussian_config(args).init_opacity
    for it, (c, st) in rec["densify"].items():
        assert c["world_size_prune"] == (it > args.opacity_reset_interval)
        assert (c["before"] - c["never_visible"] - c["splits"] + c["new"]
                - c["opacity_pruned"] - c["world_size_pruned"]) == c["after"]
        assert st.params["xyz"].shape[0] == c["after"]
        for k, v in st.opt.mu.items():       # the new rows' moments
            assert not v[c["old_kept"]:].any(), k
            assert not st.opt.nu[k][c["old_kept"]:].any(), k
        assert all(not getattr(st.aux, f).any() for f in (
            "max_radii2D", "xyz_gradient_accum", "t_gradient_accum",
            "denom"))
        assert c["new"] > 0
    for it, st in rec["reset"].items():
        assert float(torch.sigmoid(st.params["opacity"]).max()) <= \
            init_opacity + 1e-6
        assert not st.opt.mu["opacity"].any()
        assert not st.opt.nu["opacity"].any()
    for it, st in rec["upscale"].items():
        w, h = scene.get_wh()
        assert st.prior.shape == (1, h, 2 * w)
        assert st.prior_opt[2] == 0 and not st.prior_opt[0].any()
    for it, (info, _) in rec["ckpt"].items():
        assert os.path.getsize(info["path"]) == info["bytes"] > 0
    if name == "cadence":
        assert fired_any == set(EVENTS)
        assert scene.get_wh() == (64, 16)       # the finer of [1, 2]
        assert sorted(rec["ckpt"]) == [12, 16]
        _check_resume(args, rec, tmp_path)
    else:
        # the window closed on the count after the first densify
        assert sorted(rec["densify"]) == [6]
        assert 3 not in rec["reset"] and "flip" not in fired_any


def _check_resume(args, rec, tmp_path):
    from gslidar_tpu_torch.config import Config
    from gslidar_tpu_torch.engine.checkpoint import (load_train_state,
                                                     state_leaves)
    from gslidar_tpu_torch.engine.train import state_to_numpy
    from gslidar_tpu_torch.train import training
    info, saved = rec["ckpt"][12]
    loaded, it = load_train_state(info["path"], "cpu")
    assert it == 12
    for a, b in zip(state_leaves(state_to_numpy(loaded)),
                    state_leaves(saved)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    resume = _args("cadence", tmp_path, ["iterations=14"])
    Config.update(resume, "start_checkpoint", info["path"])
    state, scene, losses = training(resume, "cpu")
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert scene.get_wh() == (64, 16)           # the upscale at 10 replayed
    assert state.opt.count == loaded.opt.count + 2


def _cli(tmp_path, *argv):
    """``parse_cli`` and ``prepare_run`` on synthetic_smoke as the
    training CLI runs them; returns the run config."""
    from gslidar_tpu_torch.train import parse_cli, prepare_run
    _, args = parse_cli(
        ["--config", os.path.join(REPO, "configs", "synthetic_smoke.yaml"),
         "--base_config", os.path.join(REPO, "configs", "base.yaml"),
         "--device", "cpu", f"model_path={tmp_path / 'run'}",
         "iterations=12", "test_interval=5", *argv])
    prepare_run(args)
    return args


@pytest.mark.parametrize("exhaust", [True, False])
def test_cli_exhaust_test_adds_evals(tmp_path, exhaust):
    """``exhaust_test`` adds an eval every ``test_interval`` below
    ``iterations`` (root train.py:529-531); ``iterations`` is appended to
    the save, checkpoint and test iterations (:503-509)."""
    args = _cli(tmp_path, f"exhaust_test={str(exhaust).lower()}")
    assert args.test_iterations == [300, 12] + ([0, 5, 10] if exhaust
                                                else [])
    assert args.save_iterations == [300, 12]
    assert args.checkpoint_iterations == [300, 12]


@pytest.mark.parametrize("flags,kept", [
    ((), False), (("--start_checkpoint", "ckpt/chkpnt4.npz"), True),
    (("--test_only",), True)], ids=["fresh", "start_checkpoint",
                                    "test_only"])
def test_cli_removes_a_stale_model_path(tmp_path, flags, kept):
    """An existing ``model_path`` is removed before a fresh run, and kept
    under ``--start_checkpoint`` or ``--test_only`` (root train.py:
    489-491)."""
    run = tmp_path / "run"
    (run / "ckpt").mkdir(parents=True)
    (run / "stale.txt").write_text("from an earlier run")
    (run / "scale_factor.txt").write_text("0.1")       # --test_only reads it
    args = _cli(tmp_path, *flags)
    assert (run / "stale.txt").exists() is kept
    assert run.is_dir()
    assert args.test_only is ("--test_only" in flags)
