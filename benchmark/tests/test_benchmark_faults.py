"""The check fails a broken run: the harness drives a tiny cell on the CPU
with the timed path broken underneath, once for each fault the cells can
have and for gradients turned in another direction, and ``correct``
comes out false; the controls (the reference in bfloat16, half the view
left out) read above the limits."""

import pytest
import torch

from tiny_cell import SEED, TINY, run_tiny, tiny_spec


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    import gslidar_tpu_torch.engine.train as T
    make = T.make_train_step

    def broken(*a, **k):
        step = make(*a, **k)

        def run(state, *b, **kw):
            _, loss, log, grads = step(state, *b, **kw)
            return state, loss, log, grads
        return run
    monkeypatch.setattr(T, "make_train_step", broken)
    rc, line = run_tiny("tiny_train", monkeypatch)
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["change_gap"]["value"] > \
        line["checks"]["change_gap"]["limit"]


def test_half_the_batch_left_out(monkeypatch):
    import gslidar_tpu_torch.engine.train as T
    losses = T.compute_losses

    def broken(pkg, pts_depth, pts_intensity, *a, **k):
        half = pts_depth.shape[-2] // 2
        d, i = pts_depth.clone(), pts_intensity.clone()
        d[..., half:, :] = 0.0
        i[..., half:, :] = 0.0
        return losses(pkg, d, i, *a, **k)
    monkeypatch.setattr(T, "compute_losses", broken)
    rc, line = run_tiny("tiny_train", monkeypatch)
    assert rc == 0 and line["correct"] is False


@pytest.mark.parametrize("fault", ["negated", "scattered"])
def test_gradients_turned_keep_their_norms_and_fail(fault, monkeypatch):
    """Gradients negated, or handed to the wrong gaussians (each row's to
    the next row), keep every norm the other numbers compare; the change
    along the reference's gradient fails."""
    import gslidar_tpu_torch.engine.train as T
    adam = T.adam_step

    def turn(g):
        if fault == "negated":
            return -g
        return torch.roll(g, 1, dims=0)

    def broken(params, grads, *a, **k):
        return adam(params, {key: turn(g) for key, g in grads.items()},
                    *a, **k)
    monkeypatch.setattr(T, "adam_step", broken)
    rc, line = run_tiny("tiny_train", monkeypatch)
    assert rc == 0 and line["correct"] is False
    c = line["checks"]
    assert c["descent_gap"]["value"] > c["descent_gap"]["limit"]
    assert c["change_gap"]["value"] <= c["change_gap"]["limit"]


@pytest.mark.parametrize("workload,control", [
    ("tiny_train", "bf16"), ("tiny_train", "half_view")])
def test_the_control_fails_a_number(workload, control, monkeypatch):
    from benchmark import run
    from benchmark.controls import run_control
    monkeypatch.setattr(run, "DATA_DIR", TINY)
    out = run_control(tiny_spec(), workload, SEED, control,
                      torch.device("cpu"))
    assert any(out["numbers"][k] > out["limits"][k] for k in out["limits"])
