"""The losses' weights and their CUDA graph pair (engine/losses.py,
engine/loss_graph.py).

On the CPU: ``loss_weights`` gives the weights the eager code formed, bit
for bit, on both benchmark configurations' lambdas around the schedules'
switches and with ``lidar_decay`` on; ``compute_losses`` on the CPU stays
the eager code (the benchmark's frozen copy of it gives the same loss,
log and gradients, bit for bit) and captures and replays nothing.

On the card (``-m cuda``): the graph against the eager code over steps of
different cameras (loss, every log term and every plane gradient equal,
bit for bit but the depth plane's, where the chamfer's backward adds by
atomics: there within a few ulps or two eager runs' own spread), a weight
change across iteration 7000 without a second capture, two forwards
before one backward as the data-parallel step calls them, a retained
graph's second backward, a second resolution's capture, and the chamfer
pair's launches counted once a step.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

CONFIGS = ("kitti360_nvs_1908", "kitti360_nvs_10750")
TERMS = ("distortion", "lidar", "lidar_median", "v_reg", "intensity_sh",
         "raydrop", "chamfer", "smooth", "normal_consistency",
         "opacity_entropy")


def bench_args(name, **over):
    """The configuration's run keys as the program reads them."""
    from gslidar_tpu_torch.config import Config
    with open(os.path.join(REPO, "benchmark", "configs",
                           name + ".json")) as f:
        run = json.load(f)["run"]
    return Config({**run, **over})


def eager_products(args, iteration):
    """Each term's multiplier as the eager code wrote it before
    ``loss_weights`` (benchmark/reference/losses.py keeps that code)."""
    import math
    decay = (math.exp(-iteration / 8000.0 * args.lidar_decay)
             if args.lidar_decay > 0 else 1.0)
    return {
        "distortion": args.lambda_distortion if iteration > 3000 else 0.0,
        "lidar": decay * args.lambda_lidar,
        "lidar_median": args.lambda_lidar_median,
        "v_reg": args.lambda_v_reg,
        "intensity_sh": args.lambda_intensity_sh,
        "raydrop": args.lambda_raydrop,
        "chamfer": args.lambda_chamfer,
        "smooth": args.lambda_smooth,
        "normal_consistency": (args.lambda_normal_consistency
                               if iteration > 7000 else 0.0),
        "opacity_entropy": args.lambda_opacity_entropy,
    }


@pytest.mark.parametrize("lidar_decay", [None, 1])
@pytest.mark.parametrize("iteration", [3000, 3001, 7000, 7001, 20001])
@pytest.mark.parametrize("name", CONFIGS)
def test_loss_weights_are_the_eager_codes(name, iteration, lidar_decay):
    from gslidar_tpu_torch.engine.losses import loss_weights
    over = {} if lidar_decay is None else {"lidar_decay": lidar_decay}
    args = bench_args(name, **over)
    w = loss_weights(args, iteration)
    want = eager_products(args, iteration)
    assert tuple(w) == TERMS
    for t in TERMS:
        assert w[t] == want[t], t
        assert np.float32(w[t]).tobytes() == np.float32(want[t]).tobytes()
        # the graph's vector rounds each weight as a scalar multiply does
        assert torch.tensor([w[t]], dtype=torch.float32).numpy().tobytes() \
            == np.float32(want[t]).tobytes()
    if lidar_decay:
        assert w["lidar"] < args.lambda_lidar


def make_pkg(h, w, seed, device):
    """Seeded render planes built as the render builds them (slices of
    one depth tensor, a normalised normal, a clamped ray drop) from leaves
    that need a gradient, and GT panoramas with a sixth of the returns
    dropped: (pkg, leaves, pts_depth, pts_intensity)."""
    from gslidar_tpu_torch.engine.render import RenderPkg
    g = torch.Generator().manual_seed(seed)

    def u(c, lo, hi):
        return (lo + (hi - lo) * torch.rand(c, h, w, generator=g)).to(device)

    leaves = {"depth": u(4, 0.5, 30.0), "alpha": u(1, -3.0, 3.0),
              "color": u(4, -2.0, 2.0), "feature": u(7, -1.0, 1.0)}
    for v in leaves.values():
        v.requires_grad_(True)
    gt = u(1, 1.0, 30.0) * (u(1, 0.0, 1.0) > 1 / 6)
    d, f, c = leaves["depth"], leaves["feature"], leaves["color"]
    normal = f[4:7] / torch.sqrt(torch.sum(f[4:7] * f[4:7], dim=0,
                                           keepdim=True) + 1e-16)
    pkg = RenderPkg(
        depth=d[0:1], depth_mean=d[0:1], depth_median=d[1:2],
        distortion=d[2:3], depth_square=d[3:4],
        alpha=torch.sigmoid(leaves["alpha"]), feature=f[:4], normal=normal,
        intensity_sh=c[2:3],
        raydrop=torch.clamp(torch.sigmoid(c[3:4]), 0.0, 1.0), radii=None,
        visibility=None, contrib=None, num_dropped=0, num_pairs=0,
        tile_need=0)
    return pkg, leaves, gt, u(1, 0.0, 1.0)


def _bits_equal(a, b):
    return a.shape == b.shape and torch.equal(
        a.detach().cpu().view(torch.int32), b.detach().cpu().view(torch.int32))


@pytest.mark.parametrize("iteration", [3000, 7001])
@pytest.mark.parametrize("name", CONFIGS)
def test_cpu_losses_are_the_eager_codes(name, iteration):
    from benchmark.reference.losses import compute_losses as frozen
    from gslidar_tpu_torch.engine.losses import compute_losses
    from gslidar_tpu_torch.utils.trace import counters
    args = bench_args(name)
    before = counters()
    out = []
    for fn in (compute_losses, frozen):
        pkg, leaves, d, i = make_pkg(16, 64, 7, "cpu")
        loss, log = fn(pkg, d, i, iteration, args, None, None)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out.append((loss, log, grads))
    (loss, log, grads), (f_loss, f_log, f_grads) = out
    assert _bits_equal(loss, f_loss)
    assert list(log) == list(f_log) == ["loss_" + t for t in TERMS] + ["loss"]
    for k in log:
        assert _bits_equal(log[k], f_log[k]), k
    for g, f in zip(grads, f_grads):
        assert _bits_equal(g, f)
    after = counters()
    for k in ("loss_graph.captures", "loss_graph.replays"):
        assert after.get(k, 0) == before.get(k, 0) == 0


# ---------------------------------------------------------------- the card
H, W = 66, 515


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gslidar_tpu_torch.engine import loss_graph
    loss_graph.clear()
    return torch.device("cuda", 0)


def _run(args, iteration, seed, dev, graphed, h=H, w=W):
    """One camera's losses and the leaves' gradients, on the host: the
    graph (``compute_losses``) or the eager code."""
    from gslidar_tpu_torch.engine.losses import (_losses, compute_losses,
                                                 loss_weights)
    pkg, leaves, d, i = make_pkg(h, w, seed, dev)
    if graphed:
        loss, log = compute_losses(pkg, d, i, iteration, args, None, None)
    else:
        loss, log = _losses(pkg, d, i, args, loss_weights(args, iteration),
                            None, None)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return ({k: v.detach().cpu() for k, v in log.items()},
            [g.cpu() for g in grads])


def _assert_matches(got, want, again):
    """Loss and log bit for bit; every gradient bit for bit but the depth
    plane's (the chamfer's atomics), which stays within the larger of two
    eager runs' spread and 8 ulps of its largest element."""
    log, grads = got
    e_log, e_grads = want
    assert list(log) == list(e_log)
    for k in log:
        assert _bits_equal(log[k], e_log[k]), k
    for j, (g, e) in enumerate(zip(grads, e_grads)):
        if j == 0:
            assert _bits_equal(g[1:], e[1:])
            spread = float((again[1][0][0] - e[0]).abs().max())
            floor = 8 * float(np.finfo(np.float32).eps) * float(
                e[0].abs().max())
            assert float((g[0] - e[0]).abs().max()) <= max(spread, floor)
        else:
            assert _bits_equal(g, e), j


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONFIGS)
def test_card_graph_is_the_eager_code(name):
    from gslidar_tpu_torch.utils.trace import counters
    dev = _card()
    args = bench_args(name)
    for k, seed in enumerate((11, 12, 13)):
        before = counters()
        got = _run(args, 20001 + k, seed, dev, True)
        now = counters()
        want = _run(args, 20001 + k, seed, dev, False)
        again = _run(args, 20001 + k, seed, dev, False)
        _assert_matches(got, want, again)

        def made(c):
            return now.get(c, 0) - before.get(c, 0)
        assert made("loss_graph.replays") == 2
        assert made("loss_graph.captures") == (k == 0)
        assert made("launches.chamfer_fwd") == 1
        assert made("launches.chamfer_bwd") == 1


@pytest.mark.cuda
def test_card_weights_change_across_7000_in_one_capture():
    from gslidar_tpu_torch.engine import loss_graph
    dev = _card()
    args = bench_args("kitti360_nvs_1908")
    losses = []
    for it in (6999, 7000, 7001, 7002):
        got = _run(args, it, 21, dev, True)
        want = _run(args, it, 21, dev, False)
        again = _run(args, it, 21, dev, False)
        _assert_matches(got, want, again)
        losses.append(got[0]["loss"])
    assert loss_graph.captures() == [1]
    assert torch.equal(losses[0], losses[1])
    assert not torch.equal(losses[1], losses[2])


@pytest.mark.cuda
def test_card_two_forwards_then_one_backward():
    """The data-parallel step's order: each camera's losses, then one
    backward of their sum; each camera gets its own gradients."""
    from gslidar_tpu_torch.engine import loss_graph
    from gslidar_tpu_torch.engine.losses import compute_losses
    dev = _card()
    args = bench_args("kitti360_nvs_10750")
    cams = [make_pkg(H, W, seed, dev) for seed in (31, 32)]
    out = [compute_losses(pkg, d, i, 20001, args, None, None)
           for pkg, _, d, i in cams]
    leaves = [v for _, lv, _, _ in cams for v in lv.values()]
    grads = torch.autograd.grad(out[0][0] + out[1][0], leaves)
    assert loss_graph.captures() == [2]
    for c, seed in enumerate((31, 32)):
        got = ({k: v.detach().cpu() for k, v in out[c][1].items()},
               [g.cpu() for g in grads[4 * c:4 * c + 4]])
        want = _run(args, 20001, seed, dev, False)
        again = _run(args, 20001, seed, dev, False)
        _assert_matches(got, want, again)


@pytest.mark.cuda
def test_card_second_resolution_captures_again():
    from gslidar_tpu_torch.engine import loss_graph
    dev = _card()
    args = bench_args("kitti360_nvs_1908")
    for h, w, caps in ((H, W, [1]), (33, 258, [1, 1]), (H, W, [1, 1])):
        got = _run(args, 20001, 41, dev, True, h, w)
        want = _run(args, 20001, 41, dev, False, h, w)
        again = _run(args, 20001, 41, dev, False, h, w)
        _assert_matches(got, want, again)
        assert loss_graph.captures() == caps


@pytest.mark.cuda
def test_card_retained_graph_backs_up_twice():
    """A graph retained for a second backward gives the same gradients
    again: the backward's replay reads the forward's saved buffers, which
    no buffer of the backward itself overwrites."""
    from gslidar_tpu_torch.engine.losses import compute_losses
    dev = _card()
    args = bench_args("kitti360_nvs_1908")
    pkg, leaves, d, i = make_pkg(H, W, 51, dev)
    loss, _ = compute_losses(pkg, d, i, 20001, args, None, None)
    first = [g.clone() for g in torch.autograd.grad(
        loss, list(leaves.values()), retain_graph=True)]
    second = torch.autograd.grad(loss, list(leaves.values()))
    for a, b in zip(first, second):
        assert _bits_equal(a[1:], b[1:])
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-6)
