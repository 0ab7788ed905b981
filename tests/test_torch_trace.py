"""The port's spans and counters (``gslidar_tpu_torch/utils/trace.py``) on
one small CPU training step: 3,000 gaussians of the bench's ring, one
16x64 half panorama, kitti360_nvs_1908's losses, dynamic so that every
group has a gradient.

* under ``torch.profiler`` the trace holds ``gs.step`` and, nested in
  it, every span the step reaches, the backward's by layer included;
* with no profiler no record function is made;
* the gradients and the new state are the same bits with the profiler on
  and off: the backward's hooks change nothing;
* a step counts its host syncs site by site and binning's instances;
* the hand-written kernels' launches are counted in the registry only;
* the two benchmark readers of the counters;
* ``train.py``'s ``profile_iter`` trace holds the spans.

The card test (``-m cuda``, on an H100) counts the syncs that
``torch.cuda.set_sync_debug_mode`` sees in a 1M-gaussian step against the
registry's, binning's one and no chamfer site, and the device time
launched inside the step's spans.
"""

import contextlib
import dataclasses
import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 16, 64

# a CPU step's device-to-host reads, by site: binning's instance total,
# the plain chamfer's two boolean selections, the backward of the one that
# needs a gradient (the predicted points) and of both masked_scatters
STEP_SYNCS = {"binning": 1, "chamfer_mask": 2, "chamfer_index_bwd": 1,
              "chamfer_scatter_bwd": 2}
# a card step's: binning's alone (the chamfer's kernels read nothing back)
CARD_STEP_SYNCS = {"binning": 1}
GROUPS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation", "t",
          "scaling_t", "velocity", "intensity")
# parent -> the spans a step reaches inside it
NESTING = {
    "step": ("step.render", "step.losses", "step.backward", "step.stats",
             "step.adam", "step.prior_adam"),
    "step.render": ("render.activations", "render.prior", "preprocess",
                    "pack_payload", "binning", "composite.fwd"),
    "binning": ("sync.binning", "binning.expand", "binning.sort",
                "binning.gather"),
    "step.losses": tuple("loss." + t for t in (
        "distortion", "lidar", "lidar_median", "v_reg", "intensity_sh",
        "raydrop", "chamfer", "smooth", "normal_consistency",
        "opacity_entropy")),
    "loss.chamfer": ("sync.chamfer_mask",),
    "step.backward": ("bwd.losses", "bwd.render", "bwd.activations"),
    "bwd.render": ("composite.bwd", "composite.reduce", "preprocess.bwd"),
    "step.adam": tuple("adam." + g for g in GROUPS),
}


def _setup(device="cpu", P=3000, h=H, w=W, seed=0):
    from gslidar_tpu_torch.engine.train import (CameraBatch,
                                                init_train_state,
                                                make_train_step)
    from gslidar_tpu_torch.models import gaussians as G
    from gslidar_tpu_torch.models.raydrop_prior import init_raydrop_prior
    from gslidar_tpu_torch.raster.settings import RasterSettings
    from gslidar_tpu_torch.scripts.bench_train_step import (
        train_bench_args, train_bench_inputs)
    args = train_bench_args()
    args["dynamic"] = True
    cfg = G.GaussianConfig(random_init_point=0)
    settings = RasterSettings(height=h, width=w, vfov=(-24.9, 2.0),
                              hfov=(-90, 90), num_extra_features=4)
    pts, colors = train_bench_inputs(P, seed)
    params, aux = G.create_from_pcd(pts, colors, None, cfg, device=device)
    state = init_train_state(params, aux, init_raydrop_prior(h, w, device))
    rng = np.random.default_rng(seed + 1)

    def plane(lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, (1, h, w)).astype(
            np.float32), device=device)
    cam = CameraBatch(viewmat=torch.eye(4, device=device),
                      campos=torch.zeros(3, device=device), timestamp=0.0,
                      towards_idx=0, pts_depth=plane(0, 8),
                      pts_intensity=plane(0, 1))
    bg = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
    step = make_train_step(args, cfg, settings, bg)
    return step, state, cam


def _step(step, state, cam):
    return step(state, cam, 7001, 3, 0.0, True)


@pytest.fixture(scope="module")
def case():
    return _setup()


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [(e.name[3:], e.time_range.start, e.time_range.end, e.thread)
                 for e in prof.events() if e.name.startswith("gs.")]


def test_step_spans_nest_under_profiler(case):
    """(a) Each span named in ``NESTING`` is in the trace once and lies
    inside its parent; the backward's layers follow one another."""
    step, state, cam = case
    _, spans = _profiled(lambda: _step(step, state, cam))
    by = {}
    for name, s, e, _ in spans:
        by.setdefault(name, []).append((s, e))
    want = set(NESTING) | {c for kids in NESTING.values() for c in kids}
    assert want <= set(by), sorted(want - set(by))
    assert len(by["step"]) == 1
    for parent, kids in NESTING.items():
        (ps, pe), = by[parent]
        for kid in kids:
            for s, e in by[kid]:
                assert ps <= s <= e <= pe, (parent, kid)
    order = [by[f"bwd.{k}"][0] for k in ("losses", "render", "activations")]
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:])), order


def test_spans_make_no_record_function_without_profiler(case, monkeypatch):
    """(b) With no profiler no record function is made and no hook is
    registered: each of them raises here, and a step runs."""
    from gslidar_tpu_torch.utils import trace

    def refuse(*a, **k):
        raise AssertionError("made while no profiler records")
    monkeypatch.setattr(trace, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.graph, "register_multi_grad_hook",
                        refuse)
    step, state, cam = case
    _, loss, _, _ = _step(step, state, cam)
    assert torch.isfinite(loss)
    assert trace.span("binning") is trace.span("binning")


def test_profiler_changes_no_gradient_bit(case):
    """(c) The gradients and the new state, with the profiler on and off,
    are equal bit for bit (one thread: the CPU's exp is not repeatable
    across thread chunkings)."""
    step, state, cam = case
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        off = _step(step, state, cam)
        on, spans = _profiled(lambda: _step(step, state, cam))
    finally:
        torch.set_num_threads(threads)
    assert any(n == "bwd.activations" for n, *_ in spans)
    (s0, l0, _, g0), (s1, l1, _, g1) = off, on
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for a, b in zip(_state_leaves(s0), _state_leaves(s1)):
        assert torch.equal(a, b)


def _state_leaves(s):
    aux = [getattr(s.aux, f.name) for f in dataclasses.fields(s.aux)]
    return [*s.params.values(), *aux, *s.opt.mu.values(),
            *s.opt.nu.values(), s.prior, *s.prior_opt[:2]]


def test_step_counts_syncs_and_instances(case):
    """(d) A step adds one ``train_steps``, its instances (the log's
    ``num_pairs``) and ``STEP_SYNCS``: ``host_syncs`` is their sum."""
    from gslidar_tpu_torch.utils.trace import counters
    step, state, cam = case
    before = counters()
    _, _, log, _ = _step(step, state, cam)
    after = counters()

    def delta(k):
        return after.get(k, 0) - before.get(k, 0)
    assert delta("train_steps") == 1
    assert delta("instances") == log["num_pairs"] > 0
    sites = {k[len("host_syncs."):]: delta(k) for k in after
             if k.startswith("host_syncs.") and delta(k)}
    assert sites == STEP_SYNCS
    assert delta("host_syncs") == sum(STEP_SYNCS.values())


def test_launch_counters_live_in_the_registry():
    """(e) The hand-written kernels' launch counts are the registry's
    ``launches.*`` counters; no function carries a ``launches`` count."""
    from gslidar_tpu_torch.microbench import dma_gather, vpu_ops
    from gslidar_tpu_torch.raster import composite_bwd, composite_fwd
    from gslidar_tpu_torch.raster import preprocess as pp
    from gslidar_tpu_torch.utils import trace
    for fn in (composite_fwd.composite_forward,
               composite_bwd.composite_backward, pp.preprocess,
               dma_gather.gather_rows, vpu_ops.op_chain):
        assert not hasattr(fn, "launches")
        assert not hasattr(fn, "backward_launches")
    before = trace.counters().get("launches.composite_fwd", 0)
    trace.count("launches.composite_fwd", 2)
    assert trace.counters()["launches.composite_fwd"] == before + 2
    trace.count("launches.composite_fwd", -2)


def _reader(name):
    sys.path.insert(0, REPO)
    from benchmark.run import Context, load_reader
    return load_reader(name), Context


@pytest.mark.parametrize("name,counter", [
    ("step.host_syncs.train", "host_syncs"),
    ("binning.instances.train", "instances")])
def test_benchmark_readers_of_the_counters(name, counter, monkeypatch):
    """The two per-layer readers: the counter per training step, nothing
    without steps or without the registry (an older program)."""
    from gslidar_tpu_torch.utils import trace
    reader, Context = _reader(name)
    ctx = Context(kind="train", profile=None)
    saved = trace.counters()
    try:
        trace.reset_counters()
        assert reader.read(ctx) is None
        trace.count("train_steps", 4)
        trace.count(counter, 24)
        assert reader.read(ctx) == 6.0
        monkeypatch.setitem(sys.modules, "gslidar_tpu_torch.utils.trace",
                            None)
        assert reader.read(ctx) is None
    finally:
        monkeypatch.undo()
        trace.reset_counters()
        for k, v in saved.items():
            trace.count(k, v)


def test_profile_iter_trace_holds_the_spans(tmp_path):
    """``train.py``'s ``profile_iter`` exports a chrome trace of 5
    iterations that holds the step's spans."""
    from gslidar_tpu_torch.train import load_args, training
    args = load_args(os.path.join(REPO, "configs", "synthetic_smoke.yaml"),
                     os.path.join(REPO, "configs", "base.yaml"),
                     ["hw=[16,64]", "num_pts=2000", "frames=4",
                      "iterations=6", "profile_iter=1", "test_iterations=[]",
                      "checkpoint_iterations=[]", "densify_until_iter=0",
                      f"model_path={tmp_path}"])
    with contextlib.redirect_stdout(None):
        training(args, "cpu")
    with open(tmp_path / "profile" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    for want in ("gs.step", "gs.step.render", "gs.binning", "gs.composite.fwd",
                 "gs.step.backward", "gs.bwd.render", "gs.composite.bwd",
                 "gs.preprocess.bwd", "gs.adam.xyz", "gs.step.prior_adam"):
        assert want in names, want


@pytest.mark.cuda
def test_card_step_counts_every_sync():
    """On the card, one step of 1M gaussians at 66x515: the syncs that
    ``torch.cuda.set_sync_debug_mode("warn")`` reports equal the step's
    ``host_syncs`` count, binning's one (``CARD_STEP_SYNCS``: the chamfer
    kernels make none); in one profiled step >= 99 % of the device time
    was launched inside the step's spans, and the backward's kernels
    inside spans on autograd's thread."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile
    from gslidar_tpu_torch.utils.trace import counters
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    step, state, cam = _setup(dev, P=1_000_000, h=66, w=515)
    for _ in range(2):
        state = _step(step, state, cam)[0]
    torch.cuda.synchronize()
    before = counters()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            state = _step(step, state, cam)[0]
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchronizing" in str(w.message)]
    after = counters()
    assert len(syncs) == after["host_syncs"] - before.get("host_syncs", 0)
    sites = {k[len("host_syncs."):]: after[k] - before.get(k, 0)
             for k in after if k.startswith("host_syncs.")
             and after[k] != before.get(k, 0)}
    assert sites == CARD_STEP_SYNCS
    assert len(syncs) == sum(CARD_STEP_SYNCS.values())

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _step(step, state, cam)
        torch.cuda.synchronize()
    events = list(prof.events())
    host = [e for e in events
            if e.device_type != torch.autograd.DeviceType.CUDA]
    spans = [(e.name, e.time_range.start, e.time_range.end, e.thread)
             for e in host if e.name.startswith("gs.")]
    kids = [(s, e) for n, s, e, _ in spans
            if n.startswith("gs.step.") and n.count(".") == 2]
    total = sum(e.time_range.end - e.time_range.start for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith("gs."))
    inside = sum(sum(k.duration for k in e.kernels) for e in host
                 if e.kernels and any(s <= e.time_range.start <= t
                                      for s, t in kids))
    assert total > 0 and inside >= 0.99 * total, (inside, total)
    main = next(t for n, _, _, t in spans if n == "gs.step")
    for name in ("gs.composite.bwd", "gs.preprocess.bwd", "gs.bwd.render"):
        assert any(n == name and t != main for n, _, _, t in spans), name
