"""The ray-drop refinement's epoch (``engine/refine.py``'s ``refine_epoch``)
on the CPU:

* against the benchmark's plain reference (``benchmark/reference/
  unet.py``) on the same seeded weights, box masks and dropout draws, at
  B = 3 panoramas of 16x128 over 3 epochs, both in float64: the loss, the
  gradient of every parameter, the BatchNorm running statistics and the
  parameters after each epoch;
* ``refine``'s loop, the epoch callable and the loop as it was written
  before the epoch was factored out give the same weights bit for bit;
* a profiled epoch holds the ``gs.refine.*``, ``gs.unet.*`` and
  ``gs.bwd.unet.*`` spans, nested as ``utils/trace.py`` says, and counts
  one ``refine_epochs`` and one host sync, at ``refine_mask``; the
  profiler changes no bit of the epoch;
* the benchmark's readers of the refine cell's per-layer metrics.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

B, H, W2 = 3, 16, 128
EPOCHS = 1000


def _batch(seed):
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.rand(B, 3, H, W2, generator=g)
    y = (torch.rand(B, 1, H, W2, generator=g) < 0.3).to(torch.float32)
    return x, y


def _program(seed, dtype=torch.float32):
    """The port's U-Net, Adam, box-mask rng and dropout generator as the
    benchmark's refine kind builds them from ``seed``."""
    from gslidar_tpu_torch.engine.refine import adam
    from gslidar_tpu_torch.models.unet import UNet, init_unet
    model = init_unet(UNet(), torch.Generator().manual_seed(seed))
    model = model.to(dtype).train()
    return (model, adam(model), np.random.default_rng(seed),
            torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 24])
def test_epochs_match_the_reference_in_float64(seed):
    """Both sides in float64 agree to round-off (~1e-15 relative; in
    float32 the gradients carry ~1e-2 relative noise at this
    initialisation, each side its own, as tests/test_torch_refine.py
    says, so float32 cannot be held this tight): the loss to 1e-12 relative, each gradient to 1e-9 of the
    larger of its tensor's largest element and a thousandth of the
    largest gradient (the input conv's bias feeds only BatchNorms: its
    gradient is round-off on both sides), the running statistics to
    1e-11 of each tensor's largest (the variance E[x^2] - E[x]^2 cancels:
    ~1.5e-13 read), the parameters to 1e-10 absolute
    (Adam divides by the root of the second moment plus 1e-8, which turns
    round-off of a gradient near 1e-8 into ~1e-12 of an update)."""
    from benchmark.reference import unet as R
    from gslidar_tpu_torch.engine.refine import refine_epoch
    model, opt, rng, gen = _program(seed, torch.float64)
    p0, s0 = R.init_params(seed)
    named = dict(model.named_parameters())
    assert set(named) == set(p0)
    for k, v in p0.items():
        assert torch.equal(named[k].float(), v), k
    assert set(dict(model.named_buffers())) == set(s0)
    x, y = _batch(seed)
    ref = R.Run(x, y, seed, EPOCHS, dtype=torch.float64)
    x64, y64 = x.double(), y.double()
    for i in range(3):
        loss = float(refine_epoch(model, opt, x64, y64, rng, i, EPOCHS,
                                  gen).detach())
        loss_r, _, grads = ref.epoch()
        assert abs(loss - loss_r) <= 1e-12 * abs(loss_r), i
        gmax = max(float(g.abs().max()) for g in grads.values())
        for k, p in model.named_parameters():
            scale = max(float(grads[k].abs().max()), 1e-3 * gmax)
            assert float((p.grad - grads[k]).abs().max()) <= 1e-9 * scale, \
                (i, k)
            assert float((p.detach() - ref.p[k].detach()).abs().max()) \
                <= 1e-10, (i, k)
        for k, b in model.named_buffers():
            r = ref.s[k]
            assert float((b - r).abs().max()) <= 1e-11 * float(
                r.abs().max()), (i, k)
    assert gen.get_state().equal(ref.g.get_state())


def test_box_masks_and_schedule_match_the_reference():
    """The box masks drawn from one ``default_rng`` seed, and the one-cycle
    rate at every update of 1000, are the reference's bit for bit."""
    from benchmark.reference import unet as R
    from gslidar_tpu_torch.engine.refine import _onecycle_lr, box_mask
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(20):
        assert np.array_equal(box_mask(a, 66, 1030), R.box_mask(b, 66, 1030))
    assert [_onecycle_lr(i, EPOCHS) for i in range(EPOCHS)] == \
        [R.onecycle_lr(i, EPOCHS) for i in range(EPOCHS)]


def _dataset(root, seed=3, n=2):
    """``ray_drop_datasets/`` of ``n`` train renders and their GT at 16x64
    halves."""
    rng = np.random.default_rng(seed)
    for sub in ("gt", "render_train"):
        os.makedirs(os.path.join(root, "ray_drop_datasets", sub))
    for i in range(n):
        drop = (rng.uniform(0, 1, (1, 16, 128)) < 0.25).astype(np.float32)
        gt = np.concatenate([drop, rng.uniform(0, 1, (2, 16, 128))])
        render = rng.uniform(0, 1, (3, 16, 128)).astype(np.float32)
        for sub, arr in (("gt", gt), ("render_train", render)):
            np.save(os.path.join(root, "ray_drop_datasets", sub,
                                 f"{i:03d}.npy"), arr)
    x = torch.as_tensor(np.stack([np.load(os.path.join(
        root, "ray_drop_datasets", "render_train", f"{i:03d}.npy"))
        for i in range(n)]))
    y = torch.as_tensor(np.stack([np.load(os.path.join(
        root, "ray_drop_datasets", "gt", f"{i:03d}.npy"))[[0]]
        for i in range(n)]), dtype=torch.float32)
    return x, y


def test_refine_loop_is_the_epoch_callable(tmp_path):
    """``refine``'s weights after 3 epochs equal, bit for bit, those of
    ``refine_epoch`` called 3 times from the same seeds and those of the
    loop as it was before the epoch was factored out (a box mask, then
    ``refine_step`` at the epoch's rate, inside ``full_f32``); ``refine``
    counts its epochs, their masks' syncs and the printed loss's."""
    from gslidar_tpu_torch.config import Config
    from gslidar_tpu_torch.engine.refine import (_onecycle_lr, box_mask,
                                                 refine, refine_epoch,
                                                 refine_step)
    from gslidar_tpu_torch.raster.preprocess import full_f32
    from gslidar_tpu_torch.utils.trace import counters
    x, y = _dataset(str(tmp_path))
    args = Config({"model_path": str(tmp_path), "refine_epochs": 3})
    before = counters()
    model, printed = refine(args, "cpu")
    made = {k: v - before.get(k, 0) for k, v in counters().items()}
    assert [i for i, _ in printed] == [0]
    assert made["refine_epochs"] == 3
    assert made["host_syncs.refine_mask"] == 3
    assert made["host_syncs.refine_print"] == 1
    assert made["host_syncs"] == 4

    epoch = _program(0)
    for i in range(3):
        refine_epoch(*epoch[:2], x, y, epoch[2], i, 3, epoch[3])
    old, opt, rng, gen = _program(0)
    with full_f32():
        for i in range(3):
            mask = torch.as_tensor(box_mask(rng, H, W2))
            refine_step(old, opt, x, y, mask, _onecycle_lr(i, 3), gen)
    want = model.state_dict()
    for other in (epoch[0], old):
        got = other.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k


NESTING = {
    "refine.epoch": ["refine.mask", "refine.forward", "refine.loss",
                     "refine.backward", "refine.adam"],
    "refine.mask": ["sync.refine_mask"],
    "refine.forward": ["unet.down", "unet.attn", "unet.up", "unet.out"],
    "refine.backward": ["bwd.unet.out", "bwd.unet.up", "bwd.unet.attn",
                        "bwd.unet.down"],
}


def _epoch(profiled):
    from gslidar_tpu_torch.engine.refine import refine_epoch
    from torch.profiler import ProfilerActivity, profile
    model, opt, rng, gen = _program(7)
    x, y = _batch(7)
    if not profiled:
        return model, refine_epoch(model, opt, x, y, rng, 0, EPOCHS, gen), []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss = refine_epoch(model, opt, x, y, rng, 0, EPOCHS, gen)
    return model, loss, [(e.name[3:], e.time_range.start, e.time_range.end)
                         for e in prof.events() if e.name.startswith("gs.")]


def test_profiled_epoch_shows_its_spans_and_counts():
    """Each span of ``NESTING`` is in the trace once and inside its
    parent, the backward's stages in the order autograd meets them; the
    epoch adds 1 to ``refine_epochs`` and one host sync, the mask's."""
    from gslidar_tpu_torch.utils.trace import counters
    before = counters()
    _, loss, spans = _epoch(True)
    made = {k: v - before.get(k, 0) for k, v in counters().items()
            if v != before.get(k, 0)}
    assert torch.isfinite(loss)
    assert made == {"refine_epochs": 1, "host_syncs": 1,
                    "host_syncs.refine_mask": 1}
    by = {}
    for name, s, e in spans:
        by.setdefault(name, []).append((s, e))
    want = set(NESTING) | {k for kids in NESTING.values() for k in kids}
    assert want <= set(by), sorted(want - set(by))
    for parent, kids in NESTING.items():
        (ps, pe), = by[parent]
        for kid in kids:
            (s, e), = by[kid]
            assert ps <= s <= e <= pe, (parent, kid)
    order = [by[k][0] for k in NESTING["refine.backward"]]
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:])), order


def test_profiler_changes_no_bit_of_the_epoch():
    """The loss, the gradients and the weights after an epoch, with the
    profiler on and off, are equal bit for bit (one thread: the CPU's
    kernels are not repeatable across thread chunkings)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        off, on = _epoch(False), _epoch(True)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(off[1], on[1])
    for (k, a), (_, b) in zip(off[0].named_parameters(),
                              on[0].named_parameters()):
        assert torch.equal(a, b) and torch.equal(a.grad, b.grad), k


def _reader(name):
    from benchmark.run import Context, load_reader
    return load_reader(name), Context


def test_reader_of_the_host_syncs_per_epoch(monkeypatch):
    """``refine.host_syncs.refine``: the counters' host syncs per epoch;
    nothing without epochs or without the registry (an older program)."""
    from gslidar_tpu_torch.utils import trace
    reader, Context = _reader("refine.host_syncs.refine")
    ctx = Context(kind="refine", profile=None)
    saved = trace.counters()
    try:
        trace.reset_counters()
        assert reader.read(ctx) is None
        trace.count("refine_epochs", 4)
        trace.count("host_syncs", 5)
        assert reader.read(ctx) == 1.25
        monkeypatch.setitem(sys.modules, "gslidar_tpu_torch.utils.trace",
                            None)
        assert reader.read(ctx) is None
    finally:
        monkeypatch.undo()
        trace.reset_counters()
        for k, v in saved.items():
            trace.count(k, v)


@pytest.mark.parametrize("name,span", [
    ("refine.fwd_ms.refine", "refine.forward"),
    ("refine.bwd_ms.refine", "refine.backward"),
    ("refine.adam_ms.refine", "refine.adam")])
def test_readers_of_the_epoch_spans(name, span):
    """Device ms per epoch launched inside the span (on any thread), and
    nothing without a trace or without work in the span."""
    from benchmark.tracing import Profile
    reader, Context = _reader(name)
    assert reader.read(Context(profile=None)) is None
    spans = [("stretch", 0, 100), ("call", 0, 50), ("call", 50, 100),
             (span, 10, 20), (span, 60, 70), ("other", 30, 40)]
    launches = [(12, 2e-3), (65, 4e-3), (35, 8e-3)]
    prof = Profile(units=2, wall_s=1.0, busy_s=0.5, device_ops=[], gaps={},
                   launches=launches, spans=spans)
    assert reader.read(Context(profile=prof)) == pytest.approx(3.0)
    empty = prof._replace(launches=[(35, 8e-3)])
    assert reader.read(Context(profile=empty)) is None


def test_reader_of_the_epoch_mfu():
    """The epoch's least time over the window's time per epoch, in %."""
    from benchmark import refine_counts
    reader, Context = _reader("refine.epoch_mfu")
    work = refine_counts.epoch_work(60, 66, 1030)
    assert reader.read(Context(work=None, calls=3, window_s=1.0)) is None
    assert reader.read(Context(work=work, calls=0, window_s=1.0)) is None
    got = reader.read(Context(work=work, calls=10, window_s=10.0))
    assert got == pytest.approx(100 * work.least_s())
