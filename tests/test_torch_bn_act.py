"""Train-mode BatchNorm, ReLU and dropout as one op
(``gslidar_tpu_torch/models/bn_act.py``: ``BnActFn``, its kernel pair
``csrc/bn_act.cu`` and its plain version) and the U-Net's use of it
(``models/unet.py::norm_act``).

On the CPU: the plain version (``bn_act_reference``,
``bn_act_backward_reference``) against the eager
``BatchNorm`` -> ``F.relu`` -> ``_dropout`` it replaces on the card, with
ReLU on and off, dropout on and off, at planes 515, 257 and 33 wide and 1
and 3 images: the output, the keep mask, the running statistics and the
dropout generator's state after in float64 and float32, and the
gradients of x, weight and bias in float64 and, without ReLU, in float32
(with ReLU a float32 element within rounding of 0 may take the gate on
one side and not on the other, a whole gradient element apart); and in
float32 against flax's train-mode BatchNorm with and without ReLU
(``bn_act_flax.npz``, written by flax on the CPU and held to it bit for
bit by a test), gradients included, an element whose gate the
two decide on opposite sides within rounding of 0 accounted for in closed
form. ``BnActFn`` refuses a CPU tensor and dropout without ReLU; on the
CPU ``norm_act`` is the eager path bit for bit and launches nothing;
``microbench/bounds.py::bn_act_bound``'s arithmetic.

On the card (``-m cuda``, an H100): the kernels against the plain version
on the card at each of the 18 BatchNorm shapes of the refine cell at B =
2, and at ``ups.3``'s at B = 60, with a constant channel (its variance
round-off, clipped or not): the keep mask and the clip flags bit for bit,
the output, the saved statistics, the running statistics and the
gradients within a few float32 roundings (the two take their float64
sums in different orders); one launch each way; x, u or dy that starts
off the kernels' 16-byte alignment is refused with an error. An epoch
of ``refine_epoch`` at B = 2 panoramas of 66x1030: 18 forward and 18
backward launches at the 18 shapes, the box mask's copy the only host
sync, the dropout generator's state after equal to the eager path's (the
same U-Net in float64, which keeps the eager ops on the card) and its
loss within float32 rounding of it. Under ``torch.profiler`` the
launches are linked to ``gs.bn_act`` and ``gs.bn_act.bwd``. The kernels
against flax's train-mode BatchNorm through ``bn_act_flax.npz``, by the
CPU comparison's bars.
"""

import hashlib
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

# (C, H, W, relu, p) of each BatchNorm of the U-Net at 66x1030, in the
# order the forward meets them: downs.0-3 (bn0, bn1 each), attn.bn,
# ups.0-3 (bn0, bn1 each), bn
CELL_SHAPES = [
    (32, 33, 515, True, 0.1), (64, 33, 515, True, 0.1),
    (64, 16, 257, True, 0.1), (128, 16, 257, True, 0.1),
    (128, 8, 128, True, 0.1), (256, 8, 128, True, 0.1),
    (256, 4, 64, True, 0.1), (256, 4, 64, True, 0.1),
    (256, 4, 64, False, 0.0),
    (512, 8, 128, True, 0.1), (512, 8, 128, True, 0.1),
    (256, 16, 257, True, 0.1), (256, 16, 257, True, 0.1),
    (128, 33, 515, True, 0.1), (128, 33, 515, True, 0.1),
    (64, 66, 1030, True, 0.1), (64, 66, 1030, True, 0.1),
    (32, 66, 1030, True, 0.0),
]


def _inputs(shape, dtype, device, seed, constant_channel=False):
    """x with a mean and a spread of its own per channel (the statistics'
    cancellation at work), weight, bias, running statistics and dy."""
    g = torch.Generator().manual_seed(seed)
    B, C, H, W = shape
    mean = 3.0 * torch.randn(C, 1, 1, generator=g, dtype=torch.float64)
    spread = 0.5 + torch.rand(C, 1, 1, generator=g, dtype=torch.float64)
    x = mean + spread * torch.randn(shape, generator=g, dtype=torch.float64)
    if constant_channel:
        x[:, 0] = 0.1
    w = 1.0 + 0.3 * torch.randn(C, generator=g, dtype=torch.float64)
    b = 0.2 * torch.randn(C, generator=g, dtype=torch.float64)
    rm = 0.1 * torch.randn(C, generator=g, dtype=torch.float64)
    rv = 1.0 + torch.rand(C, generator=g, dtype=torch.float64)
    dy = torch.randn(shape, generator=g, dtype=torch.float64)
    return [t.to(device, dtype) for t in (x, w, b, rm, rv, dy)]


def _close(got, want, rel, what):
    got, want = got.detach(), want.detach()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * max(scale, 1e-30), (what, err, scale)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(1, 4, 3, 515), (3, 5, 2, 257),
                                   (3, 6, 5, 33)])
@pytest.mark.parametrize("relu,p", [(True, 0.1), (True, 0.0), (False, 0.0),
                                    (False, 0.1)])
def test_plain_version_is_eager_batchnorm_relu_dropout(relu, p, shape,
                                                       dtype):
    """The plain version (``bn_act_reference``, then
    ``bn_act_backward_reference``) against the eager module and ops on the
    same inputs and dropout generator, each tensor within a share of its
    largest element. float64: 1e-12, forward and gradients
    (the plain version sums in float64 and takes the closed-form gradient,
    eager autograd goes through E[x^2] and E[x]^2 apart: ~6e-16 read).
    float32: 5e-5 forward and 1e-4 for the gradients, only without ReLU
    (the eager float32 variance cancels E[x^2] against E[x]^2, up to
    ~40 / 0.25 here: ~7e-6 read)."""
    from gslidar_tpu_torch.models.bn_act import (bn_act_backward_reference,
                                                 bn_act_reference)
    from gslidar_tpu_torch.models.unet import BatchNorm, _dropout
    x, w, b, rm, rv, dy = _inputs(shape, dtype, "cpu", seed=sum(shape))
    bn = BatchNorm(shape[1]).to(dtype).train()
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
        bn.running_mean.copy_(rm)
        bn.running_var.copy_(rv)
    ge, gp = (torch.Generator().manual_seed(7) for _ in range(2))
    xe = x.clone().requires_grad_()
    ye = bn(xe)
    if relu:
        ye = F.relu(ye)
    if p > 0:
        ye = _dropout(ye, p, ge)
    (ye * dy).sum().backward()

    rmp, rvp = rm.clone(), rv.clone()
    u = torch.rand(x.shape, generator=gp) if p > 0 else None
    yp, keep, saved = bn_act_reference(x, w, b, rmp, rvp, u, relu, p)
    dxp, dwp, dbp = bn_act_backward_reference(dy, x, w, b, saved, keep,
                                              relu, p)

    fwd = 1e-12 if dtype == torch.float64 else 5e-5
    _close(yp, ye, fwd, "y")
    assert torch.equal(yp == 0, ye == 0) or relu
    _close(rmp, bn.running_mean, fwd, "running_mean")
    _close(rvp, bn.running_var, fwd, "running_var")
    assert torch.equal(gp.get_state(), ge.get_state())
    if dtype == torch.float64 or not relu:
        grad = 1e-12 if dtype == torch.float64 else 1e-4
        _close(dxp, xe.grad, grad, "dx")
        _close(dwp, bn.weight.grad, grad, "dweight")
        _close(dbp, bn.bias.grad, grad, "dbias")


# flax's train-mode BatchNorm (``nn.BatchNorm(use_running_average=False)``
# with its defaults, as the JAX package's U-Net builds each one), with and
# without ``nn.relu`` after it, on ``_numpy_case``'s float32 inputs at the
# attention block's shape (256 channels of 4x64, also downs.3's and
# ups.0's) at B = 2: the output, the moved running statistics and, for
# the cotangent dy, the gradients of x, scale and bias; under
# "<relu>.<what>", and the sha256 of the inputs under "inputs". Written by
# ``_write_flax_golden``:
#   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_bn_act.py
FLAX_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "bn_act_flax.npz")
FLAX_SHAPE = (2, 256, 4, 64)
FLAX_KEYS = ("y", "mean", "var", "dx", "dweight", "dbias")


def _numpy_case():
    """Float32 (x, weight, bias, running mean, running var, dy) NCHW of
    FLAX_SHAPE, drawn as ``_inputs`` draws them, from numpy's legacy
    ``RandomState``, whose stream numpy keeps the same across versions."""
    rs = np.random.RandomState(25)
    C = FLAX_SHAPE[1]
    mean = 3.0 * rs.standard_normal((C, 1, 1))
    spread = 0.5 + rs.random_sample((C, 1, 1))
    x = mean + spread * rs.standard_normal(FLAX_SHAPE)
    w = 1.0 + 0.3 * rs.standard_normal(C)
    b = 0.2 * rs.standard_normal(C)
    rm = 0.1 * rs.standard_normal(C)
    rv = 1.0 + rs.random_sample(C)
    dy = rs.standard_normal(FLAX_SHAPE)
    return [a.astype(np.float32) for a in (x, w, b, rm, rv, dy)]


def _case_sha256():
    h = hashlib.sha256()
    for a in _numpy_case():
        h.update(a.tobytes())
    return h.hexdigest()


def _flax_bn(relu):
    """flax's train-mode BatchNorm (then ``nn.relu`` where ``relu``) on
    ``_numpy_case``, on the CPU: {FLAX_KEYS: numpy arrays, NCHW}."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    x, w, b, rm, rv, dy = _numpy_case()
    bn = nn.BatchNorm(use_running_average=False)

    def nhwc(a):
        return jnp.asarray(a.transpose(0, 2, 3, 1))

    def f(x, scale, bias):
        y, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                           "batch_stats": {"mean": jnp.asarray(rm),
                                           "var": jnp.asarray(rv)}},
                          x, mutable=["batch_stats"])
        return (nn.relu(y) if relu else y), upd["batch_stats"]
    y, vjp, stats = jax.vjp(f, nhwc(x), jnp.asarray(w), jnp.asarray(b),
                            has_aux=True)
    dx, dw, db = vjp(nhwc(dy))

    def nchw(a):
        return np.asarray(a).transpose(0, 3, 1, 2)
    return dict(y=nchw(y), mean=np.asarray(stats["mean"]),
                var=np.asarray(stats["var"]), dx=nchw(dx),
                dweight=np.asarray(dw), dbias=np.asarray(db))


def _write_flax_golden(path=FLAX_GOLDEN):
    out = {"inputs": np.array(_case_sha256())}
    for relu in (False, True):
        for k, v in _flax_bn(relu).items():
            out[f"{relu}.{k}"] = v
    np.savez_compressed(path, **out)


def _flax_golden(relu):
    """``bn_act_flax.npz``'s case ``relu``, after checking that
    ``_numpy_case`` still draws its inputs."""
    with np.load(FLAX_GOLDEN) as f:
        assert str(f["inputs"]) == _case_sha256()
        return {k: f[f"{relu}.{k}"] for k in FLAX_KEYS}


def _gate_corrected(golden, y, relu):
    """flax's gradients with ReLU's gate taken where ``y`` (the op's
    output on ``_numpy_case``) has it. Where flax's pre-activation t lies
    within rounding of 0 the two float32 computations may decide the gate
    on opposite sides: such an element's gradient g is dy on one side and
    0 on the other, and the train-mode gradient moves by that through the
    batch mean and variance in closed form (float64). A flip farther
    from 0 than 1e-4 of the largest |t| is a fault, not rounding."""
    if not relu:
        return golden
    x, w, b, _, _, dy = (a.astype(np.float64) for a in _numpy_case())
    t = _flax_golden(False)["y"]
    mine, theirs = np.asarray(y.cpu()) > 0, golden["y"] > 0
    flips = mine != theirs
    assert np.all(np.abs(t[flips]) <= 1e-4 * np.abs(t).max()), \
        np.abs(t[flips]).max()
    delta = np.where(flips, np.where(mine, dy, -dy), 0.0)
    axes = (0, 2, 3)
    n = x.size // x.shape[1]
    mean = x.mean(axes, keepdims=True)
    rstd = 1.0 / np.sqrt(x.var(axes, keepdims=True) + 1e-5)
    xhat = (x - mean) * rstd
    sd, sdx = delta.sum(axes), (delta * xhat).sum(axes)
    mul = (w * rstd.ravel())[:, None, None]
    dx = golden["dx"] + mul * (delta - (sd / n)[:, None, None]
                               - xhat * (sdx / n)[:, None, None])
    return dict(golden, dx=dx, dweight=golden["dweight"] + sdx,
                dbias=golden["dbias"] + sd)


def _hold_to_flax(relu, y, rm, rv, dx, dw, db):
    """The op's outputs on ``_numpy_case`` against flax's
    (``bn_act_flax.npz``), each within a share of its largest element:
    5e-5 forward and running statistics, 1e-4 the gradients (those of
    the float32 eager comparison: flax's float32 variance cancels E[x^2]
    against E[x]^2, ~1.9e-5 of y read, ~2.6e-5 of dx)."""
    want = _gate_corrected(_flax_golden(relu), y, relu)
    got = dict(y=y, mean=rm, var=rv, dx=dx, dweight=dw, dbias=db)
    for k in FLAX_KEYS:
        bar = 5e-5 if k in ("y", "mean", "var") else 1e-4
        _close(got[k].double().cpu(), torch.as_tensor(want[k]).double(),
               bar, k)


@pytest.mark.parametrize("relu", [False, True])
def test_flax_golden_is_flaxs(relu):
    """``bn_act_flax.npz`` holds, bit for bit, what flax's train-mode
    BatchNorm (and ReLU) gives now on ``_numpy_case``."""
    want = _flax_golden(relu)
    got = _flax_bn(relu)
    for k in FLAX_KEYS:
        assert got[k].dtype == want[k].dtype == np.float32
        assert np.array_equal(got[k].view(np.int32),
                              want[k].view(np.int32)), k


@pytest.mark.parametrize("relu", [False, True])
def test_plain_version_is_flax_batchnorm(relu):
    """The plain version in float32 against flax's train-mode BatchNorm,
    with and without ReLU (``_hold_to_flax``): its float64 sums, the
    clip flag and the closed-form backward held to the JAX package's
    module, which the card's test holds the kernels to as well."""
    from gslidar_tpu_torch.models.bn_act import (bn_act_backward_reference,
                                                 bn_act_reference)
    x, w, b, rm, rv, dy = (torch.as_tensor(a) for a in _numpy_case())
    y, keep, saved = bn_act_reference(x, w, b, rm, rv, None, relu, 0.0)
    assert torch.equal(saved[2], torch.ones_like(saved[2]))
    _hold_to_flax(relu, y, rm, rv, *bn_act_backward_reference(
        dy, x, w, b, saved, keep, relu, 0.0))


@pytest.mark.parametrize("relu", [True, False])
def test_kernels_refuse_the_cpu_and_dropout_without_relu(relu):
    """``BnActFn`` runs only the kernels: a CPU tensor, and dropout
    without ReLU (no layer of the U-Net has it, and the kernels are not
    built for it), are refused before any launch."""
    from gslidar_tpu_torch.models.bn_act import BnActFn
    from gslidar_tpu_torch.utils.trace import counters
    x = torch.zeros(2, 3, 4, 8)
    c = torch.ones(3)
    before = counters()
    with pytest.raises(ValueError, match="CUDA tensors" if relu else
                       "dropout only after ReLU"):
        BnActFn.apply(x, c, c, c.clone(), c.clone(), torch.rand_like(x),
                      relu, 0.1)
    assert counters() == before


def test_norm_act_on_the_cpu_is_the_eager_path():
    """In training on the CPU ``norm_act`` is ``bn``, ``F.relu`` and
    ``_dropout`` bit for bit, gradients included, and launches nothing."""
    from gslidar_tpu_torch.models.unet import BatchNorm, _dropout, norm_act
    from gslidar_tpu_torch.utils.trace import counters
    x, *_ = _inputs((2, 3, 4, 33), torch.float32, "cpu", seed=1)
    outs = []
    for fused in (True, False):
        bn = BatchNorm(3).train()
        g = torch.Generator().manual_seed(3)
        xi = x.clone().requires_grad_()
        before = counters()
        if fused:
            y = norm_act(bn, xi, True, 0.1, g)
            assert counters() == before
        else:
            y = _dropout(F.relu(bn(xi)), 0.1, g)
        y.square().sum().backward()
        outs.append((y, xi.grad, bn.weight.grad, bn.running_var))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_bn_act_bound_arithmetic():
    """``bn_act_bound``: 13 bytes an element each way with dropout, 8 and
    12 without, over 3.35 TB/s."""
    from gslidar_tpu_torch.microbench.bounds import bn_act_bound
    n = 522_014_400
    f, b = bn_act_bound(n, True)
    assert f.by == b.by == "bytes"
    assert f.ms == pytest.approx(n * 13 / 3.35e12 * 1e3)
    assert b.ms == pytest.approx(n * 13 / 3.35e12 * 1e3)
    f, b = bn_act_bound(n, False)
    assert (f.ms, b.ms) == pytest.approx((n * 8 / 3.35e9, n * 12 / 3.35e9))


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    """The card, with TF32 off; after the test the allocator's cached
    blocks go back to the card (an epoch caches cuDNN's 32 GiB
    weight-gradient workspace), so that card tests run after these in
    one process, or in a process of their own beside it, find the
    memory free."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.cuda.empty_cache()


def _launches():
    from gslidar_tpu_torch.utils.trace import counters
    c = counters()
    return c.get("launches.bn_act_fwd", 0), c.get("launches.bn_act_bwd", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,H,W,relu,p", [
    (2, *s) for s in CELL_SHAPES] + [(60, *CELL_SHAPES[-2])])
def test_card_kernels_are_the_plain_version(cuda_device, B, C, H, W, relu,
                                            p):
    """The kernel pair against the plain version on the card: the keep
    mask bit for bit, the rest within a few float32 roundings (2e-6 of
    the largest forward, 1e-5 for the gradients); one launch each way."""
    from gslidar_tpu_torch.models.bn_act import (
        bn_act_backward_kernel, bn_act_backward_reference, bn_act_kernel,
        bn_act_reference)
    x, w, b, rm, rv, dy = _inputs((B, C, H, W), torch.float32, cuda_device,
                                  seed=B * C + H, constant_channel=True)
    g = torch.Generator(device=cuda_device).manual_seed(C)
    u = torch.rand(x.shape, generator=g, device=cuda_device) if p > 0 \
        else None
    rmk, rvk = rm.clone(), rv.clone()
    launched = _launches()
    yk, keepk, savedk = bn_act_kernel(x, w, b, rmk, rvk, u, relu, p)
    dk = bn_act_backward_kernel(dy, x, w, b, savedk, keepk, relu, p)
    torch.cuda.synchronize()
    assert _launches() == (launched[0] + 1, launched[1] + 1)
    yp, keepp, savedp = bn_act_reference(x, w, b, rm, rv, u, relu, p)
    dp = bn_act_backward_reference(dy, x, w, b, savedp, keepp, relu, p)
    if p > 0:
        assert torch.equal(keepk, keepp)
        assert torch.equal(keepk.bool(), u >= p)
    else:
        assert keepk is None
    _close(savedk[:2], savedp[:2], 2e-6, "mean, rstd")
    # the constant channel's variance is float64 round-off of either
    # sign, so its clip acts on one side and not on the other (where x is
    # its mean, xhat is 0 and the gradient does not see it)
    assert torch.equal(savedk[2, 1:], savedp[2, 1:])
    assert float(savedk[2, 0]) in (0.0, 1.0)
    _close(yk, yp, 2e-6, "y")
    _close(rmk, rm, 2e-6, "running_mean")
    _close(rvk, rv, 2e-6, "running_var")
    for got, want, what in zip(dk, dp, ("dx", "dweight", "dbias")):
        _close(got, want, 1e-5, what)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["x", "u", "dy"])
def test_card_kernels_refuse_a_view_off_their_alignment(cuda_device,
                                                        which):
    """The kernels load 16 bytes at a time: x, u or dy starting 4 bytes
    into its storage is refused with an error, not read wrong."""
    from gslidar_tpu_torch.models.bn_act import (bn_act_backward_kernel,
                                                 bn_act_kernel)
    shape = (2, 8, 33, 515)
    x, w, b, rm, rv, dy = _inputs(shape, torch.float32, cuda_device, seed=3)
    u = torch.rand(shape, device=cuda_device)
    buf = torch.empty(x.numel() + 1, device=cuda_device)
    off = buf[1:].view(shape)
    off.copy_({"x": x, "u": u, "dy": dy}[which])
    x, u, dy = (off if which == k else t for k, t in
                (("x", x), ("u", u), ("dy", dy)))
    with pytest.raises(RuntimeError, match="bn_act_(fwd|bwd) kernel launch"):
        y, keep, saved = bn_act_kernel(x, w, b, rm, rv, u, True, 0.1)
        bn_act_backward_kernel(dy, x, w, b, saved, keep, True, 0.1)


@pytest.mark.cuda
def test_card_epoch_launches_syncs_and_draws(cuda_device, monkeypatch):
    """One ``refine_epoch`` at B = 2 panoramas of 66x1030: the op at the
    18 shapes of ``CELL_SHAPES`` in order, 18 launches each way, the box
    mask's the only host sync; the dropout generator's state after equals
    the eager path's (the same seeds in float64) and the loss is within
    1e-5 of it."""
    import numpy as np
    from gslidar_tpu_torch.engine.refine import adam, refine_epoch
    from gslidar_tpu_torch.models import bn_act
    from gslidar_tpu_torch.models.unet import UNet, init_unet
    from gslidar_tpu_torch.utils.trace import counters
    seen = []
    apply = bn_act.BnActFn.apply

    def record(x, *args):
        seen.append((tuple(x.shape), args[-2], args[-1]))
        return apply(x, *args)
    monkeypatch.setattr(bn_act.BnActFn, "apply", record)
    g = torch.Generator().manual_seed(5)
    x = torch.rand(2, 3, 66, 1030, generator=g).to(cuda_device)
    y = (torch.rand(2, 1, 66, 1030, generator=g) < 0.3).float().to(
        cuda_device)
    runs = []
    for dtype in (torch.float32, torch.float64):
        model = init_unet(UNet(), torch.Generator().manual_seed(9)).to(
            cuda_device, dtype).train()
        drop = torch.Generator(device=cuda_device).manual_seed(9)
        before = counters()
        loss = refine_epoch(model, adam(model), x.to(dtype), y.to(dtype),
                            np.random.default_rng(9), 0, 1000, drop)
        torch.cuda.synchronize()
        made = {k: v - before.get(k, 0) for k, v in counters().items()
                if v != before.get(k, 0)}
        runs.append((float(loss), drop.get_state(), made))
    (l32, s32, m32), (l64, s64, m64) = runs
    assert seen == [((2, c, h, w), relu, p) for c, h, w, relu, p in
                    CELL_SHAPES]
    assert m32 == {"refine_epochs": 1, "host_syncs": 1,
                   "host_syncs.refine_mask": 1, "launches.bn_act_fwd": 18,
                   "launches.bn_act_bwd": 18}
    assert m64 == {"refine_epochs": 1, "host_syncs": 1,
                   "host_syncs.refine_mask": 1}
    assert torch.equal(s32, s64)
    assert abs(l32 - l64) <= 1e-5 * abs(l64)


@pytest.mark.cuda
def test_card_profiler_links_the_launches_to_their_spans(cuda_device):
    """Under ``torch.profiler`` the forward's two kernels are linked to
    ``gs.bn_act`` and the backward's two to ``gs.bn_act.bwd``, which opens
    on autograd's thread, so the benchmark's readers of the work launched
    inside ``unet_loss`` and ``torch.autograd.backward`` find them."""
    from torch.profiler import ProfilerActivity, profile
    from gslidar_tpu_torch.models.bn_act import BnActFn
    x, w, b, rm, rv, dy = _inputs((2, 64, 33, 515), torch.float32,
                                  cuda_device, seed=4)
    x.requires_grad_()
    u = torch.rand(x.shape, device=cuda_device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        BnActFn.apply(x, w, b, rm, rv, u, True, 0.1).backward(dy)
        torch.cuda.synchronize()
    linked = {name: [k.name for e in prof.events() if e.name == name
                     for k in e.kernels]
              for name in ("gs.bn_act", "gs.bn_act.bwd")}
    for name, kernels in (("gs.bn_act", ("fwd_stats", "fwd_apply")),
                          ("gs.bn_act.bwd", ("bwd_reduce", "bwd_apply"))):
        got = linked[name]
        assert len(got) == 2 and all(any(f"{k}_kernel" in n for n in got)
                                     for k in kernels), linked


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
def test_card_kernels_are_flax_batchnorm(cuda_device, relu):
    """The kernel pair on the card against flax's train-mode BatchNorm,
    with and without ReLU, on ``_numpy_case`` (``bn_act_flax.npz``, so the
    card needs no JAX), by ``_hold_to_flax``'s bars."""
    from gslidar_tpu_torch.models.bn_act import (bn_act_backward_kernel,
                                                 bn_act_kernel)
    x, w, b, rm, rv, dy = (torch.as_tensor(a).to(cuda_device)
                           for a in _numpy_case())
    y, keep, saved = bn_act_kernel(x, w, b, rm, rv, None, relu, 0.0)
    dx, dw, db = bn_act_backward_kernel(dy, x, w, b, saved, keep, relu, 0.0)
    torch.cuda.synchronize()
    assert keep is None
    assert torch.equal(saved[2], torch.ones_like(saved[2]))
    _hold_to_flax(relu, y, rm, rv, dx, dw, db)


if __name__ == "__main__":
    _write_flax_golden()
