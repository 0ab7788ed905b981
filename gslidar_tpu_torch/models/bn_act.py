"""Train-mode BatchNorm, then an optional ReLU, then an optional dropout,
as one differentiable op: ``BnActFn``.

The ray-drop refinement U-Net (``models/unet.py``) follows each of its
BatchNorms in training by ReLU and dropout (a DoubleConv's), by ReLU
alone (the output's) or by neither (the attention block's). Written as
eager ops (``unet.BatchNorm``, ``F.relu``, ``unet._dropout``) that is
some twenty elementwise passes and reductions forward and as many
backward; ``norm_act`` in ``models/unet.py`` takes this op instead for a
float32 CUDA tensor in training; everywhere else it keeps the eager
module and ops.

The forward and the backward are each one launch of csrc/bn_act.cu's
kernel pair (a statistics pass, then the pass that writes y; a
reduction, then the pass that writes dx), counted as
``launches.bn_act_fwd`` and ``launches.bn_act_bwd`` and launched inside
the spans ``bn_act`` and ``bn_act.bwd`` (``utils/trace.py``); the op
takes CUDA tensors only, and dropout only after ReLU, as every layer of
the U-Net has it. ``bn_act_reference`` and ``bn_act_backward_reference``
are its plain version: the kernels' arithmetic in torch ops, the
kernels' oracle, itself held by the tests to the eager module and to
flax's train-mode BatchNorm.

What stays as the eager module has it:

* the statistics are flax's: the batch mean and the biased variance
  E[x^2] - E[x]^2 clipped at 0, eps 1e-5; the running statistics move by
  ``BN_MOMENTUM`` towards them, with that biased variance. The sums are
  taken in float64, the rest in x's dtype;
* the dropout's uniforms are drawn by the caller, as ``_dropout`` draws
  them (``torch.rand`` of x's shape from the dropout generator, in the
  same order), and handed in as ``u``: an element is kept where
  ``u >= p`` and scaled by 1 / (1 - p);
* the backward is the whole train-mode gradient, through the batch mean
  and, where the clip did not act, the batch variance.

The forward saves x, the keep mask (uint8) and per channel the mean, the
reciprocal standard deviation and whether the variance was clipped; the
backward recomputes ReLU's gate from them by the forward's operations.
"""

from __future__ import annotations

import torch

from gslidar_tpu_torch.kernels import launch
from gslidar_tpu_torch.utils.trace import count, span

BN_MOMENTUM = 0.01      # flax BatchNorm(momentum=0.99)
BN_EPS = 1e-5
# the most partial sums a channel takes in the kernels' first passes
# (csrc/bn_act.cu ``plan``): the size of their float64 scratch
MAX_PARTS = 128


def _per_channel(v):
    return v[:, None, None]


def _drop_scale(p: float) -> float:
    return 1.0 / (1.0 - p)


def bn_act_reference(x, weight, bias, running_mean, running_var, u,
                     relu: bool, p: float):
    """The plain forward: (y, keep, saved) of x [B, C, H, W], where keep
    is the uint8 dropout mask (None without dropout) and saved the [3, C]
    mean, reciprocal standard deviation and unclipped flag of the batch;
    moves the running statistics in place."""
    n = x.numel() // x.shape[1]
    xd = x.double()
    mean_d = xd.sum(dim=(0, 2, 3)) / n
    raw = (xd * xd).sum(dim=(0, 2, 3)) / n - mean_d * mean_d
    var_d = torch.clamp_min(raw, 0.0)
    mean = mean_d.to(x.dtype)
    rstd = (1.0 / torch.sqrt(var_d + BN_EPS)).to(x.dtype)
    running_mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
    running_var.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var_d.to(x.dtype))
    saved = torch.stack([mean, rstd, (raw >= 0).to(x.dtype)])
    y = (x - _per_channel(mean)) * _per_channel(rstd * weight) \
        + _per_channel(bias)
    if relu:
        y = torch.where((y > 0) | torch.isnan(y), y, 0.0)
    keep = None
    if p > 0:
        keep = (u >= p).to(torch.uint8)
        y = torch.where(keep.bool(), y * _drop_scale(p), 0.0)
    return y, keep, saved


def bn_act_backward_reference(dy, x, weight, bias, saved, keep,
                              relu: bool, p: float):
    """The plain backward: (dx, d weight, d bias) given dy and what
    ``bn_act_reference`` saved."""
    n = x.numel() // x.shape[1]
    mean, rstd, unclipped = saved
    mul = rstd * weight
    g = dy
    if p > 0:
        g = torch.where(keep.bool(), g * _drop_scale(p), 0.0)
    xm = x - _per_channel(mean)
    if relu:
        t = xm * _per_channel(mul) + _per_channel(bias)
        g = torch.where((t > 0) | torch.isnan(t), g, 0.0)
    xhat = xm * _per_channel(rstd)
    sg = g.double().sum(dim=(0, 2, 3))
    sgx = (g.double() * xhat.double()).sum(dim=(0, 2, 3))
    a = (sg / n).to(x.dtype)
    b = (sgx / n).to(x.dtype) * unclipped
    dx = _per_channel(mul) * ((g - _per_channel(a)) - xhat * _per_channel(b))
    return dx, sgx.to(x.dtype), sg.to(x.dtype)


def _check(name, t, shape, dtype=torch.float32, device=None):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            not t.is_contiguous() or (device is not None
                                      and t.device != device):
        raise ValueError(f"{name} must be {dtype} {tuple(shape)} contiguous "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def bn_act_kernel(x, weight, bias, running_mean, running_var, u,
                  relu: bool, p: float):
    """``bn_act_reference`` as one launch of csrc/bn_act.cu's forward pair
    on float32 CUDA tensors (x contiguous [B, C, H, W]; the kernels load
    x, u and dy 16 bytes at a time and refuse a tensor that does not
    start on such a boundary, as a fresh one does), which raises on
    anything else and on dropout without ReLU."""
    B, C, H, W = x.shape
    dev = x.device
    if p > 0 and not relu:
        raise ValueError("the bn_act kernels take dropout only after ReLU")
    if not x.is_cuda:
        raise ValueError(f"the bn_act kernels take CUDA tensors, got x on "
                         f"{dev}")
    _check("x", x, x.shape, device=dev)
    for name, t in (("weight", weight), ("bias", bias),
                    ("running_mean", running_mean),
                    ("running_var", running_var)):
        _check(name, t, (C,), device=dev)
    if p > 0:
        _check("u", u, x.shape, device=dev)
    y = torch.empty_like(x)
    keep = torch.empty(x.shape, dtype=torch.uint8, device=dev) if p > 0 \
        else None
    saved = torch.empty(3, C, dtype=torch.float32, device=dev)
    part = torch.empty(C, MAX_PARTS, 2, dtype=torch.float64, device=dev)
    launch("gslidar_bn_act_fwd", dev, x.data_ptr(),
           u.data_ptr() if p > 0 else None, weight.data_ptr(),
           bias.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(),
           saved.data_ptr(), part.data_ptr(), y.data_ptr(),
           keep.data_ptr() if p > 0 else None, B, C, H * W, int(relu), p,
           _drop_scale(p), BN_MOMENTUM, 1 - BN_MOMENTUM, BN_EPS, MAX_PARTS)
    count("launches.bn_act_fwd")
    return y, keep, saved


def bn_act_backward_kernel(dy, x, weight, bias, saved, keep, relu: bool,
                           p: float):
    """``bn_act_backward_reference`` as one launch of csrc/bn_act.cu's
    backward pair."""
    B, C, H, W = x.shape
    dev = x.device
    dy = dy.contiguous()
    _check("dy", dy, x.shape, device=dev)
    dx = torch.empty_like(x)
    dw = torch.empty(C, dtype=torch.float32, device=dev)
    db = torch.empty(C, dtype=torch.float32, device=dev)
    part = torch.empty(C, MAX_PARTS, 2, dtype=torch.float64, device=dev)
    launch("gslidar_bn_act_bwd", dev, dy.data_ptr(), x.data_ptr(),
           keep.data_ptr() if p > 0 else None, weight.data_ptr(),
           bias.data_ptr(), saved.data_ptr(), part.data_ptr(), dx.data_ptr(),
           dw.data_ptr(), db.data_ptr(), B, C, H * W, int(relu), int(p > 0),
           _drop_scale(p), MAX_PARTS)
    count("launches.bn_act_bwd")
    return dx, dw, db


class BnActFn(torch.autograd.Function):
    """dropout(relu(batchnorm(x))) in training, ReLU where ``relu`` and
    dropout where ``p`` > 0 (its uniforms ``u``); moves the running
    statistics. CUDA tensors only: csrc/bn_act.cu's kernel pairs (module
    docstring)."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, u,
                relu: bool, p: float):
        with span("bn_act"):
            y, keep, saved = bn_act_kernel(x, weight, bias, running_mean,
                                           running_var, u, relu, p)
        ctx.save_for_backward(x, weight, bias, saved, keep)
        ctx.relu, ctx.p = relu, p
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight, bias, saved, keep = ctx.saved_tensors
        with span("bn_act.bwd"):
            dx, dw, db = bn_act_backward_kernel(dy, x, weight, bias, saved,
                                                keep, ctx.relu, ctx.p)
        return dx, dw, db, None, None, None, None, None
