"""Ray-drop refinement U-Net (port of gslidar_tpu/models/unet.py, a
flax.linen module; reference scene/unet.py, LiDAR4D's efficient U-Net).

1x1 InConv -> 4 x (maxpool + DoubleConv[BN, ReLU, Dropout]) 32..256
channels -> multi-head self-attention bottleneck -> 4 x bilinear-up with
skip concat -> BN/ReLU/1x1 OutConv -> sigmoid. In: [B, 3, H, 2W]
(raydrop, intensity, depth); out: [B, 1, H, 2W]. NCHW throughout.

What keeps it equal to the flax module:

* ``BatchNorm`` is flax's: the batch variance E[x^2] - E[x]^2, running
  averages ``ra = 0.99 ra + 0.01 batch`` (torch ``momentum=0.01``) with
  that *biased* variance, where ``torch.nn.BatchNorm2d`` would update with
  the unbiased one; eps 1e-5.
* Dropout draws from an explicit ``torch.Generator``: keep-and-rescale
  after each ReLU of a DoubleConv, and in the bottleneck an additive
  -1e12 mask on the attention logits before the softmax (reference
  scene/unet.py:99-102). The streams cannot match JAX's ``PRNGKey``.
* Upsampling is ``F.interpolate(mode="bilinear", align_corners=False)``,
  which samples as ``jax.image.resize(..., "bilinear")`` does when it
  upsamples, also at non-2x steps (16 -> 33, 257 -> 515).
* In training on the card each BatchNorm and the ReLU and dropout after
  it are one op (``norm_act``: ``models/bn_act.py``'s kernel pair), which
  draws the dropout's uniforms as ``_dropout`` does; eval mode and the
  CPU keep ``BatchNorm``, ``F.relu`` and ``_dropout``, the eager path the
  tests hold to the JAX package.

``unet_from_flax`` carries a flax (params, batch_stats) tree across;
``unet_leaves`` / ``unet_from_leaves`` read and write the flat
``jax.tree.flatten((params, batch_stats))`` list that the JAX package's
``refine.npz`` holds, whose order ``flax_tree`` gives.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gslidar_tpu_torch.models.bn_act import BN_EPS, BN_MOMENTUM, BnActFn
from gslidar_tpu_torch.utils.trace import backward_boundary, span


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm over NCHW channels (module docstring)."""

    def __init__(self, ch):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x):
        if self.training:
            # flax's statistics: E[x^2] - E[x]^2, clipped at 0
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean,
                                  0.0)
            with torch.no_grad():
                self.running_mean.mul_(1 - BN_MOMENTUM).add_(
                    BN_MOMENTUM * mean)
                self.running_var.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


def _dropout(x, p, generator):
    """flax Dropout: keep with probability 1 - p, scaled by 1 / (1 - p)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1 - p), 0.0)


def norm_act(bn, x, relu: bool, p: float = 0.0, generator=None):
    """``bn(x)``, then ReLU where ``relu``, then dropout where ``p`` > 0
    (drawn from ``generator`` as ``_dropout`` draws it). A float32 CUDA
    tensor in training takes ``models/bn_act.py``'s ``BnActFn``, the
    kernel pair of csrc/bn_act.cu; eval mode, the CPU and other dtypes
    take the eager module and ops."""
    if bn.training and x.is_cuda and x.dtype == torch.float32:
        u = torch.rand(x.shape, generator=generator, device=x.device) \
            if p > 0 else None
        return BnActFn.apply(x, bn.weight, bn.bias,
                             bn.running_mean, bn.running_var, u, relu, p)
    x = bn(x)
    if relu:
        x = F.relu(x)
    if p > 0:
        x = _dropout(x, p, generator)
    return x


class DoubleConv(nn.Module):
    def __init__(self, in_ch, out_ch, mid_ch=None, dropout=0.1):
        super().__init__()
        mid = mid_ch or out_ch
        self.bn0 = BatchNorm(in_ch)
        self.conv0 = nn.Conv2d(in_ch, mid, 3, padding=1, bias=False)
        self.bn1 = BatchNorm(mid)
        self.conv1 = nn.Conv2d(mid, out_ch, 3, padding=1, bias=False)
        self.dropout = dropout

    def forward(self, x, generator=None):
        p = self.dropout if self.training else 0.0
        for bn, conv in ((self.bn0, self.conv0), (self.bn1, self.conv1)):
            x = conv(norm_act(bn, x, True, p, generator))
        return x


class Down(nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.conv = DoubleConv(in_ch, out_ch)

    def forward(self, x, generator=None):
        return self.conv(F.max_pool2d(x, 2), generator)


class Up(nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.conv = DoubleConv(in_ch, out_ch, mid_ch=in_ch)

    def forward(self, x1, x2, generator=None):
        x1 = F.interpolate(x1, size=x2.shape[-2:], mode="bilinear",
                           align_corners=False)
        return self.conv(torch.cat([x2, x1], dim=1), generator)


class AttnBlock(nn.Module):
    def __init__(self, ch, num_heads=8, dropout=0.1):
        super().__init__()
        self.bn = BatchNorm(ch)
        self.qkv = nn.Conv2d(ch, 3 * ch, 1, bias=False)
        self.proj = nn.Conv2d(ch, ch, 1, bias=False)
        self.num_heads = num_heads
        self.dropout = dropout

    def forward(self, x, generator=None):
        B, C, H, W = x.shape
        hd = C // self.num_heads
        q, k, v = (t.reshape(B, self.num_heads, hd, H * W).transpose(2, 3)
                   for t in self.qkv(norm_act(self.bn, x, False))
                   .chunk(3, dim=1))
        w = torch.matmul(q, k.transpose(2, 3)) * (hd ** -0.5)
        if self.training and self.dropout > 0:
            drop = torch.rand(w.shape, generator=generator,
                              device=w.device) < self.dropout
            w = torch.where(drop, -1e12, w)
        o = torch.matmul(torch.softmax(w, dim=-1), v)
        return x + self.proj(o.transpose(2, 3).reshape(B, C, H, W))


class UNet(nn.Module):
    def __init__(self, channels=32, in_channels=3, out_channels=1):
        super().__init__()
        ch = channels
        self.conv_in = nn.Conv2d(in_channels, ch, 1)
        self.downs = nn.ModuleList([Down(ch, ch * 2), Down(ch * 2, ch * 4),
                                    Down(ch * 4, ch * 8),
                                    Down(ch * 8, ch * 8)])
        self.attn = AttnBlock(ch * 8)
        self.ups = nn.ModuleList([Up(ch * 16, ch * 4), Up(ch * 8, ch * 2),
                                  Up(ch * 4, ch), Up(ch * 2, ch)])
        self.bn = BatchNorm(ch)
        self.conv_out = nn.Conv2d(ch, out_channels, 1)

    def forward(self, x, generator=None):
        """x [B, 3, H, W] -> [B, 1, H, W] in (0, 1). In train mode the
        dropout draws from ``generator`` (on x's device). Each stage is a
        ``unet.<stage>`` span, and its backward a ``bwd.unet.<stage>``
        span on autograd's thread (``utils/trace.py``)."""
        with span("unet.down"):
            skips = [self.conv_in(x)]
            for down in self.downs:
                skips.append(down(skips[-1], generator))
        with span("unet.attn"):
            bottom = skips.pop()
            backward_boundary([bottom], "bwd.unet.down")
            y = self.attn(bottom, generator)
        with span("unet.up"):
            backward_boundary([y], "bwd.unet.attn")
            for up in self.ups:
                y = up(y, skips.pop(), generator)
        with span("unet.out"):
            backward_boundary([y], "bwd.unet.up")
            y = self.conv_out(norm_act(self.bn, y, True))
            return torch.sigmoid(y)


def init_unet(model: UNet, generator: torch.Generator) -> UNet:
    """flax's initialisation, drawn from ``generator``: conv kernels
    lecun_normal (a normal truncated at 2 std, of variance 1 / fan_in),
    biases 0, BatchNorm scale 1 and bias 0."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            std = m.weight[0].numel() ** -0.5 / .87962566103423978
            with torch.no_grad():
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
    return model


def _conv(mod, bias):
    leaf = {"kernel": (mod.weight, "conv")}
    if bias:
        leaf["bias"] = (mod.bias, None)
    return leaf


def _bn(mod):
    return ({"bias": (mod.bias, None), "scale": (mod.weight, None)},
            {"mean": (mod.running_mean, None), "var": (mod.running_var,
                                                        None)})


def _double(dc):
    (p0, s0), (p1, s1) = _bn(dc.bn0), _bn(dc.bn1)
    return ({"BatchNorm_0": p0, "BatchNorm_1": p1,
             "Conv_0": _conv(dc.conv0, False),
             "Conv_1": _conv(dc.conv1, False)},
            {"BatchNorm_0": s0, "BatchNorm_1": s1})


def flax_tree(model: UNet):
    """(params, batch_stats): the flax module's variable trees, with each
    leaf a (tensor of ``model``, kind) pair, kind "conv" for a kernel
    (flax HWIO, torch OIHW)."""
    bn_p, bn_s = _bn(model.bn)
    at_p, at_s = _bn(model.attn.bn)
    params = {"BatchNorm_0": bn_p, "Conv_0": _conv(model.conv_in, True),
              "Conv_1": _conv(model.conv_out, True),
              "AttnBlock_0": {"BatchNorm_0": at_p,
                              "Conv_0": _conv(model.attn.qkv, False),
                              "Conv_1": _conv(model.attn.proj, False)}}
    stats = {"BatchNorm_0": bn_s, "AttnBlock_0": {"BatchNorm_0": at_s}}
    for kind, mods in (("Down", model.downs), ("Up", model.ups)):
        for i, m in enumerate(mods):
            p, s = _double(m.conv)
            params[f"{kind}_{i}"] = {"DoubleConv_0": p}
            stats[f"{kind}_{i}"] = {"DoubleConv_0": s}
    return params, stats


def _flatten(tree):
    """Leaves in ``jax.tree.flatten`` order: dict keys sorted."""
    if isinstance(tree, tuple):
        return [tree]
    return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]


def _to_flax(t, kind):
    a = t.detach().cpu().numpy()
    return a.transpose(2, 3, 1, 0) if kind == "conv" else a


def _load(t, a, kind):
    a = torch.from_numpy(np.array(a, np.float32))
    if kind == "conv":
        a = a.permute(3, 2, 0, 1)
    if tuple(a.shape) != tuple(t.shape):
        raise ValueError(f"leaf of shape {tuple(a.shape)} for a tensor of "
                         f"shape {tuple(t.shape)}")
    with torch.no_grad():
        t.copy_(a)


def unet_leaves(model: UNet):
    """The flat ``jax.tree.flatten((params, batch_stats))`` list of numpy
    arrays (flax layouts) of ``model``'s weights."""
    params, stats = flax_tree(model)
    return [_to_flax(t, kind) for t, kind in _flatten(params)
            + _flatten(stats)]


def unet_from_leaves(leaves, device="cpu") -> UNet:
    """A UNet on ``device`` holding the weights of a flat leaf list in
    ``unet_leaves``' order."""
    model = UNet()
    params, stats = flax_tree(model)
    slots = _flatten(params) + _flatten(stats)
    if len(leaves) != len(slots):
        raise ValueError(f"{len(leaves)} leaves for {len(slots)} tensors")
    for (t, kind), a in zip(slots, leaves):
        _load(t, a, kind)
    return model.to(device)


def unet_from_flax(params, batch_stats, device="cpu") -> UNet:
    """A UNet on ``device`` holding a flax UNet's variables (nested dicts
    of numpy arrays)."""
    def walk(slots, tree):
        if isinstance(slots, tuple):
            return [tree]
        return [a for k in sorted(slots) for a in walk(slots[k], tree[k])]
    slots_p, slots_s = flax_tree(UNet())
    return unet_from_leaves(walk(slots_p, params) + walk(slots_s,
                                                        batch_stats), device)
