"""The plain reference of the ray-drop refinement: LiDAR4D's U-Net
(GS-LiDAR scene/unet.py:139-171) and one full-batch epoch of its training
(GS-LiDAR train.py:566-652), in plain ``torch`` ops on a dict of tensors.

The U-Net: a 1x1 input conv (with bias) to 32 channels; 4 x (2x2 max
pool, then a DoubleConv) to 64, 128, 256 and 256 channels; an 8-head
self-attention block over the bottleneck's tokens; 4 x (bilinear
upsampling to the skip's size, the skip concatenated before it, a
DoubleConv) back to 32 channels; BatchNorm, ReLU, a 1x1 output conv
(with bias) and a sigmoid. A DoubleConv is twice BatchNorm, ReLU,
dropout 0.1 and a 3x3 conv without bias; an up block's first conv keeps
its input's width (``mid``). The attention block: BatchNorm, a 1x1 conv
to q, k and v, scaled dot products per head, dropout as an additive
-1e12 on the dropped logits, softmax, the heads' outputs through a 1x1
conv, added to the block's input.

An epoch: the input times a box mask, the U-Net in train mode (BatchNorm
on the batch's statistics), the clipped binary cross-entropy against the
ray drop, the gradients, and Adam at the epoch's one-cycle rate.

* BatchNorm is flax's: the batch mean and the biased variance E[x^2] -
  E[x]^2 clipped at 0, eps 1e-5; the running statistics move by 0.01
  towards the batch's, with that biased variance. ``eval_bn`` normalises
  by the running statistics instead and leaves them (a fused inference
  BatchNorm), the control of that name.
* Adam is optax's ``adam``: b1 0.9, b2 0.999, eps 1e-8 added to the
  square root of the bias-corrected second moment.
* The rate is torch's OneCycleLR (cosine, ``max_lr`` 1e-3, 30 % warm-up,
  ``div`` 25, ``final_div`` 1e4) at the update count, evaluated in
  float32.

Departures from the published description, each forced:

* dropout cannot be drawn as the published code draws it (torch's
  ``nn.Dropout`` there, JAX's ``PRNGKey`` in the JAX package): a
  different mask is a different result. Every mask is drawn here as a
  float32 uniform of the dropped tensor's shape from a ``torch.Generator``
  handed in, in the order the forward meets them (each DoubleConv's two,
  the attention logits'), so that a generator seeded as the program's
  gives the program's masks; an element is kept where the uniform is at
  least the rate, and a logit dropped where it is below;
* the box masks are drawn from ``numpy.random.default_rng`` in the JAX
  package's order (``box_mask``), not from Python's ``random``;
* the weights start from flax's initialisation (a normal truncated at 2
  standard deviations, of variance 1 / fan-in, for every conv kernel;
  biases 0, BatchNorm scales 1), drawn from a seeded CPU
  ``torch.Generator`` kernel by kernel in the module order of the
  network, where the published code keeps torch's defaults.

``dtype`` sets the precision of the parameters and the activations;
``tf32`` lets cuDNN and cuBLAS run float32 convolutions and matrix
products in TF32, the control of that name. TF32 is off otherwise.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

CHANNELS = 32
HEADS = 8
DROPOUT = 0.1
BN_MOMENTUM = 0.01
BN_EPS = 1e-5
BCE_EPS = 1e-7
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def double_convs(ch=CHANNELS):
    """[(name, in, mid, out)] of the DoubleConvs, in the network's order."""
    return ([(f"downs.{i}.conv", a, b, b) for i, (a, b) in enumerate(
        ((ch, 2 * ch), (2 * ch, 4 * ch), (4 * ch, 8 * ch), (8 * ch, 8 * ch)))]
        + [(f"ups.{i}.conv", a, a, b) for i, (a, b) in enumerate(
            ((16 * ch, 4 * ch), (8 * ch, 2 * ch), (4 * ch, ch),
             (2 * ch, ch)))])


def layout(ch=CHANNELS, in_ch=3, out_ch=1):
    """(convs, norms): [(name, out, in, k, bias)] of every conv in the
    network's order, and [(name, channels)] of every BatchNorm."""
    convs = [("conv_in", ch, in_ch, 1, True)]
    norms = []
    for name, a, mid, b in double_convs(ch):
        if name.startswith("ups.0"):
            convs += [("attn.qkv", 3 * 8 * ch, 8 * ch, 1, False),
                      ("attn.proj", 8 * ch, 8 * ch, 1, False)]
            norms.append(("attn.bn", 8 * ch))
        convs += [(f"{name}.conv0", mid, a, 3, False),
                  (f"{name}.conv1", b, mid, 3, False)]
        norms += [(f"{name}.bn0", a), (f"{name}.bn1", mid)]
    convs.append(("conv_out", out_ch, ch, 1, True))
    norms.append(("bn", ch))
    return convs, norms


def init_params(seed: int):
    """(params, stats) in float32 on the host: flax's initialisation drawn
    from ``torch.Generator().manual_seed(seed)``, kernel by kernel in the
    order of ``layout``."""
    g = torch.Generator().manual_seed(int(seed))
    convs, norms = layout()
    params, stats = {}, {}
    for name, co, ci, k, bias in convs:
        w = torch.empty(co, ci, k, k)
        std = (ci * k * k) ** -0.5 / .87962566103423978
        torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                    generator=g)
        params[f"{name}.weight"] = w
        if bias:
            params[f"{name}.bias"] = torch.zeros(co)
    for name, c in norms:
        params[f"{name}.weight"] = torch.ones(c)
        params[f"{name}.bias"] = torch.zeros(c)
        stats[f"{name}.running_mean"] = torch.zeros(c)
        stats[f"{name}.running_var"] = torch.ones(c)
    return params, stats


class Net:
    """The U-Net's forward over ``params`` and ``stats`` (dicts of tensors
    of one dtype), in train mode; the running statistics are updated in
    place unless ``eval_bn``."""

    def __init__(self, params, stats, generator, eval_bn=False):
        self.p, self.s, self.g, self.eval_bn = params, stats, generator, \
            eval_bn

    def conv(self, name, x, pad=0):
        return F.conv2d(x, self.p[f"{name}.weight"],
                        self.p.get(f"{name}.bias"), padding=pad)

    def bn(self, name, x):
        rm, rv = self.s[f"{name}.running_mean"], self.s[f"{name}.running_var"]
        if self.eval_bn:
            mean, var = rm, rv
        else:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean,
                                  0.0)
            with torch.no_grad():
                rm.copy_((1 - BN_MOMENTUM) * rm + BN_MOMENTUM * mean)
                rv.copy_((1 - BN_MOMENTUM) * rv + BN_MOMENTUM * var)
        mul = torch.rsqrt(var + BN_EPS) * self.p[f"{name}.weight"]
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.p[f"{name}.bias"][:, None, None])

    def uniform(self, x):
        return torch.rand(x.shape, generator=self.g, device=x.device,
                          dtype=torch.float32)

    def double_conv(self, name, x):
        for i in (0, 1):
            x = F.relu(self.bn(f"{name}.bn{i}", x))
            keep = self.uniform(x) >= DROPOUT
            x = torch.where(keep, x / (1 - DROPOUT), 0.0)
            x = self.conv(f"{name}.conv{i}", x, pad=1)
        return x

    def attention(self, x):
        B, C, H, W = x.shape
        hd = C // HEADS
        qkv = self.conv("attn.qkv", self.bn("attn.bn", x))
        q, k, v = (t.reshape(B, HEADS, hd, H * W).transpose(2, 3)
                   for t in qkv.chunk(3, dim=1))
        w = torch.matmul(q, k.transpose(2, 3)) * (hd ** -0.5)
        w = torch.where(self.uniform(w) < DROPOUT, -1e12, w)
        o = torch.matmul(torch.softmax(w, dim=-1), v)
        return x + self.conv("attn.proj",
                             o.transpose(2, 3).reshape(B, C, H, W))

    def __call__(self, x):
        skips = [self.conv("conv_in", x)]
        for i in range(4):
            skips.append(self.double_conv(f"downs.{i}.conv",
                                          F.max_pool2d(skips[-1], 2)))
        y = self.attention(skips.pop())
        for i in range(4):
            skip = skips.pop()
            up = F.interpolate(y, size=skip.shape[-2:], mode="bilinear",
                               align_corners=False)
            y = self.double_conv(f"ups.{i}.conv", torch.cat([skip, up], 1))
        y = self.conv("conv_out", F.relu(self.bn("bn", y)))
        return torch.sigmoid(y)


def bce(out, y):
    o = torch.clamp(out, BCE_EPS, 1 - BCE_EPS)
    return -torch.mean(y * torch.log(o) + (1 - y) * torch.log(1 - o))


def onecycle_lr(step: int, total: int, max_lr=1e-3, pct_start=0.3,
                div=25.0, final_div=1e4) -> float:
    """OneCycleLR's cosine schedule at update ``step`` (0 first), in
    float32."""
    f32 = np.float32
    init_lr = max_lr / div
    min_lr = init_lr / final_div
    up = max(int(pct_start * total), 1)
    s = f32(step)
    if s < up:
        t = min(max(s / f32(up), f32(0)), f32(1))
        lr = f32(init_lr) + f32((max_lr - init_lr) * 0.5) * (
            f32(1) - f32(math.cos(float(f32(math.pi) * t))))
    else:
        t = min(max((s - f32(up)) / f32(max(total - up, 1)), f32(0)), f32(1))
        lr = f32(min_lr) + f32((max_lr - min_lr) * 0.5) * (
            f32(1) + f32(math.cos(float(f32(math.pi) * t))))
    return float(f32(lr))


def box_mask(rng, h: int, w: int) -> np.ndarray:
    """[h, w] float32 ones with up to 31 boxes of zeros (train.py:614-624),
    each of at most a tenth of the height and of the width."""
    mask = np.ones((h, w), np.float32)
    by, bx = max(int(0.1 * h), 2), max(int(0.1 * w), 2)
    for _ in range(rng.integers(32)):
        sy, sx = rng.integers(1, by), rng.integers(1, bx)
        yi, xi = rng.integers(h - sy), rng.integers(w - sx)
        mask[yi:yi + sy, xi:xi + sx] = 0.0
    return mask


class Run:
    """Epochs of the refinement from ``init_params(seed)`` on the batch
    (x [B, 3, H, W], y [B, 1, H, W]), computed in ``dtype`` on x's
    device. The box masks come from ``default_rng(seed)``, the dropout
    from a generator on the device seeded with ``seed``."""

    def __init__(self, x, y, seed: int, epochs: int, dtype=torch.float64,
                 eval_bn=False, tf32=False):
        device = x.device
        p0, s0 = init_params(seed)
        self.params0, self.stats0 = p0, s0
        self.p = {k: v.to(device, dtype, copy=True).requires_grad_()
                  for k, v in p0.items()}
        self.s = {k: v.to(device, dtype, copy=True) for k, v in s0.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.x, self.y = x.to(dtype), y.to(dtype)
        self.rng = np.random.default_rng(int(seed))
        self.g = torch.Generator(device=device).manual_seed(int(seed))
        self.epochs, self.eval_bn, self.tf32 = epochs, eval_bn, tf32
        self.t = 0

    def epoch(self):
        """One epoch: (loss, its box mask, the gradients by name)."""
        h, w = self.x.shape[2:]
        mask = box_mask(self.rng, h, w)
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            net = Net(self.p, self.s, self.g, self.eval_bn)
            m = torch.as_tensor(mask, device=self.x.device, dtype=self.x.dtype)
            loss = bce(net(self.x * m), self.y)
            grads = dict(zip(self.p, torch.autograd.grad(
                loss, list(self.p.values()))))
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved
        lr = onecycle_lr(self.t, self.epochs)
        self.t += 1
        with torch.no_grad():
            for k, p in self.p.items():
                g = grads[k]
                self.m[k].mul_(B1).add_((1 - B1) * g)
                self.v[k].mul_(B2).add_((1 - B2) * g * g)
                mhat = self.m[k] / (1 - B1 ** self.t)
                vhat = self.v[k] / (1 - B2 ** self.t)
                p.sub_(lr * mhat / (vhat.sqrt() + ADAM_EPS))
        return float(loss.detach()), mask, grads
