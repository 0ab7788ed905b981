"""The work of one epoch of the ray-drop refinement U-Net
(``reference/unet.py``), forward and backward, and so its least time on
one NVIDIA H100 SXM (``counts.Work``).

Operations: every convolution and matrix product, forward and backward,
counted as ``torch.utils.flop_counter.FlopCounterMode`` counts them (2
per multiply-add; a convolution's backward computes the gradient of its
weight and, where its input needs one, of its input, each as many
multiply-adds as the forward; the input conv's input needs none), plus
the softmax's. One multiply-add is one float32 instruction issued
(``counts.issue_ms``: 128 a clock on each of 132 SMs, 67 TFLOP/s at the
boost clock); TF32 is off, so no tensor core is counted.

Bytes: each pass of the epoch reads its inputs once and writes its
outputs once at the least: the masked input; every convolution's
activations and weights, forward and backward; BatchNorm, ReLU and
dropout (a one-byte keep mask) forward and backward; the max pools, the
bilinear upsamplings and the concatenations; the skips' gradient sums;
the attention's logits; the output's sigmoid and loss; Adam over every
parameter (``counts.ADAM_BYTES`` an element). MUFU: the softmax's
exponentials, the sigmoid's and the loss's transcendental functions.
"""

from __future__ import annotations

from benchmark import counts
from benchmark.reference.unet import CHANNELS, HEADS, double_convs, layout

F32 = 4
# the softmax per logit: max, subtract, sum, divide forward; the product
# with the gradient, its row sum, subtract and multiply backward
SOFTMAX_FP32_FWD, SOFTMAX_FP32_BWD = 4, 4


def levels(h: int, w: int) -> list:
    """[(h, w)] of the five levels: the input's and each max pool's."""
    out = [(h, w)]
    for _ in range(4):
        out.append((out[-1][0] // 2, out[-1][1] // 2))
    return out


def convs(b: int, h: int, w: int) -> list:
    """[(name, in, out, k, pixels, input needs a gradient)] of every
    convolution of the network at batch ``b`` on h x w inputs."""
    lv = levels(h, w)
    px = [b * y * x for y, x in lv]
    spec = {name: (ci, co, k) for name, co, ci, k, _ in layout()[0]}
    out = [("conv_in", *spec["conv_in"], px[0], False)]
    for name, _, _, _ in double_convs():
        i = int(name.split(".")[1])
        p = px[i + 1] if name.startswith("downs") else px[3 - i]
        if name == "ups.0.conv":
            out += [(n, *spec[n], px[4], True)
                    for n in ("attn.qkv", "attn.proj")]
        out += [(f"{name}.conv{j}", *spec[f"{name}.conv{j}"], p, True)
                for j in (0, 1)]
    out.append(("conv_out", *spec["conv_out"], px[0], True))
    return out


def attention_tokens(h: int, w: int) -> int:
    y, x = levels(h, w)[4]
    return y * x


def conv_flops(b: int, h: int, w: int) -> int:
    """The convolutions' operations, forward and backward."""
    total = 0
    for _, ci, co, k, p, grad_in in convs(b, h, w):
        f = 2 * p * ci * co * k * k
        total += f * (2 + grad_in)
    return total


def matmul_flops(b: int, h: int, w: int) -> int:
    """The attention's two matrix products per head, forward and
    backward (each product's backward is two more)."""
    n = attention_tokens(h, w)
    hd = 8 * CHANNELS // HEADS
    return 3 * 2 * (2 * b * HEADS * n * n * hd)


def epoch_flops(b: int, h: int, w: int) -> int:
    """What FlopCounterMode counts over one epoch: convolutions and matrix
    products, forward and backward."""
    return conv_flops(b, h, w) + matmul_flops(b, h, w)


def parameters() -> int:
    convs_, norms = layout()
    return (sum(co * ci * k * k + (co if bias else 0)
                for _, co, ci, k, bias in convs_)
            + sum(2 * c for _, c in norms))


def _elementwise_bytes(b: int, h: int, w: int) -> dict:
    lv = levels(h, w)

    def n(c, i):
        return b * c * lv[i][0] * lv[i][1]
    parts = dict(mask=2 * n(3, 0) * F32, batchnorm=0, relu=0, dropout=0,
                 pool=0, upsample=0, concat=0, skips=0, attention=0,
                 output=0)

    def bn_relu_drop(c, i, drop=True):
        e = n(c, i)
        parts["batchnorm"] += (2 + 3) * e * F32     # fwd x, y; bwd dy, x, dx
        parts["relu"] += (2 + 3) * e * F32          # fwd x, y; bwd dy, y, dx
        if drop:                                    # a one-byte keep mask
            parts["dropout"] += (2 + 2) * e * F32 + 2 * e

    ch = CHANNELS
    for name, a, mid, o in double_convs():
        i = int(name.split(".")[1])
        if name.startswith("downs"):
            lvl = i + 1
            parts["pool"] += 2 * (n(a, i) + n(a, lvl)) * F32
        else:
            lvl = 3 - i
            up_c = a // 2               # the upsampled half of the input
            small = n(up_c, lvl + 1)
            big = n(up_c, lvl)
            parts["upsample"] += 2 * (small + big) * F32
            parts["concat"] += 2 * n(a, lvl) * F32
            parts["skips"] += 3 * n(a - up_c, lvl) * F32   # two grads summed
        bn_relu_drop(a, lvl)
        bn_relu_drop(mid, lvl)
    # the attention block: its BatchNorm, logits (fwd: write, dropout,
    # softmax; bwd the same), the residual
    tok = attention_tokens(h, w)
    logits = b * HEADS * tok * tok
    parts["batchnorm"] += 5 * n(8 * ch, 4) * F32
    parts["attention"] += (3 * 2 * 2 * logits + 2 * logits) * F32 + \
        3 * n(8 * ch, 4) * F32
    # the output: BatchNorm and ReLU at 32 channels, sigmoid and loss
    bn_relu_drop(ch, 0, drop=False)
    parts["output"] += 2 * 4 * n(1, 0) * F32
    return parts


def _conv_bytes(b: int, h: int, w: int) -> int:
    total = 0
    for _, ci, co, k, p, grad_in in convs(b, h, w):
        x, y, wt = p * ci * F32, p * co * F32, ci * co * k * k * F32
        total += x + y + wt                         # forward
        total += y + x + wt                         # the weight's gradient
        if grad_in:
            total += y + wt + x                     # the input's gradient
    return total


def epoch_work(b: int, h: int, w: int) -> counts.Work:
    """One epoch on a batch of ``b`` panoramas of h x w: ``counts.Work``
    by part, each (bytes, float32 instructions, MUFU operations)."""
    tok = attention_tokens(h, w)
    logits = b * HEADS * tok * tok
    pixels = b * h * w
    parts = {
        "convolutions": (_conv_bytes(b, h, w), conv_flops(b, h, w) // 2, 0),
        "attention_matmuls": (0, matmul_flops(b, h, w) // 2, 0),
        "softmax": (0, logits * (SOFTMAX_FP32_FWD + SOFTMAX_FP32_BWD),
                    logits),
        # sigmoid: an exponential and a reciprocal; the loss: two logs,
        # and two reciprocals in its backward
        "output_mufu": (0, 0, 6 * pixels),
        "adam": (parameters() * counts.ADAM_BYTES, 0, 0),
    }
    for k, v in _elementwise_bytes(b, h, w).items():
        parts[k] = (v, 0, 0)
    return counts.Work(parts=parts)
