"""The step's pixel-space losses as a captured CUDA graph pair.

``compute_losses`` (``engine/losses.py``) hands its terms here on the
card: ``replay`` runs them as one ``torch.autograd.Function`` whose
forward replays one captured CUDA graph of the terms and whose backward
replays one captured graph of their autograd backward to the render
planes. Some 200 eager ops and 150 autograd nodes, each a few µs of
device work on a 66x515 panorama, cost the host ~10 µs or more apiece;
two replays cost it one launch each. The graphs hold the eager code's
kernels in its order, so the loss, the log and the gradients are its
bits, but where the chamfer's backward adds by atomics.

A capture (``Capture``) owns static buffers: the render planes the terms
read, the GT depth and intensity panoramas, and the terms' weights as one
float32 vector. A call copies its planes and GT into them with one
multi-tensor copy and its weights from pinned memory without a sync,
replays the forward and hands back fresh copies of the loss and the
terms, since the next replay overwrites the buffers. The weights are
data, not constants of the graph, so one capture serves every iteration
(the schedules and ``lidar_decay`` change them). The plane gradients the
backward hands back are its graph's buffers, which autograd consumes
within the step.

Captures are cached by what a graph bakes in: the device, each plane's
and GT panorama's shape, strides, dtype and whether it needs a gradient
(so each coarse-to-fine resolution has its own), which planes are one
tensor, the computed terms and the constants of the config they read. A
capture is held while the autograd node of its last forward lives; a
call takes a capture of its key that is not held, or captures another.
The data-parallel step renders its cameras and computes their losses
before one backward, so each of a rank's cameras gets a capture of its
own. Before its capture, a capture warms up on a side stream, as
``torch.cuda.make_graphed_callables`` does.

Counters (``utils/trace.py``): ``loss_graph.captures``, one per capture,
and ``loss_graph.replays``, the forward's and the backward's, two a step;
the launch counters the terms bump at the capture (the chamfer pair's)
are added again at each replay, so they still read one a step. Spans:
``loss.graph`` around the forward's copies and replay, ``bwd.loss_graph``
around the backward's, on autograd's thread; the profiler links the
graphs' kernels to them.
"""

from __future__ import annotations

import weakref

import torch

from gslidar_tpu_torch.utils.trace import count, counts_apart, span

WARMUP = 3                   # the side stream's runs before a capture

_CAPTURES: dict = {}         # key -> [Capture]


class Capture:
    """The forward and backward graphs of ``body(planes, gt_depth,
    gt_intensity, weights)`` -> (loss, log) captured on static copies of
    a call's ``planes`` (field -> tensor; one tensor under two fields
    stays one), ``gt`` and ``weights`` (term -> weight)."""

    def __init__(self, body, planes: dict, gt, weights: dict):
        dev = gt[0].device
        uniq = {}
        for p in planes.values():
            if id(p) not in uniq:
                uniq[id(p)] = p.detach().clone().requires_grad_(
                    p.requires_grad)
        self.inputs = list(uniq.values())
        static = {f: uniq[id(p)] for f, p in planes.items()}
        self.gt = [g.detach().clone() for g in gt]
        self.static = [*self.inputs, *self.gt]
        self.weights = torch.zeros(len(weights), dtype=torch.float32,
                                   device=dev)
        w = dict(zip(weights, self.weights.unbind()))
        needed = [p for p in self.inputs if p.requires_grad]

        def run():
            with torch.enable_grad():
                return body(static, *self.gt, w)

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with counts_apart(), torch.cuda.stream(side):
            for _ in range(WARMUP):
                torch.autograd.grad(run()[0], needed, allow_unused=True)
        torch.cuda.current_stream(dev).wait_stream(side)

        self.fwd, self.bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with counts_apart() as self.fwd_counts:
            with torch.cuda.graph(self.fwd):
                loss, log = run()
                self.names = [k for k in log if k != "loss"]
                terms = torch.stack([log[k] for k in self.names])
        self.grad_loss = torch.empty_like(loss)
        # the loss's gradient enters as the factor of a product, whose
        # backward hands it on times 1, bit for bit, rather than as
        # ``grad_outputs``, whose check imports sympy (seconds of set-up);
        # the saved tensors stay theirs through the capture, so that no
        # later node's buffer takes their memory: a retained graph's second
        # backward replays on them again
        with counts_apart() as self.bwd_counts:
            with torch.cuda.graph(self.bwd, pool=self.fwd.pool()):
                grads = iter(torch.autograd.grad(
                    loss * self.grad_loss, needed, retain_graph=True,
                    allow_unused=True))
        self.grads = [next(grads) if p.requires_grad else None
                      for p in self.inputs]
        self.loss, self.terms = loss.detach(), terms.detach()
        self.holder = None
        count("loss_graph.captures")

    def held(self) -> bool:
        return self.holder is not None and self.holder() is not None


def _replayed(counts: dict) -> None:
    count("loss_graph.replays")
    for k, n in counts.items():
        count(k, n)


class _Replay(torch.autograd.Function):
    """The capture's forward on a call's planes; its backward to them."""

    @staticmethod
    def forward(ctx, cap, gt, weights, *planes):
        cap.weights.copy_(weights, non_blocking=True)
        torch._foreach_copy_(cap.static, [*planes, *gt])
        cap.fwd.replay()
        _replayed(cap.fwd_counts)
        ctx.cap = cap
        cap.holder = weakref.ref(ctx)
        return cap.loss.clone()

    @staticmethod
    def backward(ctx, grad):
        cap = ctx.cap
        with span("bwd.loss_graph"):
            cap.grad_loss.copy_(grad)
            cap.bwd.replay()
        _replayed(cap.bwd_counts)
        return None, None, None, *cap.grads


def replay(body, planes: dict, gt, weights: dict, baked: tuple):
    """(loss, log) of ``body`` as ``Capture`` runs it, on CUDA ``planes``
    (field -> tensor, some needing a gradient), ``gt`` (the GT depth and
    intensity panoramas) and ``weights`` (term -> Python float); ``baked``
    names the other constants ``body`` reads. The log holds a fresh 0-d
    tensor per term and the loss."""
    uniq = list({id(p): p for p in planes.values()}.values())
    ids = [id(p) for p in uniq]
    key = (gt[0].device, tuple(weights), baked,
           tuple((f, ids.index(id(p)), tuple(p.shape), p.stride(), p.dtype,
                  p.requires_grad) for f, p in planes.items()),
           tuple((tuple(g.shape), g.stride(), g.dtype) for g in gt))
    caps = _CAPTURES.setdefault(key, [])
    cap = next((c for c in caps if not c.held()), None)
    if cap is None:
        cap = Capture(body, planes, gt, weights)
        caps.append(cap)
    w = torch.tensor(list(weights.values()), dtype=torch.float32,
                     pin_memory=True)
    with span("loss.graph"):
        loss = _Replay.apply(cap, gt, w, *uniq)
        terms = cap.terms.clone()
    log = dict(zip(cap.names, terms.unbind()))
    log["loss"] = loss
    return loss, log


def captures() -> list:
    """The number of captures of each key, in the order the keys came."""
    return [len(c) for c in _CAPTURES.values()]


def clear() -> None:
    """Drop every capture, and with them their graphs' memory."""
    _CAPTURES.clear()
