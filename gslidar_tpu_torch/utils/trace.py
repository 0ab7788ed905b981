"""Spans and counters of the port: what a ``torch.profiler`` trace shows
of the program's layers, and the counts that say which path ran.

Spans. ``span(name)`` marks a stretch of host work as ``gs.<name>``; it
is a context manager and a decorator. It records only while a
``torch.profiler`` session records (``train.py``'s ``profile_iter``, the
``scripts/profile_*`` entry points, any session a caller opens): then it
is a record function of the profiler's own kind, on whatever thread it
opens, autograd's backward thread included, in the same trace and on the
same clock as the kernels, copies and memsets it launches. With no
profiler a span costs one read of the profiler's flag.

The spans are plain record functions, not ``torch.profiler.
record_function``'s user annotations: the profiler lays each user
annotation on the device's timeline too (a ``gpu_user_annotation`` event
from the first to the last kernel launched inside it), where a reader of
device events would take it for device work. A plain record function
appears on the host's timeline only, and the kernels a span launches
outside any torch op (the port's own CUDA kernels) are linked to it.

``backward_begins`` and ``backward_boundary`` mark torch's own backward
nodes by layer: while a profiler records, a hook on the loss's node opens
the first ``bwd.*`` span, grad hooks on a layer's outputs close the span
of the layer above and open the next one when the last of those
gradients is ready, and the backward's end closes the last. The hooks
return nothing, so no gradient changes; nothing is registered while
nothing records.

Counters. ``count(name, n)`` adds to a plain integer, always on;
``counters()`` reads them all and ``reset_counters()`` clears them:

- ``launches.<kernel>``: the port's hand-written kernels' launches
  (``composite_fwd``, ``composite_bwd``, ``preprocess_fwd``,
  ``preprocess_bwd``, ``chamfer_fwd``, ``chamfer_bwd``, ``adam``,
  ``bn_act_fwd``, ``bn_act_bwd``, ``gather_rows``, ``op_chain``);
- ``train_steps``: one per training step;
- ``refine_epochs``: one per epoch of the ray-drop refinement
  (``engine/refine.py``'s ``refine_epoch``);
- ``instances``: the (gaussian, tile) instances binning made, per render;
- ``payload.direct`` and ``payload.packed``: renders whose payload rows
  the preprocess kernel wrote (``raster/preprocess.py``), and rows packed
  eagerly (``composite_fwd.pack_payload``: the CPU, a tap on T);
- ``loss_graph.captures`` and ``loss_graph.replays``: the losses' CUDA
  graph pairs captured, and their forwards and backwards replayed
  (``engine/loss_graph.py``);
- ``host_syncs`` and ``host_syncs.<site>``: one per device-to-host read,
  counted at the line that causes it (``host_sync``); a read inside a
  backward node of torch's is counted at the forward call that makes the
  node, under a site whose name ends in ``_bwd``. A blocking copy from
  the host that waits for the stream counts too: the refinement's box
  mask, ``refine_mask``, one an epoch; ``refine_print``, the loss read
  every 50th epoch of ``refine``'s loop.

The refinement's spans: ``refine.epoch`` ⊃ ``refine.mask`` (the box
mask drawn and copied), ``refine.forward`` (⊃ the U-Net's stages
``unet.down``, ``unet.attn``, ``unet.up``, ``unet.out``, each ⊃ on the
card a ``bn_act`` per BatchNorm, the launch of its forward kernel pair),
``refine.loss`` (the clipped BCE), ``refine.backward``
(``loss.backward()``; on autograd's thread ``bwd.unet.out``,
``bwd.unet.up``, ``bwd.unet.attn``, ``bwd.unet.down``, each ⊃ on the card
a ``bn_act.bwd`` per BatchNorm), ``refine.adam``.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

PREFIX = "gs."


class _Named:
    """What ``span(name)`` returns while nothing records: a no-op context,
    one shared by every use of the name, and the name's decorator, which
    looks at the flag on each call."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        full = PREFIX + self.name

        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _RecordFunctionFast(full):
                return fn(*args, **kwargs)
        return run


class _Recording(_Named):
    """A span while a profiler records."""
    __slots__ = ("_rf",)

    def __enter__(self):
        self._rf = _RecordFunctionFast(PREFIX + self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        return False


_SHARED: dict = {}


def span(name: str):
    """``with span("binning"):`` or ``@span("binning")``: the work inside,
    as ``gs.binning`` in a profiler's trace."""
    if not _profiler._is_profiler_enabled:
        s = _SHARED.get(name)
        if s is None:
            s = _SHARED[name] = _Named(name)
        return s
    return _Recording(name)


# ---------------------------------------------------------------- counters
_COUNTS: dict = {}
_LOCK = threading.Lock()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> dict:
    """A copy of every counter."""
    with _LOCK:
        return dict(_COUNTS)


def reset_counters() -> None:
    """Clear every counter."""
    with _LOCK:
        _COUNTS.clear()


@contextlib.contextmanager
def counts_apart():
    """``with counts_apart() as made:`` the counts made inside, as a dict
    ``made`` filled when the block ends, taken back out of the counters
    (a CUDA graph's capture records its kernels' launches this way, to
    count them again at each replay)."""
    made = {}
    before = counters()
    try:
        yield made
    finally:
        with _LOCK:
            for k, n in _COUNTS.items():
                if n != before.get(k, 0):
                    made[k] = n - before.get(k, 0)
            for k, n in made.items():
                if k in before:
                    _COUNTS[k] -= n
                else:
                    del _COUNTS[k]


def count_sync(site: str, n: int = 1) -> None:
    """Count ``n`` device-to-host reads at ``site``."""
    count("host_syncs", n)
    count("host_syncs." + site, n)


def host_sync(site: str, n: int = 1):
    """Count ``n`` device-to-host reads at ``site`` and return the span
    ``sync.<site>`` to make them in."""
    count_sync(site, n)
    return span("sync." + site)


# ------------------------------------------------- the backward, by layer
_BWD = threading.local()


def _switch(name):
    """Close this thread's open ``bwd.*`` span and open ``name`` (None:
    open none)."""
    rf = getattr(_BWD, "rf", None)
    if rf is not None:
        rf.__exit__(None, None, None)
    _BWD.rf = None
    if name is not None and _profiler._is_profiler_enabled:
        _BWD.rf = _RecordFunctionFast(PREFIX + name)
        _BWD.rf.__enter__()


def backward_begins(loss, name: str) -> None:
    """While a profiler records: open the span ``name`` (a ``bwd.*``
    layer) when the backward reaches ``loss``'s node, its first, and close
    the open one when the backward ends."""
    if _profiler._is_profiler_enabled and loss.grad_fn is not None:
        def begin(_grads):
            _switch(name)
            torch.autograd.Variable._execution_engine.queue_callback(
                lambda: _switch(None))
        loss.grad_fn.register_prehook(begin)


def backward_boundary(tensors, name: str) -> None:
    """While a profiler records: when the last gradient of ``tensors``
    that the backward computes is ready, close the open ``bwd.*`` span
    and open ``name``. Leaves and tensors that need no gradient are
    passed over; nothing is registered when none is left."""
    if not _profiler._is_profiler_enabled:
        return
    ts = list({id(t): t for t in tensors if torch.is_tensor(t)
               and t.requires_grad and t.grad_fn is not None}.values())
    if ts:
        torch.autograd.graph.register_multi_grad_hook(
            ts, lambda _g: _switch(name))
