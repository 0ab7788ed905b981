"""The traced run's device trace: ``torch.profiler`` over a short steady
stretch of the cell's own calls.

During the stretch the program's functions named in ``benchmark/spans/``
(one JSON file each: span name, module, attribute, the kinds of cell) are
wrapped in ``record_function`` spans of the benchmark's own, so that the
device's idle gaps can be named by what the host was doing; outside it
the program runs unwrapped. A span whose module or attribute the program
no longer has is left out.

``Profile`` keeps what the metric readers and the result line take from
the trace: the stretch's wall time, the device's busy time (the union of
its kernels', copies' and memsets' spans), the device time by op name,
the idle gaps by host span, and the device time of the work launched
inside each span. The last links each kernel, copy and memset to the host
op that launched it, as the profiler does for its own tables, and counts
it for a span when that op started inside it on the host clock, on any
thread: autograd's backward runs on a thread of its own while the
calling thread waits inside ``torch.autograd.grad``.
"""

from __future__ import annotations

import functools
import glob
import importlib
import json
import os
import re
import time
from typing import NamedTuple

import torch

SPAN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "spans")
PREFIX = "bench."


class Profile(NamedTuple):
    units: int                 # calls in the stretch
    wall_s: float
    busy_s: float
    device_ops: list           # [(name, start_us, end_us)]
    gaps: dict                 # host span -> idle seconds
    launches: list             # [(host start_us, device seconds)]
    spans: list                # [(benchmark span, start_us, end_us)]

    @property
    def device_total_s(self) -> float:
        return sum(e - s for _, s, e in self.device_ops) / 1e6

    @property
    def attributed_s(self) -> float:
        """Device seconds linked to a host op inside the stretch."""
        return self.span_device_s("stretch")

    def span_device_s(self, *names: str) -> float:
        """Device seconds of the work launched inside any of the spans
        ``names``."""
        inside = [(s, e) for n, s, e in self.spans if n in names]
        return sum(d for t, d in self.launches
                   if any(s <= t <= e for s, e in inside))

    def device_s(self, pattern: str) -> float:
        """Seconds of device ops whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.device_ops if rx.search(n)) / 1e6

    def top_ops(self, k: int = 10) -> list:
        by = {}
        for n, s, e in self.device_ops:
            by[short(n)] = by.get(short(n), 0.0) + (e - s) / 1e6
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda kv: -kv[1])[:k]

    def top_gaps(self, k: int = 10) -> list:
        return sorted(([n, v] for n, v in self.gaps.items()),
                      key=lambda kv: -kv[1])[:k]


NOISE = ("void ", "at::native::", "(anonymous namespace)::",
         "at_cuda_detail::", "std::array<char*, 3ul>",
         "std::array<char*, 2ul>")


def short(name: str) -> str:
    """A device op's name without its namespaces, at most 120 letters."""
    for n in NOISE:
        name = name.replace(n, "")
    return name[:120]


def span_table(kind: str) -> list:
    out = []
    for path in sorted(glob.glob(os.path.join(SPAN_DIR, "*.json"))):
        with open(path) as f:
            s = json.load(f)
        if kind in s["kinds"]:
            out.append(s)
    return out


class wrapped_spans:
    """Context: the span table's functions wrapped in record_function."""

    def __init__(self, kind: str):
        self.kind, self.saved = kind, []

    def __enter__(self):
        for s in span_table(self.kind):
            try:
                mod = importlib.import_module(s["module"])
            except ImportError:
                continue
            fn = getattr(mod, s["attr"], None)
            if not callable(fn):
                continue
            self.saved.append((mod, s["attr"], fn))
            setattr(mod, s["attr"], _span(PREFIX + s["span"], fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)
        self.saved = []


def _span(name, fn):
    @functools.wraps(fn)
    def run(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return run


def profile(call, n: int, kind: str) -> Profile:
    """``call(i)`` n times under the profiler, each in a ``bench.call``
    span, with the span table's functions wrapped."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    torch.cuda.synchronize()
    with wrapped_spans(kind), tprofile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            acc_events=True) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(PREFIX + "stretch"):
            for i in range(n):
                with torch.profiler.record_function(PREFIX + "call"):
                    call(i)
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = list(prof.events())
    # the device's kernels, copies and memsets; the profiler also lays the
    # benchmark's own spans on the device's timeline, which are left out
    dev = sorted(((e.name, e.time_range.start, e.time_range.end)
                  for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith(PREFIX)), key=lambda x: x[1])
    host = [(e.name[len(PREFIX):], e.time_range.start, e.time_range.end)
            for e in events
            if e.device_type != torch.autograd.DeviceType.CUDA
            and e.name.startswith(PREFIX)]
    # each device op, linked to the host op that launched it
    launches = [(e.time_range.start,
                 sum(k.duration for k in e.kernels) / 1e6)
                for e in events
                if e.device_type != torch.autograd.DeviceType.CUDA
                and e.kernels]
    stretch = [h for h in host if h[0] == "stretch"]
    lo, hi = ((stretch[0][1], stretch[0][2]) if stretch else
              (min((s for _, s, _ in dev), default=0.0),
               max((e for _, _, e in dev), default=0.0)))
    busy, gaps, end = 0.0, {}, lo
    for _, s, e in dev:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > end:
            _name_gap(gaps, host, end, s)
        if e > end:
            busy += e - max(s, end)
            end = e
    if hi > end:
        _name_gap(gaps, host, end, hi)
    return Profile(units=n, wall_s=wall_s, busy_s=busy / 1e6,
                   device_ops=dev,
                   gaps=gaps, launches=launches, spans=host)


def _name_gap(gaps, host, a, b):
    """Credit the idle span [a, b] (us) to the innermost benchmark span
    that holds its midpoint on the host."""
    mid = 0.5 * (a + b)
    best = None
    for name, s, e in host:
        if s <= mid <= e and (best is None or e - s < best[2] - best[1]):
            best = (name, s, e)
    key = best[0] if best else "outside the spans"
    gaps[key] = gaps.get(key, 0.0) + (b - a) / 1e6
