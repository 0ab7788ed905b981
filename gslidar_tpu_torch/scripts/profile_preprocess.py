"""Which code launches each device op of the preprocess pass: the bench
scene's 360-degree preprocess under ``torch.profiler`` with Python stacks.

    python -m gslidar_tpu_torch.scripts.profile_preprocess [--points
        1000000] [--plain] [--calls 5] [--top 12] [--device cuda|cpu]

``bench.build_scene``'s gaussians, preprocessed as ``bench.render_360``
preprocesses them (66x1030, wrap_x, SH degree 3) ``--calls`` times after
a warm-up, through the package's public ``preprocess`` or, with
``--plain``, its plain PyTorch version ``preprocess_reference``. It prints
the card, the ms of one call by CUDA events (median), then the ``--top``
device ops by device time per call, each with its launches per call, the
chain of aten ops that launched it (innermost first) and the lines of
this package that call the outermost of them (with how many calls each
makes in one preprocess). Run from a checkout of an earlier commit
(``PYTHONPATH=<checkout> python <this file>``) it profiles that commit's
``preprocess``; ``--plain`` needs a package that has
``preprocess_reference``.
"""

from __future__ import annotations

import argparse
import collections
import statistics

import torch

from gslidar_tpu_torch.bench import (SCALE_FACTOR, SH_DEGREE, bench_settings,
                                     build_scene)
from gslidar_tpu_torch.microbench.timing import card, entry_device, time_ms

PACKAGE = "gslidar_tpu_torch"


def launch_site(evt):
    """(the aten ops from ``evt`` outward, the innermost frame of this
    package on the first stack found on the way)."""
    ops, frame, e = [], None, evt
    while e is not None:
        ops.append(e.name)
        if frame is None:
            frame = next((f for f in (e.stack or []) if PACKAGE in f), None)
        e = e.cpu_parent
    return ops, frame


def call_sites(fn):
    """{torch function name: Counter of the lines of this package that
    called it} over one call of fn (a ``TorchFunctionMode``: the
    profiler's own stacks come back empty on the card's machine)."""
    import traceback
    from torch.overrides import TorchFunctionMode
    sites = collections.defaultdict(collections.Counter)

    class Mode(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            where = next((f"{f.filename.split(PACKAGE + '/')[-1]}:{f.lineno}"
                          for f in reversed(traceback.extract_stack())
                          if f"{PACKAGE}/" in f.filename
                          and "scripts/" not in f.filename), "?")
            name = getattr(func, "__name__", str(func)).strip("_")
            sites[name][where] += 1
            return func(*args, **(kwargs or {}))

    with Mode():
        fn()
    return sites


def profile(fn, calls):
    """{(device op, aten ops, frame): [device ms, launches]} per call."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  with_stack=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        for k in getattr(e, "kernels", ()):
            ops, frame = launch_site(e)
            key = (k.name, " < ".join(ops[:4]), frame or "?")
            rows[key][0] += k.duration / 1e3 / calls
            rows[key][1] += 1
    for v in rows.values():
        v[1] /= calls
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--points", type=int, default=1_000_000)
    p.add_argument("--plain", action="store_true",
                   help="the plain PyTorch version, preprocess_reference")
    p.add_argument("--calls", type=int, default=5)
    p.add_argument("--top", type=int, default=12)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    device = entry_device(a.device)
    from gslidar_tpu_torch.raster import preprocess as pre
    fn = pre.preprocess_reference if a.plain else pre.preprocess
    sc = build_scene(a.points, 0, device)
    s = bench_settings()
    eye, zero = torch.eye(4, device=device), torch.zeros(3, device=device)

    def call():
        with torch.no_grad():
            fn(sc["means3D"], sc["scales"], sc["rotations"], sc["opacity"],
               sc["shs"], sc["mask"], eye, zero, SH_DEGREE, SCALE_FACTOR, s)

    call()
    ms = statistics.median(time_ms(call, device) for _ in range(a.calls))
    name = "preprocess_reference" if a.plain else "preprocess"
    print(f"{card(device)} | {name} of {a.points} gaussians at "
          f"{s.height}x{s.width}: {ms:.3f} ms a call (median of {a.calls}; "
          f"{'CUDA events' if device.type == 'cuda' else 'host clock'})",
          flush=True)
    if device.type != "cuda":
        return
    rows = sorted(profile(call, a.calls).items(), key=lambda kv: -kv[1][0])
    sites = call_sites(call)
    total = sum(v[0] for _, v in rows)
    print(f"device time {total:.3f} ms a call in "
          f"{sum(v[1] for _, v in rows):g} launches; the top {a.top}:")
    for (kernel, ops, frame), (dev_ms, n) in rows[:a.top]:
        # the outermost aten op's callers in this package
        top = ops.split(" < ")[-1].split("::")[-1]
        callers = sites.get(top) or sites.get(top.rstrip("_")) or {}
        where = frame if frame != "?" else ", ".join(
            f"{k} x{v}" for k, v in sorted(callers.items()))
        print(f"  {dev_ms:.3f} ms, {n:g} launches | {kernel[:70]} | {ops} "
              f"| called from {where or '?'}", flush=True)


if __name__ == "__main__":
    main()
