"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

(``python3 benchmark/run.py ...`` runs the same.) The cell, its
configuration, its traffic mix and its metrics are found by name from
``BENCHMARK.json``: ``benchmark/configs/<config>.json``,
``benchmark/traffic/<traffic>.json``, ``benchmark/metrics/<metric>.py``,
``benchmark/limits/<cell>.json``, and the traffic mix's ``kind``,
``benchmark/kinds/<kind>.py`` (see ``load_kind``).

A run builds the kind's cell from the seed (the program's state and
what it is fed), warms up every shape the traffic uses (its first,
checked calls and the warm-up calls), measures for ``--seconds`` and
reads the peak memory. With ``--trace 1`` it then profiles a short
stretch of the same calls, and the per-layer metrics are read from that
trace. It frees the program's state, runs the kind's
check, and prints each number compared beside its limit as the last
lines of standard error and, as the last line of standard output, the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``.

It exits non-zero and prints no result without a CUDA card (or with
fewer than the cell asks for), and when ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``gslidar_tpu`` is loaded once the window has closed or
when the result is about to be printed.

``--control <name>`` is not a run of the program: it runs the kind's
control of that name (``kinds/<kind>.py``'s ``CONTROLS``), the
reference put in the program's place and run wrong on purpose, and
prints the numbers it reads against the reference, to set and test the
limits.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")

import numpy as np  # noqa: E402
import torch  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gslidar_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``gslidar_tpu_torch`` is not ``gslidar_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_spec(path=None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


BENCH_DIR = os.path.join(ROOT, "benchmark")
DATA_DIR = BENCH_DIR


def bench_file(*parts) -> str:
    """A data file of the benchmark: ``DATA_DIR`` holds ``configs/``,
    ``traffic/``, ``limits/`` and ``kinds/``."""
    return os.path.join(DATA_DIR, *parts)


def load_json(*parts) -> dict:
    with open(bench_file(*parts)) as f:
        return json.load(f)


def load_module(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str):
    return load_module("benchmark_metric_" + name.replace(".", "_"),
                       os.path.join(BENCH_DIR, "metrics", f"{name}.py"))


def load_kind(name: str):
    """The module of a traffic mix's ``kind``: ``kinds/<kind>.py`` under
    ``DATA_DIR``, else under ``benchmark/``. It gives

    * ``Cell(config, traffic, seed, device)``, the system under test as
      the traffic drives it: ``first_steps()``, the checked calls, which
      keep in ``record`` what the check needs of the program's run;
      ``call(i)``, one call of the warm-up or the window; ``again(i)``
      and ``traced_calls``, the calls of the traced stretch; ``free()``;
    * ``check(config, traffic, seed, record, device)``, run once the
      program's state is freed: ``(numbers, lines, extras)``, the numbers
      compared, named as in ``limits/<cell>.json`` and with
      ``same_inputs``, 0 when the reference was handed the program's
      inputs; lines for standard error; and what the metric readers read
      besides the run (``Context``), such as ``work``;
    * ``CONTROLS``, the names of its controls, and ``control(name,
      config, traffic, seed, device)``, the numbers one reads.

    Which cells report which metric is ``BENCHMARK.json``'s to say (a
    metric's ``workloads``), not the kind's.
    """
    for d in (DATA_DIR, BENCH_DIR):
        path = os.path.join(d, "kinds", f"{name}.py")
        if os.path.exists(path):
            return load_module("benchmark_kind_" + name, path)
    raise FileNotFoundError(f"no kinds/{name}.py for the traffic kind "
                            f"{name!r}")


def cell_metrics(spec: dict, workload: str):
    """(end-to-end, per-layer) metric entries a cell reports."""
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if workload in m.get("workloads", [workload])
             and m["moves"] in names]
    return e2e, layer


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def free_device():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class Context:
    """What the metric readers read (``benchmark/metrics/<name>.py``:
    ``read(ctx)``, after the check): the run's ``kind``, the set-up, the
    window, the peak, the ``profile`` of a traced run, ``work`` (None
    where the kind counts none) and the extras of the kind's check, which
    may add keys and replace none but ``work``."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run_window(cell, seconds: float, device):
    """Calls back to back for ``seconds``; returns (calls, window s, each
    call's s on the host clock)."""
    lat = []
    sync(device)
    t0 = time.perf_counter()
    n = 0
    while True:
        ts = time.perf_counter()
        if ts - t0 >= seconds:
            break
        cell.call(n)
        lat.append(time.perf_counter() - ts)
        n += 1
    sync(device)
    return n, time.perf_counter() - t0, lat


def refuse_check(numbers: dict, limits: dict, extras: dict, ctx) -> None:
    """Raise where a kind's check does not compare exactly the numbers
    that ``limits/<cell>.json`` and ``same_inputs`` name, or where its
    extras would replace what the harness measured (``work`` excepted)."""
    if set(numbers) != set(limits):
        raise ValueError(
            f"the kind's check compares {sorted(numbers)}, the cell's "
            f"limits name {sorted(limits)}: left out "
            f"{sorted(set(limits) - set(numbers))}, without a limit "
            f"{sorted(set(numbers) - set(limits))}")
    clash = sorted(set(extras) & (set(vars(ctx)) - {"work"}))
    if clash:
        raise ValueError(f"the kind's check would replace {clash}, which "
                         f"the harness measured")


def run_cell(spec: dict, workload: str, seed: int, seconds: float,
             trace: bool, device) -> dict:
    from benchmark import tracing

    cellspec = next(w for w in spec["workloads"] if w["name"] == workload)
    config = load_json("configs", f"{cellspec['config']}.json")
    traffic = load_json("traffic", f"{cellspec['traffic']}.json")
    limits = {k: v["limit"] for k, v in
              load_json("limits", f"{workload}.json")["limits"].items()}
    limits["same_inputs"] = 0
    kind = load_kind(traffic["kind"])
    e2e, layer = cell_metrics(spec, workload)
    metrics = layer if trace else e2e
    readers = {m["name"]: load_reader(m["name"]) for m in metrics}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # set-up: the cell, its checked first steps, the warm-up
    cell = kind.Cell(config, traffic, seed, device)
    cell.first_steps()
    for _ in range(int(traffic["warmup_steps"])):
        cell.call()
    sync(device)
    setup_s = time.perf_counter() - T_START

    n, window_s, lat = run_window(cell, seconds, device)
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)
    after_window = forbidden_modules()

    ctx = Context(kind=traffic["kind"], device=device, setup_s=setup_s,
                  calls=n, window_s=window_s, latencies_s=lat,
                  peak_bytes=peak, profile=None, work=None)
    if trace:
        for i in range(2):
            cell.again(i)
        ctx.profile = tracing.profile(cell.again, cell.traced_calls,
                                      ctx.kind)

    record = cell.record
    cell.free()
    cell = None
    free_device()

    numbers, lines, extras = kind.check(config, traffic, seed, record,
                                        device)
    for line in lines:
        print(line, file=sys.stderr)
    refuse_check(numbers, limits, extras, ctx)
    ctx.__dict__.update(extras)
    free_device()

    checked = {k: {"value": v, "limit": limits[k]} for k, v in
               numbers.items()}
    correct = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checked.values())
    out_metrics = {}
    for m in metrics:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            out_metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": int(cellspec["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": n, "failed": 0,
              "metrics": out_metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = ctx.profile.busy_s
        device_info["window_s"] = ctx.profile.wall_s
        result["breakdown"] = {"device_ops": ctx.profile.top_ops(10),
                               "idle_gaps": ctx.profile.top_gaps(10)}
        print(f"device time launched inside the spans: "
              f"{ctx.profile.attributed_s:.6g} of "
              f"{ctx.profile.device_total_s:.6g} s", file=sys.stderr)
    result["checks"] = checked
    result["forbidden_after_window"] = after_window
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", help="a control of the cell's kind")
    a = p.parse_args(argv)
    spec = load_spec()
    cellspec = next((w for w in spec["workloads"]
                     if w["name"] == a.workload), None)
    if cellspec is None:
        print(f"no workload {a.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cellspec["chips"]):
        print(f"the cell needs {cellspec['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if a.control:
        from benchmark.controls import run_control
        print(json.dumps(run_control(spec, a.workload, a.seed, a.control,
                                     device)))
        return 0
    result = run_cell(spec, a.workload, a.seed, a.seconds, bool(a.trace),
                      device)
    return report(result)


def report(result: dict) -> int:
    """Print the numbers compared and the result line; the exit code.

    The look for JAX is made again here, just before the line is printed,
    so that it covers everything the run did after the window too: the
    traced stretch, the metric readers and the reference check."""
    bad = sorted(set(result.pop("forbidden_after_window"))
                 | set(forbidden_modules()))
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']:.6g} (limit {c['limit']:.6g})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
