"""Spawned gloo ranks for the parallel tests of gslidar_tpu_torch.

``run_ranks(fn, n, *args, timeout=...)`` starts n processes (the spawn
method), each of which sets one CPU thread, joins a gloo group of n ranks
on a free localhost port and returns ``fn(rank, n, *args)`` through a
queue. ``fn`` must be a module-level function and return picklable data
(numpy, not tensors). The parent drains the queue, joins every rank
within the time limit, kills what is left, and re-raises a rank's error
with its traceback, so a hung collective fails its test instead of
holding the suite.
"""

import multiprocessing as mp
import queue
import socket
import time
import traceback
from datetime import timedelta


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, n, port, args, out, coll_timeout):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=n, timeout=timedelta(seconds=coll_timeout))
        out.put((rank, True, fn(rank, n, *args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, n, *args, timeout=120):
    """[fn(r, n, *args) for each rank r], run on n spawned gloo ranks."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, port, args, out, timeout),
                         daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(n)) - set(results))}"
                                   f" gave no result within {timeout} s")
            try:
                rank, ok, val = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in results]
                if dead:
                    time.sleep(0.5)             # a last message in flight
                    if out.empty():
                        raise RuntimeError(f"ranks {dead} exited with "
                                           f"{[procs[r].exitcode for r in dead]}"
                                           " and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{val}")
            results[rank] = val
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [results[r] for r in range(n)]
