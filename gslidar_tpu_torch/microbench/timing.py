"""One call's time: CUDA events on the card, the host clock on the CPU."""

from __future__ import annotations

import time

import torch


def time_ms(fn, device: torch.device) -> float:
    """ms of one call of fn; on the card between two CUDA events, after
    which the card is synchronised."""
    if device.type == "cuda":
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        fn()
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3
