"""Dependent elementwise op chains: the CUDA kernel's wrapper, its plain
version and the microbenchmark entry point (port of
scripts/microbench_vpu_ops.py::make_case's Pallas kernel).

    python -m gslidar_tpu_torch.microbench.vpu_ops [--device cuda|cpu]
        [--reps N] [--cols C]

A chain applies one op ``ops_per_step`` times and then ``v - floor(v)``,
for ``steps`` iterations, to a [256, 512] block in float32 or bfloat16.
The cases (``CASES``) are the script's; each constant is rounded to the
working type, as ``jnp.asarray(c, dtype)`` rounds it, and every op rounds
to the working type.

``op_chain`` is the wrapper: CPU tensors go to the plain version,
``op_chain_reference`` (torch ops in the working type, ``torch.roll`` for
the rolls), CUDA tensors to the kernel in ``csrc/op_chain.cu``, anything
else raises. The entry point prints the script's table, ns per full-block
op in float32 and bfloat16, from CUDA events: a full-block op takes
nanoseconds and a launch microseconds, so it times each chain at
``STEPS`` (64, the script's function) and ``STEPS_HI`` (512) steps and
reports the slope between the two, beside the least time of one op
(``bounds.chain_op_bound``). On the CPU it times the plain version.
``--cols`` widens the block (the script's 512 by default): a wider block
gives each of the card's schedulers more independent chains, so a chain
whose slope per element falls with the width was held by latency, not by
its instructions' issue.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gslidar_tpu_torch.microbench import bounds
from gslidar_tpu_torch.microbench.timing import entry_device, median_ms

SUB, LANE = 256, 512
STEPS = 64
STEPS_HI = 512
SEED = 0
REPS = 5
DTYPES = (torch.float32, torch.bfloat16)


def _k(c: float, v: torch.Tensor) -> torch.Tensor:
    """The constant c rounded to v's type, on v's device."""
    return torch.full((), c, dtype=v.dtype, device=v.device)


# name -> (op, ops_per_step); the order is csrc/op_chain.cu's Case enum
CASES = {
    "mul": (lambda v: v * _k(1.0000001, v), 32),
    "fma": (lambda v: v * _k(0.9999, v) + _k(1e-6, v), 32),
    "select": (lambda v: torch.where(v > _k(0.5, v), v, v * v), 32),
    "exp": (lambda v: torch.exp(-v), 8),
    "div": (lambda v: _k(0.9999, v) / (v + _k(1.0, v)), 8),
    "rsqrt": (lambda v: torch.rsqrt(v + _k(1.0, v)), 8),
    "roll1": (lambda v: torch.roll(v, 1, 0) * _k(1.0000001, v), 16),
    "roll8": (lambda v: torch.roll(v, 8, 0) * _k(1.0000001, v), 16),
}
_CASE_ID = {name: i for i, name in enumerate(CASES)}
_DTYPE_ID = {torch.float32: 0, torch.bfloat16: 1}

# kernel vs plain: float32 bit for bit on every element where both run
# the same IEEE operations; within ATOL_F32 where each calls its own expf,
# division or rsqrtf, and bfloat16 within one bfloat16 ulp, each of these
# on MIN_AGREE of the elements, since a floor that wraps near 1.0 may flip
# an element. On the card the kernel's division is the IEEE quotient, as
# torch's is, so there float32 div is held bit for bit too (CARD_EXACT_F32;
# on the CPU the plain version is held against XLA's CPU division).
EXACT_F32 = ("mul", "fma", "select", "roll1", "roll8")
CARD_EXACT_F32 = EXACT_F32 + ("div",)
ATOL_F32 = 1e-5
MIN_AGREE = 0.999
# the step counts at which a chain is held against its plain version: the
# script's 64, and 1, where a roll chain moves the block by 16 (roll1) or
# 128 (roll8) rows; at 64 steps both moves are multiples of 256, so a roll
# chain ends where it started whether or not the rolls are right
CHECK_STEPS = (1, STEPS)
ROLL_BY = {"roll1": 1, "roll8": 8}


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at each |v| (float32)."""
    _, e = torch.frexp(v.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def exact_f32(case: str, on_card: bool = False) -> bool:
    """Whether the float32 chain of ``case`` is held bit for bit."""
    return case in (CARD_EXACT_F32 if on_card else EXACT_F32)


def agreement(got: torch.Tensor, want: torch.Tensor, case: str) -> float:
    """Share of the elements of got within the chain's bar of want (the
    card's bar where got lies on the card)."""
    d = (got.float() - want.float()).abs()
    if want.dtype == torch.bfloat16:
        ok = d <= bf16_ulp(want)
    elif exact_f32(case, got.is_cuda):
        ok = d == 0
    else:
        ok = d <= ATOL_F32
    return float(ok.float().mean())


def required_agreement(case: str, dtype: torch.dtype,
                       on_card: bool = False) -> float:
    """The share of the elements that must meet the chain's bar."""
    return 1.0 if dtype == torch.float32 and exact_f32(case, on_card) \
        else MIN_AGREE


def roll_rows(case: str, steps: int) -> int:
    """Rows (mod 256) a chain of ``case`` moves the block by."""
    return ROLL_BY.get(case, 0) * CASES[case][1] * steps % SUB


def check(x: torch.Tensor, case: str) -> list[dict]:
    """``op_chain`` on x against its plain version at every CHECK_STEPS.

    In bfloat16 the roll cases' 1.0000001 rounds to 1, and on a block in
    [0, 1) v - floor(v) is v, so a roll chain is only its rolls: there it
    is also held bit for bit against ``torch.roll`` by ``roll_rows``, an
    oracle that shares no code with the plain version. Returns one dict
    per comparison: ``what``, ``agree`` (the share of elements within the
    bar), ``required``, ``max_abs`` and ``ok`` (which also needs finite
    values of x's shape and type).
    """
    out = []
    for steps in CHECK_STEPS:
        at = f"{steps} step{'s' if steps != 1 else ''}"
        got = op_chain(x, case, steps)
        sound = (got.dtype == x.dtype and got.shape == x.shape
                 and bool(torch.isfinite(got).all()))
        want = op_chain_reference(x, case, steps)
        shares = [(f"plain, {at}", agreement(got, want, case),
                   required_agreement(case, x.dtype, x.is_cuda), want)]
        if x.dtype == torch.bfloat16 and case in ROLL_BY:
            rolled = torch.roll(x, roll_rows(case, steps), 0)
            shares.append((f"torch.roll by {roll_rows(case, steps)} rows, "
                           f"{at}",
                           float((got == rolled).float().mean()), 1.0,
                           rolled))
        for what, agree, required, w in shares:
            out.append(dict(what=what, agree=agree, required=required,
                            max_abs=float((got.float() - w.float()).abs()
                                          .max()),
                            ok=sound and agree >= required))
    return out


def base_block(device, dtype=torch.float32, cols=LANE) -> torch.Tensor:
    """The script's seeded block: uniform(0.25, 0.75, (256, cols)), cols
    512 in the script."""
    base = np.random.default_rng(SEED).uniform(0.25, 0.75, (SUB, cols))
    return torch.from_numpy(base.astype(np.float32)).to(device, dtype)


def op_chain_reference(x: torch.Tensor, case: str,
                       steps: int = STEPS) -> torch.Tensor:
    """Plain PyTorch version of the chain."""
    op, n = CASES[case]
    v = x
    for _ in range(steps):
        for _ in range(n):
            v = op(v)
        v = v - torch.floor(v)
    return v


def _check_inputs(x, case, steps):
    if case not in CASES:
        raise ValueError(f"unknown case {case!r} (have {sorted(CASES)})")
    if x.dtype not in _DTYPE_ID:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] != SUB or \
            (x.dtype == torch.bfloat16 and x.shape[1] % 2):
        raise ValueError(f"x must be [{SUB}, cols] (cols even in "
                         f"bfloat16), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")


def op_chain(x: torch.Tensor, case: str, steps: int = STEPS) -> torch.Tensor:
    """The chain of ``case`` on the [256, cols] block x.

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (``op_chain.launches`` counts those launches); any
    other device raises.
    """
    _check_inputs(x, case, steps)
    if x.device.type == "cpu":
        return op_chain_reference(x, case, steps)
    if x.device.type != "cuda":
        raise ValueError(f"op_chain runs on cpu or cuda tensors, not "
                         f"{x.device}")
    from gslidar_tpu_torch.kernels import load_library
    lib = load_library()
    out = torch.empty_like(x)
    dev = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    with torch.cuda.device(dev):
        err = lib.gslidar_op_chain(dev, _DTYPE_ID[x.dtype], _CASE_ID[case],
                                   steps, x.data_ptr(), out.data_ptr(),
                                   x.shape[1],
                                   torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"op_chain kernel launch failed: CUDA error {err}")
    op_chain.launches += 1
    return out


op_chain.launches = 0


def slope(x, case, reps=REPS, steps_hi=STEPS_HI):
    """ms of the chain at ``STEPS`` and ``steps_hi`` steps (median of reps
    after a warm-up) and the slope between them in ns per full-block
    op."""
    ops = CASES[case][1]
    lo = lambda: op_chain(x, case, STEPS)                  # noqa: E731
    hi = lambda: op_chain(x, case, steps_hi)               # noqa: E731
    lo()
    hi()
    ms_lo = median_ms(lo, x.device, reps, warmup=0)
    ms_hi = median_ms(hi, x.device, reps, warmup=0)
    return ms_lo, ms_hi, (ms_hi - ms_lo) * 1e6 / ((steps_hi - STEPS) * ops)


def run(device, reps=REPS, steps_hi=STEPS_HI, cols=LANE):
    """Time every case in both types on a [256, cols] block. Returns one
    dict per (case, dtype): ms at ``STEPS`` and ``steps_hi`` (median of
    reps after a warm-up), the slope in ns per full-block op, and on the
    card the bounds of one op and of the chain at ``STEPS`` (at the card's
    maximum SM clock)."""
    device = torch.device(device)
    clock_hz = (bounds.max_sm_clock_hz() if device.type == "cuda"
                else None)
    rows = []
    for case, (_, ops) in CASES.items():
        for dtype in DTYPES:
            x = base_block(device, dtype, cols)
            ms_lo, ms_hi, ns = slope(x, case, reps, steps_hi)
            r = dict(case=case, dtype=str(dtype).replace("torch.", ""),
                     ops=ops, ms=ms_lo, ms_hi=ms_hi, ns_per_op=ns)
            if clock_hz is not None:
                packed = dtype == torch.bfloat16
                r["op_bound_ns"] = bounds.chain_op_bound(
                    case, x.numel(), packed, clock_hz).ms * 1e6
                r["bound"] = bounds.chain_bound(
                    case, ops, STEPS, x.numel(), x.element_size(), packed,
                    clock_hz)
            rows.append(r)
    return rows


def launch_info(case: str, dtype: torch.dtype, cols: int = LANE,
                device: int = 0) -> dict:
    """The kernel's launch for the chain of ``case`` in ``dtype`` on a
    [256, cols] block: ``kernels.op_chain_resources``."""
    from gslidar_tpu_torch.kernels import op_chain_resources
    return op_chain_resources(_DTYPE_ID[dtype], _CASE_ID[case], cols,
                              device=device)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--reps", type=int, default=REPS)
    parser.add_argument("--cols", type=int, default=LANE,
                        help="block width (even)")
    a = parser.parse_args(argv)
    device = entry_device(a.device)
    on_card = device.type == "cuda"
    # the plain version at 512 steps is ~17k small launches a case
    rows = run(device, a.reps, steps_hi=STEPS_HI if on_card else 2 * STEPS,
               cols=a.cols)
    where = (torch.cuda.get_device_name(device) if on_card
             else "cpu (the plain version, no kernel)")
    print(f"block [{SUB},{a.cols}]  steps {STEPS}  on {where}  (ns per "
          f"full-block op, slope between {STEPS} and "
          f"{STEPS_HI if on_card else 2 * STEPS} steps"
          + ("; bound at the maximum SM clock)" if on_card else ")"))
    print(f"{'case':8s} {'f32':>9s} {'bound':>7s} {'bf16':>9s} {'bound':>7s}"
          f" {'f32 ms':>8s} {'bf16 ms':>8s}")
    by_case = {}
    for r in rows:
        by_case.setdefault(r["case"], {})[r["dtype"]] = r
    for case, d in by_case.items():
        f, b = d["float32"], d["bfloat16"]
        print(f"{case:8s} {f['ns_per_op']:9.2f} "
              f"{f.get('op_bound_ns', float('nan')):7.2f} "
              f"{b['ns_per_op']:9.2f} {b.get('op_bound_ns', float('nan')):7.2f}"
              f" {f['ms']:8.4f} {b['ms']:8.4f}")
    return rows


if __name__ == "__main__":
    main()
