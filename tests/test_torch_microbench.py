"""The port's microbenchmark kernels against the Pallas kernels they
replace, and the least-time bounds.

* op chains: ``scripts/microbench_vpu_ops.py``'s ``make_case`` in Pallas
  interpret mode, for the script's 8 cases (restated from its ``main``,
  where they are local) in float32 and bfloat16, against
  ``op_chain_reference`` and the ``op_chain`` wrapper on CPU tensors;
* the row gather: the script's own oracle ``table[gid]`` and a verbatim
  copy of its ``_gather_kernel`` (a closure inside its ``main``) in
  interpret mode, against ``gather_rows_reference`` and ``gather_rows``;
* the op-chain kernel's roll layout (``roll_layout``: the kernel's index
  maps run on the CPU) against ``torch.roll``;
* the ``cuda``-marked cases: each kernel against its plain version on the
  card, and the division on whole warps of in-range divisors and over
  every exponent (they skip without one);
* ``bounds``: a hand-countable compositor scene, the gather's bytes and
  the op chains' issue bounds;
* ``timing``: ``median_ms`` and ``calls_per_sec`` on the CPU (their call
  counts, and times no shorter than a known sleep), ``entry_device``
  refusing ``cuda`` without a card; on the card, CUDA events.

``scripts/`` is no package, so the script is loaded by path. JAX is
imported inside the tests that use it, so that the card-only cases also
run where JAX is not installed.
"""

import functools
import importlib.util
import os
import time

import numpy as np
import pytest
import torch

from gslidar_tpu_torch.microbench import bounds, dma_gather, timing, vpu_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def vpu_script(monkeypatch):
    mod = _load_script("microbench_vpu_ops")
    monkeypatch.setattr(mod.pl, "pallas_call",
                        functools.partial(mod.pl.pallas_call, interpret=True))
    return mod


def jax_cases():
    """scripts/microbench_vpu_ops.py:87-101."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    return {
        "mul": (lambda v: v * jnp.asarray(1.0000001, v.dtype), 32),
        "fma": (lambda v: v * jnp.asarray(0.9999, v.dtype)
                + jnp.asarray(1e-6, v.dtype), 32),
        "select": (lambda v: jnp.where(
            v > jnp.asarray(0.5, v.dtype), v, v * v), 32),
        "exp": (lambda v: jnp.exp(-v), 8),
        "div": (lambda v: jnp.asarray(0.9999, v.dtype) / (
            v + jnp.asarray(1.0, v.dtype)), 8),
        "rsqrt": (lambda v: jax.lax.rsqrt(v + jnp.asarray(1.0, v.dtype)),
                  8),
        "roll1": (lambda v: pltpu.roll(v, 1, 0)
                  * jnp.asarray(1.0000001, v.dtype), 16),
        "roll8": (lambda v: pltpu.roll(v, 8, 0)
                  * jnp.asarray(1.0000001, v.dtype), 16),
    }


# XLA's CPU compiler computes two float32 cases in other arithmetic than
# the Pallas kernel's op-by-op chain, which the port keeps: it folds a
# step's 32 constant multiplies into one by fl(c^32) (mul), and contracts
# v * c1 + c2 into one FMA (fma). Over 64 steps of 32 ops the two differ
# by at most ~2048 half-ulps of values < 1 (~6e-5), and no value wraps.
XLA_REWRITTEN_F32 = {"mul", "fma"}
XLA_REWRITTEN_ATOL = 1e-4


def test_cases_are_the_scripts():
    cases = jax_cases()
    assert list(vpu_ops.CASES) == list(cases)
    assert {k: n for k, (_, n) in vpu_ops.CASES.items()} == \
        {k: n for k, (_, n) in cases.items()}


@pytest.mark.parametrize("steps", vpu_ops.CHECK_STEPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(vpu_ops.CASES))
def test_op_chain_matches_pallas(case, dtype, steps, vpu_script,
                                 monkeypatch):
    """Within one bfloat16 ulp (bfloat16), 1e-5 (float32 exp, div,
    rsqrt), each on >= 99.9 % of the elements, XLA_REWRITTEN_ATOL (float32
    mul, fma) or bit for bit on every element (float32 select, roll1,
    roll8). At 1 step the rolls move the block by 16 or 128 rows (at 64,
    by a multiple of 256)."""
    import jax.numpy as jnp
    monkeypatch.setattr(vpu_script, "STEPS", steps)
    op, ops = jax_cases()[case]
    jdt = getattr(jnp, dtype)
    base = np.random.default_rng(0).uniform(0.25, 0.75, (256, 512))
    base = base.astype(np.float32)
    want = np.asarray(vpu_script.make_case(op, jdt, ops)(
        jnp.asarray(base, jdt)).astype(jnp.float32))
    x = vpu_ops.base_block("cpu", getattr(torch, dtype))
    np.testing.assert_array_equal(x.float().numpy(),
                                  np.asarray(jnp.asarray(base, jdt),
                                             np.float32))
    plain = vpu_ops.op_chain_reference(x, case, steps)
    got = vpu_ops.op_chain(x, case, steps)
    # torch's CPU exp is not bitwise repeatable (its vectorized body and
    # scalar tail split where the threads' chunks fall), so the wrapper
    # and the plain version are held to the chain bars too
    required = vpu_ops.required_agreement(case, x.dtype)
    assert vpu_ops.agreement(got, plain, case) >= required
    assert got.dtype == x.dtype and got.shape == (256, 512)
    want_t = torch.from_numpy(want.copy()).to(x.dtype)
    if dtype == "float32" and case in XLA_REWRITTEN_F32:
        d = (got - want_t).abs()
        assert float(d.max()) <= XLA_REWRITTEN_ATOL
        assert float((d > 0).float().mean()) > 0.5      # it is rewritten
    else:
        assert vpu_ops.agreement(got, want_t, case) >= required
    if case in vpu_ops.ROLL_BY:
        assert vpu_ops.roll_rows(case, steps) == (0 if steps == 64 else
                                                  16 * vpu_ops.ROLL_BY[case])
    if dtype == "bfloat16" and case in vpu_ops.ROLL_BY:
        # 1.0000001 rounds to 1 in bfloat16: the chain is its rolls alone
        assert torch.equal(want_t, torch.roll(
            x, vpu_ops.roll_rows(case, steps), 0))


@pytest.mark.parametrize("dtype", vpu_ops.DTYPES)
def test_op_chain_check_catches_a_wrong_roll(dtype, monkeypatch):
    """vpu_ops.check, which chip_smoke.py and the card case run, on chains
    that roll wrongly: at 64 steps they pass (the block comes home), at 1
    step every comparison of the roll fails. The wrong rolls: none; one
    within each 32-row block (a lane-strided layout whose lanes l < s keep
    their own register); and, for roll1, the other way (for roll8 that is
    no fault: 16 rolls by -8 move the block by 128 rows too)."""
    x = vpu_ops.base_block("cpu", dtype)
    assert all(r["ok"] for case in vpu_ops.CASES
               for r in vpu_ops.check(x, case))
    reference = vpu_ops.op_chain_reference
    wrongs = {
        "none": (lambda v, s: v, ("roll1", "roll8")),
        "within 32-row blocks": (lambda v, s: torch.roll(
            v.view(8, 32, -1), s, 1).reshape(v.shape), ("roll1", "roll8")),
        "the other way": (lambda v, s: torch.roll(v, -s, 0), ("roll1",)),
    }
    for wrong, cases in wrongs.values():
        def broken(x, case, steps=vpu_ops.STEPS):
            if case not in vpu_ops.ROLL_BY:
                return reference(x, case, steps)
            s = vpu_ops.ROLL_BY[case]
            v = x
            for _ in range(steps):
                for _ in range(vpu_ops.CASES[case][1]):
                    v = wrong(v, s) * vpu_ops._k(1.0000001, v)
                v = v - torch.floor(v)
            return v
        monkeypatch.setattr(vpu_ops, "op_chain", broken)
        for case in cases:
            rs = vpu_ops.check(x, case)
            assert [r["ok"] for r in rs if "64 steps" in r["what"]] == \
                [True] * (1 + (dtype == torch.bfloat16))
            assert not any(r["ok"] for r in rs if "64 steps" not in r["what"])


def roll_layout(v: torch.Tensor, s: int, swap: bool = True) -> torch.Tensor:
    """csrc/op_chain.cu's roll by s rows (F32::roll, BF16::roll and
    RollLayout) on the CPU, through the registers as the kernel holds
    them: one column per warp, row c + s q in register m of lane
    c * J + j, J = 32 / s, q = R j + m; float32 R = 8 over the 256 rows,
    bfloat16 R = 4 over rows 0..127, each register packing its row and the
    row + 128 (the last axis below). Register m takes register m - 1, and
    register 0 of lane (c, j) register R - 1 of lane (c, j - 1 mod J) (the
    shuffle), halves swapped for j = 0 in bfloat16 (``swap``: the byte
    permute)."""
    packed = v.dtype == torch.bfloat16
    R, J, halves = (4 if packed else 8), 32 // s, (2 if packed else 1)
    lane = torch.arange(32)[:, None]
    m = torch.arange(R)[None, :]
    rows = (lane // J + s * (R * (lane % J) + m))[..., None] \
        + 128 * torch.arange(halves)                     # [lane, m, half]
    regs = v[rows]                                       # [32, R, h, cols]
    src = lane[:, 0] - lane[:, 0] % J + (lane[:, 0] % J + J - 1) % J
    t = regs[src, R - 1]
    if packed and swap:
        t = torch.where((lane[:, 0] % J == 0)[:, None, None], t.flip(1), t)
    new = torch.cat([t[:, None], regs[:, :R - 1]], 1)
    out = torch.empty_like(v)
    out[rows] = new
    return out


@pytest.mark.parametrize("steps", vpu_ops.CHECK_STEPS)
@pytest.mark.parametrize("dtype", vpu_ops.DTYPES)
@pytest.mark.parametrize("case", list(vpu_ops.ROLL_BY))
def test_roll_layout_is_torch_roll(case, dtype, steps):
    """The rolls' register layout, run on the CPU, bit for bit against
    torch.roll, one roll and a whole chain's rolls (16 a step); every row
    is held once."""
    s = vpu_ops.ROLL_BY[case]
    x = vpu_ops.base_block("cpu", dtype)
    assert torch.equal(roll_layout(x, s), torch.roll(x, s, 0))
    v = x
    for _ in range(steps * vpu_ops.CASES[case][1]):
        v = roll_layout(v, s)
    assert torch.equal(v, torch.roll(x, vpu_ops.roll_rows(case, steps), 0))


def test_op_chain_check_catches_a_half_swap(monkeypatch):
    """vpu_ops.check on bfloat16 rolls whose lanes j = 0 take register 3
    of lane (c, J - 1) without swapping its halves (rows r and r + 128
    trade places in the wrap): at 64 steps they pass (the block comes
    home), at 1 step both comparisons of each roll fail."""
    x = vpu_ops.base_block("cpu", torch.bfloat16)
    reference = vpu_ops.op_chain_reference

    def broken(x, case, steps=vpu_ops.STEPS):
        if case not in vpu_ops.ROLL_BY:
            return reference(x, case, steps)
        v = x
        for _ in range(steps * vpu_ops.CASES[case][1]):
            v = roll_layout(v, vpu_ops.ROLL_BY[case], swap=False)
        return v
    monkeypatch.setattr(vpu_ops, "op_chain", broken)
    for case in vpu_ops.ROLL_BY:
        rs = vpu_ops.check(x, case)
        assert [r["ok"] for r in rs if "64 steps" in r["what"]] == [True] * 2
        assert [r["ok"] for r in rs if "64 steps" not in r["what"]] == \
            [False] * 2


def test_op_chain_card_bars():
    """On the card float32 div is held bit for bit (the kernel's division
    is IEEE, as torch's); on the CPU it keeps the 1e-5 bar."""
    assert vpu_ops.required_agreement("div", torch.float32) == \
        vpu_ops.MIN_AGREE
    assert vpu_ops.required_agreement("div", torch.float32, True) == 1.0
    assert vpu_ops.required_agreement("div", torch.bfloat16, True) == \
        vpu_ops.MIN_AGREE
    assert vpu_ops.required_agreement("exp", torch.float32, True) == \
        vpu_ops.MIN_AGREE
    a = torch.tensor([1.0, 2.0])
    b = a + torch.tensor([0.0, 5e-6])
    assert vpu_ops.agreement(a, b, "div") == 1.0
    assert vpu_ops.exact_f32("div", True) and not vpu_ops.exact_f32("div")


def test_op_chain_checks_inputs():
    x = vpu_ops.base_block("cpu")
    with pytest.raises(ValueError):
        vpu_ops.op_chain(x, "tanh")
    with pytest.raises(TypeError):
        vpu_ops.op_chain(x.double(), "mul")
    with pytest.raises(ValueError):
        vpu_ops.op_chain(x[:128], "mul")
    with pytest.raises(ValueError):
        vpu_ops.op_chain(x.t().contiguous().t(), "mul")
    with pytest.raises(ValueError):
        vpu_ops.op_chain(x[:, :3].contiguous().bfloat16(), "mul")
    assert torch.equal(vpu_ops.op_chain(x, "mul", 0), x)


def test_op_chain_entry_point_on_cpu(capsys):
    rows = vpu_ops.main(["--device", "cpu", "--reps", "1"])
    assert len(rows) == 16
    assert all(np.isfinite(r["ms"]) for r in rows)
    out = capsys.readouterr().out
    assert "cpu (the plain version, no kernel)" in out
    assert out.count("\n") == 2 + len(vpu_ops.CASES)


def test_op_chain_entry_point_takes_the_block_width(capsys):
    """--cols widens the block; its default is the script's 512."""
    assert vpu_ops.base_block("cpu").shape == (vpu_ops.SUB, vpu_ops.LANE)
    rows = vpu_ops.main(["--device", "cpu", "--reps", "1", "--cols", "6"])
    assert len(rows) == 16
    assert "block [256,6]" in capsys.readouterr().out


# ---------------------------------------------------------------- gather
CHUNK = 128


def _pallas_gather(table, gid2d, n_rows, D):
    """scripts/microbench_dma_gather.py:88-139 and :160-182, verbatim but
    for the shapes."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    def _gather_kernel(gid_cur_ref, gid_next_ref, table_ref, out_ref,
                       buf_ref, sem_ref, *, n_steps):
        i = pl.program_id(0)

        def copies(slot, gid_ref):
            return [pltpu.make_async_copy(
                        table_ref.at[pl.ds(gid_ref[0, 0, j], 1), :],
                        buf_ref.at[slot, pl.ds(j, 1), :],
                        sem_ref.at[slot]) for j in range(CHUNK)]

        @pl.when(i == 0)
        def _():
            for c in copies(0, gid_cur_ref):
                c.start()

        @pl.when(i + 1 < n_steps)
        def _():
            for c in copies((i + 1) % 2, gid_next_ref):
                c.start()

        for c in copies(i % 2, gid_cur_ref):
            c.wait()
        out_ref[0] = buf_ref[i % 2]

    return pl.pallas_call(
        functools.partial(_gather_kernel, n_steps=n_rows),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=0,
            grid=(n_rows,),
            in_specs=[
                pl.BlockSpec((1, 1, CHUNK), lambda i: (i, 0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((1, 1, CHUNK),
                             lambda i: (jnp.minimum(i + 1, n_rows - 1), 0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec(memory_space=pltpu.ANY),
            ],
            out_specs=pl.BlockSpec((1, CHUNK, D), lambda i: (i, 0, 0)),
            scratch_shapes=[
                pltpu.VMEM((2, CHUNK, D), jnp.float32),
                pltpu.SemaphoreType.DMA((2,)),
            ],
        ),
        out_shape=jax.ShapeDtypeStruct((n_rows, CHUNK, D), jnp.float32),
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=("arbitrary",)),
    )(gid2d, gid2d, table)


def test_gather_inputs_are_the_scripts():
    P, D, K = 4096, 128, 6 * CHUNK
    table, ids = dma_gather.make_inputs(P, D, K, 0, "cpu")
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        table.numpy(), rng.normal(size=(P, D)).astype(np.float32))
    np.testing.assert_array_equal(
        ids.numpy(), rng.integers(0, P, K).astype(np.int32))


@pytest.mark.parametrize("width", [128, 18])
def test_gather_matches_script_oracle(width):
    table, ids = dma_gather.make_inputs(4096, width, 6 * CHUNK + 5, 3, "cpu")
    want = table.numpy()[ids.numpy()]                   # :183
    np.testing.assert_array_equal(
        dma_gather.gather_rows_reference(table, ids).numpy(), want)
    np.testing.assert_array_equal(
        dma_gather.gather_rows(table, ids).numpy(), want)


def test_gather_matches_pallas_interpret():
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    P, D, n_rows = 4096, 128, 6
    table, ids = dma_gather.make_inputs(P, D, n_rows * CHUNK, 0, "cpu")
    with pltpu.force_tpu_interpret_mode():
        out = np.asarray(_pallas_gather(
            jnp.asarray(table.numpy()),
            jnp.asarray(ids.numpy()).reshape(n_rows, 1, CHUNK), n_rows, D))
    np.testing.assert_array_equal(
        dma_gather.gather_rows(table, ids).numpy().reshape(n_rows, CHUNK, D),
        out)


def test_gather_checks_inputs():
    table, ids = dma_gather.make_inputs(64, 8, 100, 0, "cpu")
    with pytest.raises(TypeError):
        dma_gather.gather_rows(table.double(), ids)
    with pytest.raises(TypeError):
        dma_gather.gather_rows(table, ids.long())
    with pytest.raises(ValueError):
        dma_gather.gather_rows(table.t(), ids)
    with pytest.raises(IndexError):
        dma_gather.gather_rows(table, torch.tensor([0, 64], dtype=torch.int32))
    with pytest.raises(IndexError):
        dma_gather.gather_rows(table, torch.tensor([-1], dtype=torch.int32))
    assert dma_gather.gather_rows(
        table, torch.zeros(0, dtype=torch.int32)).shape == (0, 8)


def test_gather_entry_point_on_cpu(capsys):
    r = dma_gather.main(["--device", "cpu", "--rows", "2048", "--width",
                         "18", "--ids", "3000", "--reps", "2"])
    assert r["bitwise"]
    assert "correctness: OK" in capsys.readouterr().out


# ------------------------------------------------------- timers
class _Sleeper:
    """A call that sleeps ``ms`` and counts its calls."""

    def __init__(self, ms):
        self.ms, self.calls = ms, 0

    def __call__(self):
        self.calls += 1
        time.sleep(self.ms / 1e3)


def test_median_ms_on_cpu():
    fn = _Sleeper(5)
    ms = timing.median_ms(fn, torch.device("cpu"), reps=5, warmup=2)
    assert fn.calls == 7
    assert 5 <= ms < 1000


def test_calls_per_sec_on_cpu():
    fn = _Sleeper(5)
    rate = timing.calls_per_sec(fn, 4, torch.device("cpu"))
    assert fn.calls == 4
    assert 0 < rate <= 200


def test_entry_device_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        timing.entry_device("cuda")
    assert timing.entry_device("cpu") == torch.device("cpu")
    assert timing.card(torch.device("cpu")).startswith("cpu")


# ------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_timers_on_card(cuda_device):
    """CUDA events time the card's work: a 4096^2 matmul takes longer
    than nothing, and back-to-back calls end in one synchronize."""
    x = torch.randn(4096, 4096, device=cuda_device)
    ms = timing.median_ms(lambda: x @ x, cuda_device, reps=3)
    assert ms > timing.median_ms(lambda: None, cuda_device, reps=3)
    assert 0 < timing.calls_per_sec(lambda: x @ x, 5, cuda_device) < 1e5


@pytest.mark.cuda
def test_gather_kernel_matches_plain_on_card(cuda_device):
    """Bitwise against index_select: float4 units (D = 128), float2 units
    (D = 18), float units (D = 17, 5), and a D = 128 table whose data
    starts one float into its storage (float units again)."""
    for P, D, K, shift in ((100_000, 128, 300_000, 0),
                           (100_000, 18, 300_001, 0),
                           (100_000, 17, 300_002, 0), (1000, 5, 777, 0),
                           (10_000, 128, 30_000, 1)):
        table, ids = dma_gather.make_inputs(P, D, K, 1, cuda_device)
        if shift:
            flat = torch.empty(P * D + shift, device=cuda_device)
            flat[shift:] = table.reshape(-1)
            table = flat[shift:].view(P, D)
            assert table.data_ptr() % 16 == 4 * shift
        n = dma_gather.gather_rows.launches
        out = dma_gather.gather_rows(table, ids)
        torch.cuda.synchronize()
        assert dma_gather.gather_rows.launches == n + 1
        assert torch.equal(out, dma_gather.gather_rows_reference(table, ids))


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [vpu_ops.LANE, 130])
def test_op_chains_match_plain_on_card(cuda_device, cols):
    """Every chain against its plain version (``vpu_ops.check``), on the
    script's block and on one of 130 columns (a ragged flat tail)."""
    for case in vpu_ops.CASES:
        for dtype in vpu_ops.DTYPES:
            x = vpu_ops.base_block(cuda_device, dtype)[:, :cols].contiguous()
            n = vpu_ops.op_chain.launches
            results = vpu_ops.check(x, case)
            torch.cuda.synchronize()
            assert vpu_ops.op_chain.launches == n + len(vpu_ops.CHECK_STEPS)
            assert all(r["ok"] for r in results), (case, dtype, results)


# csrc/op_chain.cu's float32 division takes its fast path for a warp
# unless an operand of the warp lies outside [2^-31, 2^33) in magnitude
FAST_LO, FAST_HI = 2.0 ** -31, 2.0 ** 33
# the block's one divisor out of that range, and the warp group it lies in
OUT_OF_RANGE_GROUP = 300


def division_block() -> np.ndarray:
    """A [256, 512] float32 block for the division chain whose first
    divisors v + 1 hold one exponent and sign per warp group, the 32 flat
    units 32 g .. 32 g + 31 (mod 512 groups): with 1, 2, 4 or 8 registers
    per thread, the units a warp holds in its registers lie in one group.
    The groups run through every exponent from -24 to 32 in both signs
    (-23 for the negative: x + 1 in float32 cannot give a divisor under
    2^-24 other than 0), with the edges 2^-24 and 2^33 - 512, the largest
    float under 2^33, in both signs; one element of OUT_OF_RANGE_GROUP is
    2^33, outside the fast path's range."""
    n = vpu_ops.SUB * vpu_ops.LANE
    g = np.arange(n) // 32 % 512
    sign = np.where(g // 57 % 2, -1.0, 1.0)
    e = -24 + g % 57
    e = np.where((sign < 0) & (e == -24), -23, e)
    m = np.random.default_rng(4).uniform(1, 2, n)
    x = (sign * np.ldexp(m, e) - 1).astype(np.float32)
    top = np.float32(FAST_HI - 512)
    first = {}
    for i in range(n):
        first.setdefault((e[i], sign[i]), i)
    x[first[(-24, 1.0)]] = np.float32(-1 + 2.0 ** -24)
    x[first[(32, 1.0)]] = top
    x[first[(32, -1.0)]] = -top
    x[np.flatnonzero(g == OUT_OF_RANGE_GROUP)[5]] = np.float32(FAST_HI)
    return x.reshape(vpu_ops.SUB, vpu_ops.LANE)


def test_division_block_keeps_whole_warps_on_the_fast_path():
    """The 8 divisors of a step of the division chain on division_block,
    computed as the plain version computes them: every warp of every
    layout of 1, 2, 4 or 8 registers per thread has all of its divisors in
    the fast path's range but the one that holds OUT_OF_RANGE_GROUP; the
    first divisors reach every exponent from -24 to 32 and both edges, and
    each warp's units lie in one group."""
    v = torch.from_numpy(division_block()).reshape(-1)
    a = torch.tensor(0.9999, dtype=torch.float32)
    out = torch.zeros(v.numel(), dtype=torch.bool)
    for op in range(vpu_ops.CASES["div"][1]):
        d = v + 1
        if op == 0:
            first = d
        out |= (d.abs() < FAST_LO) | (d.abs() >= FAST_HI)
        v = a / d
    n = v.numel()
    for regs in (1, 2, 4, 8):
        units = (torch.arange(regs)[:, None] * (n // regs)
                 + torch.arange(n // regs)[None, :])      # [register, thread]
        warps = units.reshape(regs, -1, 32).transpose(0, 1)
        assert (warps // 32 % 512 == warps[:, :1, :1] // 32 % 512).all()
        warp_out = out[warps].flatten(1).any(1)
        assert int(warp_out.sum()) == 1, regs
        assert int(warps[warp_out][0, 0, 0]) // 32 % 512 == \
            OUT_OF_RANGE_GROUP
    assert int(out.sum()) == 1
    fast = first[~out]
    _, e = torch.frexp(fast)
    assert set((e - 1).tolist()) == set(range(-24, 33))
    for sign in (1, -1):
        assert set((e[fast * sign > 0] - 1).tolist()) >= set(range(-23, 33))
        assert (fast == sign * (FAST_HI - 512)).any()
    assert (fast == 2.0 ** -24).any()


@pytest.mark.cuda
@pytest.mark.parametrize("block", ["fast path", "every exponent"])
def test_op_chain_division_on_card(cuda_device, block):
    """float32 div bit for bit against torch's IEEE division, on two
    blocks: ``division_block``, whose warps keep the fast path over every
    exponent of the divisor v + 1 it can reach and its edges, but for one
    warp sent to the IEEE division by a single divisor; and divisors spread
    over every exponent at random, with both signs, zeros and infinities,
    so that nearly every warp takes the IEEE division. NaNs where torch has
    them."""
    if block == "fast path":
        x = division_block()
    else:
        rng = np.random.default_rng(3)
        mag = np.ldexp(rng.uniform(1, 2, (256, 512)),
                       rng.integers(-140, 128, (256, 512)))
        x = (mag * rng.choice([-1.0, 1.0], (256, 512))).astype(np.float32)
        x[0, :8] = [-1.0, 0.0, -0.0, np.inf, -np.inf, 1e-45, -2.0, 3e38]
    x = torch.from_numpy(x).to(cuda_device)
    for steps in (1, 2):
        got = vpu_ops.op_chain(x, "div", steps)
        want = vpu_ops.op_chain_reference(x, "div", steps)
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


# ---------------------------------------------------------------- bounds
class _Settings:
    height = width = 16
    tile_h = tile_w = 16
    tiles_y = tiles_x = num_tiles = 1
    compute_distortion = True


def test_composite_bounds_hand_counted():
    """One 16x16 tile, two instances, both walked: 100 pixels stop at the
    second (n_contrib 2), 50 at the first, 106 take none."""
    s, C, S = _Settings(), 4, 4
    misc = torch.zeros(8, 16, 16)
    flat = misc[1].view(-1)
    flat[:100] = 2
    flat[100:150] = 1
    misc[5] = 2.0
    fwd = type("Out", (), {"misc": misc})()
    w = bounds.composite_work(fwd, s, 2, C, S)
    assert (w.needed_pairs, w.walked_pairs) == (250, 512)
    assert (w.needed_instances, w.accepting_pixels) == (2, 150)
    assert w.walked_over_needed == 512 / 250
    # the walk: one tile of 2 instances, one staging batch
    assert (w.tile_walked_max, w.tile_walked_mean) == (2, 2.0)
    assert (w.heavy_tenth_share, w.walked_chunks) == (1.0, 1)
    D = 10 + C + S
    assert w.n_bytes == 2 * D * 4 + 2 * 4 + (C + S + 3 + 4 + 8) * 256 * 4
    assert w.fp32 == (256 * bounds.RAY_FP32 + 250 * bounds.INTERSECT_FP32
                      + 2 * bounds.STAGE_FP32
                      + 150 * (bounds.FWD_ACCEPT_FP32 + 2 * (C + S)
                               + bounds.FWD_DIST_FP32))
    assert w.mufu == (256 * bounds.RAY_MUFU + 250 * bounds.INTERSECT_MUFU
                      + 2 * bounds.STAGE_MUFU + 150 * bounds.FWD_DIST_MUFU)
    b = w.bound()
    # 23,704 bytes outweigh 16,344 flops and 1,176 MUFU ops on this card
    assert (w.n_bytes, w.fp32, w.mufu) == (23_704, 16_344, 1_176)
    assert (b.by, b.bound_by) == ("bytes", "bytes")
    assert b.ms == pytest.approx(23_704 / 3.35e12 * 1e3)
    # no FMA is issued (--fmad=false): each add or multiply takes one of
    # the 128 issue slots per clock per SM, half the 67 TFLOP/s FMA rate
    assert b.terms["fp32"] == pytest.approx(
        16_344 / (128 * 132 * bounds.BOOST_CLOCK_HZ) * 1e3)
    assert b.terms["mufu"] == pytest.approx(
        1_176 / (16 * 132 * bounds.BOOST_CLOCK_HZ) * 1e3)
    wb = bounds.composite_work(fwd, s, 2, C, S, backward=True)
    assert wb.needed_pairs == 250
    assert wb.n_bytes == (2 * D * 4 + 2 * 4 + 4
                          + ((C + S + 3 + 4 + 1) + (C + 3 + 2 + 5)) * 256 * 4
                          + 2 * D * 4)
    assert wb.fp32 == (256 * bounds.RAY_FP32 + 250 * bounds.INTERSECT_FP32
                       + 2 * (bounds.STAGE_FP32 + bounds.FINISH_FP32)
                       + 150 * (bounds.BWD_ACCEPT_FP32 + 2 * C + (C + S + 3)
                                + bounds.BWD_DIST_FP32))
    # a dense scene: the operations bound
    many = bounds.CompositeWork(needed_pairs=10 ** 9, walked_pairs=10 ** 9,
                                needed_instances=0, accepting_pixels=0,
                                pixels=0, n_bytes=10 ** 6,
                                fp32=29 * 10 ** 9, mufu=2 * 10 ** 9)
    assert many.bound().by in ("fp32", "mufu")
    assert many.bound().bound_by == "operations"


def test_product_batches_follow_the_windows():
    """Tiles of 256 pixels: a walk that ran to the end of its list (the
    product pass walked all of it), and walks the vote stopped at batch 0,
    2, 3, 5 and 200, each taken to the end of its window within the list:
    windows [0, 2), [2, 4), [4, 8), ..., [128, end); the kernel's own; and
    one window, the whole list."""
    B = 256
    counts = torch.tensor([10 * B, 43 * B, 43 * B, 43 * B, 6 * B + 5,
                           300 * B, 3 * B])
    walked = torch.tensor([10 * B, 0, 2 * B, 3 * B, 5 * B, 200 * B, 3 * B])
    doubling = (2, 4, 8, 16, 32, 64, 128)
    assert bounds.product_batches(walked, counts, B, doubling).tolist() == [
        10, 2, 4, 4, 7, 300, 3]
    assert bounds.WINDOW_ENDS == (4, 16, 64)
    assert bounds.product_batches(walked, counts, B).tolist() == [
        10, 4, 4, 4, 7, 300, 3]
    assert bounds.product_batches(walked, counts, B, ()).tolist() == [
        10, 43, 43, 43, 7, 300, 3]


def test_composite_work_counts_the_product_pass():
    """A 30x130 panorama (tiles of 16x16, the bottom row of tiles half
    outside): the product pass walks, per tile, the instances of the
    batches ``product_batches`` gives against the tile's pixels inside
    the image, at least the walked pairs; without the tile ranges it
    counts none. The opaque tile stops after 2 of its 43 batches and its
    products stop at 4 (the window [0, 4))."""
    from gslidar_tpu_torch.raster import composite_fwd as cf
    from gslidar_tpu_torch.raster.scenes import (deep_tile_scene,
                                                 opaque_front_tile_scene,
                                                 port_rows)
    from gslidar_tpu_torch.raster.settings import RasterSettings
    ts = RasterSettings(height=30, width=130, vfov=(-20.0, 20.0),
                        hfov=(-60.0, 60.0), num_extra_features=2)
    for scene, seed in ((deep_tile_scene, 7), (opaque_front_tile_scene, 11)):
        sc = {k: torch.as_tensor(v)
              for k, v in scene(np.random.default_rng(seed)).items()}
        rows, starts = port_rows(sc, ts)
        out = cf.composite_forward(rows, starts, cf.make_params(1.0, ts), ts,
                                   4, 2)
        w = bounds.composite_work(out, ts, rows.shape[0], 4, 2,
                                  tile_starts=starts)
        counts = (starts[1:] - starts[:-1]).long()
        walked = out.misc[5, ::16, ::16].reshape(-1).long()
        batches = bounds.product_batches(walked, counts, 256)
        inside = [min(16, ts.height - 16 * (t // ts.tiles_x))
                  * min(16, ts.width - 16 * (t % ts.tiles_x))
                  for t in range(ts.num_tiles)]
        assert w.product_pairs == sum(
            min(int(c), 256 * int(b)) * i
            for c, b, i in zip(counts, batches, inside))
        assert w.product_chunks == int(batches.sum())
        assert w.product_pairs >= w.walked_pairs > 0
        assert bounds.composite_work(out, ts, rows.shape[0], 4,
                                     2).product_pairs == 0
    t = int(counts.argmax())
    assert (int(counts[t]) // 256, int(walked[t]), int(batches[t])) == (
        42, 512, 4)


def test_gather_bound_counts_distinct_rows():
    ids = torch.tensor([3, 3, 7, 0, 7], dtype=torch.int32)
    assert bounds.gather_bytes(10, ids) == 3 * 40 + 5 * 4 + 5 * 40
    b = bounds.gather_bound(10, ids)
    assert b.by == "bytes" and b.ms == pytest.approx(340 / 3.35e12 * 1e3)


def test_gather_bound_of_the_scripts_shape():
    """The script's ids (after its 1M x 128 normal draws, taken here in
    blocks): 895,360 distinct rows, 1,625,096,192 bytes, 0.485 ms."""
    rng = np.random.default_rng(0)
    for _ in range(125):
        rng.normal(size=(8000, 128))
    ids = torch.from_numpy(
        rng.integers(0, 1_000_000, 17664 * 128).astype(np.int32))
    assert int(torch.unique(ids).numel()) == 895_360
    assert bounds.gather_bytes(128, ids) == 1_625_096_192
    assert bounds.gather_bound(128, ids).ms == pytest.approx(0.4851, abs=1e-4)


def test_chain_bounds():
    mul = bounds.chain_op_bound("mul", 131072, False, 1.98e9)
    assert mul.ms * 1e6 == pytest.approx(3.918, abs=1e-3)
    assert bounds.chain_op_bound("exp", 131072, False, 1.98e9).by == "mufu"
    assert bounds.chain_op_bound("exp", 131072, False, 1.98e9).ms * 1e6 == \
        pytest.approx(31.34, abs=1e-2)
    # a roll moves one value of each lane's 8 rows: 1/8 shuffle an element,
    # at 32 per clock per SM, under the multiply's issue time
    roll1 = bounds.chain_op_bound("roll1", 131072, False, 1.98e9)
    assert roll1.by == "fp32" and roll1.ms == pytest.approx(mul.ms)
    assert roll1.terms["shfl"] == pytest.approx(
        131072 / 8 / (32 * 132 * 1.98e9) * 1e3)
    assert bounds.chain_op_bound("roll8", 131072, True, 1.98e9).terms[
        "shfl"] == pytest.approx(roll1.terms["shfl"])
    packed = bounds.chain_op_bound("mul", 131072, True, 1.98e9)
    assert packed.ms == pytest.approx(mul.ms / 2)
    chain = bounds.chain_bound("mul", 32, 64, 131072, 4, False, 1.98e9)
    assert chain.by == "fp32" and chain.bound_by == "operations"
    assert chain.ms == pytest.approx(64 * (32 + 2) * mul.ms)
    # sm_90a has no packed MUFU op (its packed ex2 is two MUFU ops): bf16
    # exp, div and rsqrt take one MUFU op per element, their adds and
    # multiplies pack
    for case in ("exp", "div", "rsqrt"):
        f32 = bounds.chain_op_bound(case, 131072, False, 1.98e9)
        bf16 = bounds.chain_op_bound(case, 131072, True, 1.98e9)
        assert bf16.by == "mufu"
        assert bf16.terms["mufu"] == pytest.approx(f32.terms["mufu"])
        assert bf16.ms * 1e6 == pytest.approx(31.34, abs=1e-2)
        assert bf16.terms["fp32"] == pytest.approx(f32.terms["fp32"] / 2)
        chain = bounds.chain_bound(case, 8, 64, 131072, 2, True, 1.98e9)
        assert chain.terms["mufu"] == pytest.approx(64 * 8 * f32.ms)
        assert chain.ms == pytest.approx(64 * 8 * f32.ms)
        # the step's floor has no packed form either (no cvt.rmi.bf16x2):
        # per element, its subtract packed
        assert chain.terms["fp32"] == pytest.approx(
            64 * (8 / 2 + 1 + 1 / 2) * f32.terms["fp32"])
    bf16_mul = bounds.chain_bound("mul", 32, 64, 131072, 2, True, 1.98e9)
    assert bf16_mul.ms == pytest.approx(64 * (32 / 2 + 1.5) * mul.ms)
    # the 16 chains of the script at 64 steps
    total = sum(bounds.chain_bound(case, n, 64, 131072, 2 if p else 4, p,
                                   1.98e9).ms
                for case, (_, n) in vpu_ops.CASES.items()
                for p in (False, True))
    assert total == pytest.approx(0.17289, abs=1e-5)
