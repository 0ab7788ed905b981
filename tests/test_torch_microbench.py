"""The port's microbenchmark kernels against the Pallas kernels they
replace, and the least-time bounds.

* op chains: ``scripts/microbench_vpu_ops.py``'s ``make_case`` in Pallas
  interpret mode, for the script's 8 cases (restated from its ``main``,
  where they are local) in float32 and bfloat16, against
  ``op_chain_reference`` and the ``op_chain`` wrapper on CPU tensors;
* the row gather: the script's own oracle ``table[gid]`` and a verbatim
  copy of its ``_gather_kernel`` (a closure inside its ``main``) in
  interpret mode, against ``gather_rows_reference`` and ``gather_rows``;
* the ``cuda``-marked cases: each kernel against its plain version on the
  card (they skip without one);
* ``bounds``: a hand-countable compositor scene, the gather's bytes and
  the op chains' issue bounds.

``scripts/`` is no package, so the script is loaded by path. JAX is
imported inside the tests that use it, so that the card-only cases also
run where JAX is not installed.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from gslidar_tpu_torch.microbench import bounds, dma_gather, vpu_ops

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
    within each 32-row block (what the kernel gives if its lanes l < s
    take register k, not k - 1); and, for roll1, the other way (for roll8
    that is no fault: 16 rolls by -8 move the block by 128 rows too)."""
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


# ------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_gather_kernel_matches_plain_on_card(cuda_device):
    for P, D, K in ((100_000, 128, 300_000), (100_000, 18, 300_001),
                    (1000, 5, 777)):
        table, ids = dma_gather.make_inputs(P, D, K, 1, cuda_device)
        n = dma_gather.gather_rows.launches
        out = dma_gather.gather_rows(table, ids)
        torch.cuda.synchronize()
        assert dma_gather.gather_rows.launches == n + 1
        assert torch.equal(out, dma_gather.gather_rows_reference(table, ids))


@pytest.mark.cuda
def test_op_chains_match_plain_on_card(cuda_device):
    for case in vpu_ops.CASES:
        for dtype in vpu_ops.DTYPES:
            x = vpu_ops.base_block(cuda_device, dtype)
            n = vpu_ops.op_chain.launches
            results = vpu_ops.check(x, case)
            torch.cuda.synchronize()
            assert vpu_ops.op_chain.launches == n + len(vpu_ops.CHECK_STEPS)
            assert all(r["ok"] for r in results), (case, dtype, results)


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
    assert bounds.chain_op_bound("roll1", 131072, False, 1.98e9).by == "shfl"
    packed = bounds.chain_op_bound("mul", 131072, True, 1.98e9)
    assert packed.ms == pytest.approx(mul.ms / 2)
    chain = bounds.chain_bound("mul", 32, 64, 131072, 4, False, 1.98e9)
    assert chain.by == "fp32" and chain.bound_by == "operations"
    assert chain.ms == pytest.approx(64 * (32 + 2) * mul.ms)
