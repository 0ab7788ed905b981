"""The step's Adam (``gslidar_tpu_torch/models/optim.py``: ``adam_step``,
its kernel ``csrc/adam.cu`` and its plain version ``adam_step_reference``)
and the train step's statistics gate (``engine/train.py``).

On the CPU: ``adam_step`` takes the plain path for CPU tensors and equals
the per-group loop it replaced bit for bit, at ragged sizes, with f_dc's
and f_rest's gradients as the column ranges of one [P, 16, 4] gradient
(as the cat's backward hands them back), and with their parameters and
first moments so too (as a fresh model from ``create_from_pcd`` holds
them); ``adam_jax.npz`` holds what the JAX package's ``adam_step`` gives
on seeded numpy groups, and the plain path lies within
``_assert_within_jax`` of it; it refuses other dtypes, mixed
devices, other devices and layouts it does not take; a train step with
the statistics off gives the loss, gradients, parameters and Adam state
of the same step with them on, bit for bit, leaves the statistics as they
were, and computes neither their splat frame nor their viewspace
gradient; ``microbench/bounds.py::adam_bound``'s arithmetic.

On the card (``-m cuda``, an H100): the kernel against the plain version
bit for bit on every element of all ten groups at 10,000,000 gaussians
and at ragged small sizes, with the gradients laid out as the step makes
them, with a fresh model's column ranges, and with every group at an
unaligned offset of one flat buffer (as the data-parallel step's
all-reduced gradients are); the kernel against the JAX package's
``adam_step`` (``adam_jax.npz``) within ``_assert_within_jax``, on the
same numpy groups; one launch a call;
a train step with the statistics off launches Adam once and computes no
statistics.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from gslidar_tpu_torch.models.gaussians import PARAM_KEYS

# each group's shape after the gaussian dimension (create_from_pcd's)
SHAPES = {"xyz": (3,), "f_dc": (1, 4), "f_rest": (15, 4), "opacity": (1,),
          "scaling": (3,), "rotation": (4,), "t": (1,), "scaling_t": (1,),
          "velocity": (3,), "intensity": (1,)}
# kitti360_nvs_10750's rates at iteration 20,001, a zero one among them
LRS = {"xyz": 1.6e-5, "f_dc": 2.5e-3, "f_rest": 1.25e-4, "opacity": 0.05,
       "scaling": 5e-3, "rotation": 1e-3, "t": 8e-6, "scaling_t": 2e-3,
       "velocity": 0.0, "intensity": 5e-3}


def _todays_loop(params, grads, state, lrs):
    """The per-group Adam the kernel replaced, as it was written."""
    from gslidar_tpu_torch.models.optim import B1, B2, EPS, AdamState
    count = state.count + 1
    c1 = 1.0 - B1 ** count
    c2 = 1.0 - B2 ** count
    new_p, new_mu, new_nu = {}, {}, {}
    for k in PARAM_KEYS:
        g = grads[k]
        mu = B1 * state.mu[k] + (1 - B1) * g
        nu = B2 * state.nu[k] + (1 - B2) * g * g
        update = (mu / c1) / (torch.sqrt(nu / c2) + EPS)
        new_p[k] = params[k] - lrs[k] * update
        new_mu[k], new_nu[k] = mu, nu
    return new_p, AdamState(mu=new_mu, nu=new_nu, count=count)


def _groups(P, count, device, seed=0, layout="step"):
    """Seeded (params, grads, AdamState) of P gaussians. ``layout``
    "step": each tensor its own, f_dc's and f_rest's gradients the two
    column ranges of one [P, 16, 4] gradient; "model": the same, and f_dc
    and f_rest of the parameters and of the first moments so too; "flat":
    every group of each kind a view of one flat buffer, one element apart,
    so that most start off 16-byte alignment. Gradients and moments hold
    exact zeros."""
    from gslidar_tpu_torch.models.optim import AdamState
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(shape, scale):
        return scale * torch.randn(shape, generator=gen, device=device)

    def kind(scale, positive=False, cols=False):
        if layout == "flat":
            sizes = [P * int(np.prod(SHAPES[k])) for k in PARAM_KEYS]
            flat = draw((sum(sizes) + len(sizes),), scale)
            out, off = {}, 1
            for k, n in zip(PARAM_KEYS, sizes):
                out[k] = flat[off:off + n].view((P,) + SHAPES[k])
                off += n + 1
        else:
            out = {k: draw((P,) + SHAPES[k], scale) for k in PARAM_KEYS}
            if cols:
                sh = draw((P, 16, 4), scale)
                out["f_dc"], out["f_rest"] = sh[:, :1], sh[:, 1:]
        for v in out.values():
            if positive:
                v.abs_()
            v.masked_fill_(draw(v.shape, 1.0) > 1.5, 0.0)
        return out
    model = layout == "model"
    params = kind(1.0, cols=model)
    grads = kind(1e-3, cols=True)
    state = AdamState(mu=kind(1e-4, cols=model),
                      nu=kind(1e-7, positive=True), count=count)
    return params, grads, state


# the JAX package's adam_step on _numpy_groups(P, count), each case's
# outputs under "<P>.<count>.<param|mu|nu>.<group>" and the sha256 of its
# inputs under "<P>.<count>.inputs"; written by ``_write_jax_golden``:
#   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_adam.py
JAX_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "adam_jax.npz")
# (P, count): the first step, where the bias corrections are largest, and
# one at iteration 20,000
JAX_CASES = [(129, 0), (129, 19999)]


def _numpy_groups(P, count):
    """Seeded float32 (params, grads, mu, nu) of P gaussians, drawn as
    ``_groups`` draws them, from numpy's legacy ``RandomState``, whose
    stream numpy keeps the same across versions."""
    rs = np.random.RandomState(P + count)

    def kind(scale, positive=False):
        out = {}
        for k in PARAM_KEYS:
            v = (scale * rs.standard_normal((P,) + SHAPES[k])
                 ).astype(np.float32)
            if positive:
                v = np.abs(v)
            v[rs.standard_normal(v.shape) > 1.5] = 0.0
            out[k] = v
        return out
    return kind(1.0), kind(1e-3), kind(1e-4), kind(1e-7, positive=True)


def _inputs_sha256(groups):
    h = hashlib.sha256()
    for d in groups:
        for k in PARAM_KEYS:
            h.update(np.ascontiguousarray(d[k]).tobytes())
    return h.hexdigest()


def _jax_adam(P, count):
    """The JAX package's ``adam_step`` on ``_numpy_groups(P, count)``, on
    the CPU: {"<param|mu|nu>.<group>": numpy array}."""
    import jax.numpy as jnp
    from gslidar_tpu.models import optim as J
    params, grads, mu, nu = _numpy_groups(P, count)

    def j(d):
        return {k: jnp.asarray(v) for k, v in d.items()}
    new_p, st = J.adam_step(j(params), j(grads),
                            J.AdamState(mu=j(mu), nu=j(nu),
                                        count=jnp.asarray(count, jnp.int32)),
                            LRS)
    return {f"{what}.{k}": np.asarray(d[k])
            for what, d in (("param", new_p), ("mu", st.mu), ("nu", st.nu))
            for k in PARAM_KEYS}


def _write_jax_golden(path=JAX_GOLDEN):
    out = {}
    for P, count in JAX_CASES:
        out[f"{P}.{count}.inputs"] = np.array(
            _inputs_sha256(_numpy_groups(P, count)))
        for key, v in _jax_adam(P, count).items():
            out[f"{P}.{count}.{key}"] = v
    np.savez_compressed(path, **out)


def _jax_golden(P, count):
    """The JAX package's outputs of case (P, count) from ``adam_jax.npz``,
    after checking that ``_numpy_groups`` still draws its inputs."""
    with np.load(JAX_GOLDEN) as f:
        assert str(f[f"{P}.{count}.inputs"]) == _inputs_sha256(
            _numpy_groups(P, count))
        pre = f"{P}.{count}."
        return {k[len(pre):]: f[k] for k in f.files
                if k.startswith(pre) and k != pre + "inputs"}


def _torch_groups(groups, count, device, layout):
    """``_numpy_groups``' arrays as (params, grads, AdamState) on
    ``device``, laid out as ``_groups``' "step" or "model" layout."""
    from gslidar_tpu_torch.models.optim import AdamState

    def to(d, cols):
        out = {k: torch.as_tensor(v, device=device) for k, v in d.items()}
        if cols:
            sh = torch.as_tensor(np.concatenate([d["f_dc"], d["f_rest"]], 1),
                                 device=device)
            out["f_dc"], out["f_rest"] = sh[:, :1], sh[:, 1:]
        return out
    params, grads, mu, nu = groups
    model = layout == "model"
    return to(params, model), to(grads, True), AdamState(
        mu=to(mu, model), nu=to(nu, False), count=count)


def _assert_within_jax(got, want, groups, count):
    """The port's (new params, AdamState) against the JAX package's on the
    same inputs. The moments within 2 float32 ulps of their terms' sizes
    (the same ops in the same order: they agree bit for bit). Each
    parameter within 8 ulps of its step lr |update| (the two round the
    update's chain of ops, and the port multiplies by 1 / c where JAX
    divides by c), plus the step times what the bias corrections differ
    by (the port's taken in double from a Python int, JAX's in float32
    from a float32 count: ~1.3e-5 relative at the first step), plus 2
    ulps of the parameter for the subtraction."""
    from gslidar_tpu_torch.models.optim import B1, B2, EPS
    ulp = float(np.finfo(np.float32).eps)
    n = count + 1
    c1, c2 = 1.0 - B1 ** n, 1.0 - B2 ** n
    one, fn = np.float32(1), np.float32(n)
    dc = (abs(float(one - np.float32(B1) ** fn) / c1 - 1)
          + abs(float(one - np.float32(B2) ** fn) / c2 - 1) / 2)
    new_p, st = got
    assert st.count == n
    params, grads, mu, nu = ({k: v.astype(np.float64) for k, v in d.items()}
                             for d in groups)
    for k in PARAM_KEYS:
        def w(what):
            return want[f"{what}.{k}"].astype(np.float64)

        def g(t):
            return t.detach().cpu().double().numpy()
        wmu, wnu, wp = w("mu"), w("nu"), w("param")
        for what, a, b, size in (
                ("mu", g(st.mu[k]), wmu,
                 np.abs(mu[k]) + np.abs(grads[k]) + np.abs(wmu)),
                ("nu", g(st.nu[k]), wnu, nu[k] + grads[k] ** 2 + wnu)):
            over = np.abs(a - b) - 2 * ulp * size
            assert over.max() <= 0, (k, what, float(over.max()))
        step = LRS[k] * np.abs((wmu / c1) / (np.sqrt(wnu / c2) + EPS))
        tol = (8 * ulp + dc) * step + 2 * ulp * np.maximum(np.abs(params[k]),
                                                           np.abs(wp))
        over = np.abs(g(new_p[k]) - wp) - tol
        assert over.max() <= 0, (k, "param", float(over.max()))


def _bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def _same_result(got, want):
    (gp, gs), (wp, ws) = got, want
    assert gs.count == ws.count
    for k in PARAM_KEYS:
        for what, a, b in (("param", gp[k], wp[k]), ("mu", gs.mu[k], ws.mu[k]),
                           ("nu", gs.nu[k], ws.nu[k])):
            assert _bits_equal(a, b), (k, what, float((a - b).abs().max()))


def _snapshot(*dicts):
    return [{k: v.clone() for k, v in d.items()} for d in dicts]


def _adam_launches():
    from gslidar_tpu_torch.utils.trace import counters
    return counters().get("launches.adam", 0)


# ------------------------------------------------------------------- CPU
@pytest.mark.parametrize("layout", ["step", "model"])
@pytest.mark.parametrize("P", [1, 7, 1001])
@pytest.mark.parametrize("count", [0, 20000])
def test_cpu_plain_path_is_the_per_group_loop(P, count, layout):
    """CPU tensors take ``adam_step_reference``: today's loop bit for bit,
    inputs untouched, no launch."""
    from gslidar_tpu_torch.models.optim import adam_step
    params, grads, state = _groups(P, count, "cpu", seed=P + count,
                                   layout=layout)
    assert P == 1 or not grads["f_rest"].is_contiguous()
    before = _snapshot(params, grads, state.mu, state.nu)
    launched = _adam_launches()
    got = adam_step(params, grads, state, LRS)
    assert _adam_launches() == launched
    _same_result(got, _todays_loop(params, grads, state, LRS))
    for old, now in zip(before, (params, grads, state.mu, state.nu)):
        for k in PARAM_KEYS:
            assert _bits_equal(old[k], now[k])
    assert got[0]["xyz"] is not params["xyz"]


@pytest.mark.parametrize("P,count", JAX_CASES)
def test_jax_golden_is_the_jax_packages(P, count):
    """``adam_jax.npz`` holds, bit for bit, what the JAX package's
    ``adam_step`` gives now on ``_numpy_groups``' inputs."""
    want = _jax_golden(P, count)
    got = _jax_adam(P, count)
    assert sorted(got) == sorted(want)
    for key in got:
        assert got[key].dtype == want[key].dtype == np.float32
        assert np.array_equal(got[key].view(np.int32),
                              want[key].view(np.int32)), key


@pytest.mark.parametrize("P,count", JAX_CASES)
def test_cpu_plain_path_within_jax(P, count):
    """The plain path on the CPU, on the numpy groups with a fresh model's
    column ranges, within ``_assert_within_jax`` of the JAX package."""
    from gslidar_tpu_torch.models.optim import adam_step
    groups = _numpy_groups(P, count)
    got = adam_step(*_torch_groups(groups, count, "cpu", "model"), LRS)
    _assert_within_jax(got, _jax_golden(P, count), groups, count)


def _break(case, params, grads, state):
    if case == "noncontiguous_param":
        params["xyz"] = params["xyz"].t().contiguous().t()
    elif case == "transposed_grad":
        grads["rotation"] = grads["rotation"].t().contiguous().t()
    elif case == "noncontiguous_moment":
        state.nu["scaling"] = state.nu["scaling"].t().contiguous().t()
    elif case == "float64_grad":
        grads["opacity"] = grads["opacity"].double()
    elif case == "float64_param":
        params["t"] = params["t"].double()
    elif case == "mixed_device":
        grads["intensity"] = torch.empty(grads["intensity"].shape,
                                         device="meta")
    elif case == "other_shape":
        state.mu["velocity"] = state.mu["velocity"][:-1]
    elif case == "other_device":
        for d in (params, grads, state.mu, state.nu):
            for k in PARAM_KEYS:
                d[k] = torch.empty(d[k].shape, device="meta")


@pytest.mark.parametrize("case,error", [
    ("noncontiguous_param", ValueError), ("transposed_grad", ValueError),
    ("noncontiguous_moment", ValueError), ("float64_grad", TypeError),
    ("float64_param", TypeError), ("mixed_device", ValueError),
    ("other_shape", ValueError), ("other_device", ValueError)])
def test_refuses_what_the_kernel_does_not_take(case, error):
    """Non-contiguous parameters and moments, a gradient that is not
    contiguous rows, float64, mixed devices, other shapes and a device
    that is neither the CPU nor CUDA all raise, on every path."""
    from gslidar_tpu_torch.models.optim import adam_step
    params, grads, state = _groups(5, 3, "cpu")
    _break(case, params, grads, state)
    with pytest.raises(error):
        adam_step(params, grads, state, LRS)


def test_adam_bound_arithmetic():
    """``adam_bound``: 28 bytes an element over 3.35 TB/s sets it; 81
    floats a gaussian at 10M is 22.7 GB, 6.77 ms."""
    from gslidar_tpu_torch.microbench.bounds import ADAM_BYTES, adam_bound
    from benchmark.counts import ADAM_BYTES as COUNTED
    assert ADAM_BYTES == COUNTED == 28
    b = adam_bound(81 * 10_000_000, 1.98e9)
    assert b.by == "bytes"
    assert b.ms == pytest.approx(81e7 * 28 / 3.35e12 * 1e3)
    assert 6.76 < b.ms < 6.78
    assert b.terms["fp32"] == pytest.approx(81e7 * 12 / (128 * 132 * 1.98e9)
                                            * 1e3)
    assert adam_bound(0, 1.98e9).ms == 0.0


def _step_case(device, P=3000, h=16, w=64):
    """test_torch_trace's seeded dynamic step, its state and camera."""
    from test_torch_trace import _setup
    return _setup(device, P=P, h=h, w=w)


class _Calls:
    """Wraps engine.train's statistics helpers and counts their calls."""

    def __init__(self, monkeypatch):
        import gslidar_tpu_torch.engine.train as T
        self.n = {}
        for name in ("_transmat_for_stats", "densify_grads_from_T_tap"):
            fn = getattr(T, name)

            def wrapped(*a, _fn=fn, _name=name, **k):
                self.n[_name] = self.n.get(_name, 0) + 1
                return _fn(*a, **k)
            monkeypatch.setattr(T, name, wrapped)


def test_stats_off_step_equals_stats_on(monkeypatch):
    """A step with the statistics off: the loss, every gradient, the new
    parameters and Adam state and the prior's of the same step with them
    on, bit for bit; the statistics as they were; no splat frame and no
    viewspace gradient computed. With them on they move."""
    step, state, cam = _step_case("cpu")
    calls = _Calls(monkeypatch)
    outs = {}
    for on in (True, False):
        calls.n.clear()
        outs[on] = step(state, cam, 7001, 3, 0.0, on)
        assert calls.n == ({"_transmat_for_stats": 1,
                            "densify_grads_from_T_tap": 1} if on else {})
    (s1, l1, _, g1), (s0, l0, _, g0) = outs[True], outs[False]
    assert _bits_equal(l1, l0)
    assert set(g1) == set(g0)
    for k in g1:
        assert _bits_equal(g1[k], g0[k]), k
    _same_result((s0.params, s0.opt), (s1.params, s1.opt))
    assert _bits_equal(s0.prior, s1.prior)
    for a, b in zip(s0.prior_opt[:2], s1.prior_opt[:2]):
        assert _bits_equal(a, b)
    assert s0.aux is state.aux
    assert bool(s1.aux.denom.any()) and not bool(state.aux.denom.any())


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("P,count,layout", [
    (10_000_000, 20000, "step"), (1, 0, "step"), (7, 1, "step"),
    (1001, 20000, "step"), (4097, 3, "step"), (7, 0, "flat"),
    (100_003, 20000, "flat"), (7, 1, "model"), (100_003, 20000, "model")])
def test_card_kernel_is_the_plain_version(cuda_device, P, count, layout):
    """The kernel's new parameters and moments are the plain version's on
    the card, bit for bit, for every element of all ten groups; its
    inputs are untouched; one launch."""
    from gslidar_tpu_torch.models.optim import (adam_step,
                                                adam_step_reference)
    params, grads, state = _groups(P, count, cuda_device, seed=P + count,
                                   layout=layout)
    before = _snapshot(params, grads, state.mu, state.nu)
    launched = _adam_launches()
    got = adam_step(params, grads, state, LRS)
    assert _adam_launches() == launched + 1
    torch.cuda.synchronize()
    _same_result(got, adam_step_reference(params, grads, state, LRS))
    for old, now in zip(before, (params, grads, state.mu, state.nu)):
        for k in PARAM_KEYS:
            assert _bits_equal(old[k], now[k])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["step", "model"])
@pytest.mark.parametrize("P,count", JAX_CASES)
def test_card_kernel_matches_jax(cuda_device, P, count, layout):
    """The kernel on the card, on ``_numpy_groups``' inputs laid out as the
    step or a fresh model lays them out, within ``_assert_within_jax`` of
    the JAX package's ``adam_step`` (``adam_jax.npz``), and the plain
    version's result bit for bit."""
    from gslidar_tpu_torch.models.optim import (adam_step,
                                                adam_step_reference)
    groups = _numpy_groups(P, count)
    params, grads, state = _torch_groups(groups, count, cuda_device, layout)
    launched = _adam_launches()
    got = adam_step(params, grads, state, LRS)
    assert _adam_launches() == launched + 1
    _assert_within_jax(got, _jax_golden(P, count), groups, count)
    _same_result(got, adam_step_reference(params, grads, state, LRS))


@pytest.mark.cuda
def test_card_one_launch_per_adam_step(cuda_device):
    """Three calls, three launches; the kernel's second step from its
    first is the plain version's second step from its first."""
    from gslidar_tpu_torch.models.optim import (adam_step,
                                                adam_step_reference)
    params, grads, state = _groups(3001, 0, cuda_device)
    launched = _adam_launches()
    k1 = adam_step(params, grads, state, LRS)
    p1 = adam_step_reference(params, grads, state, LRS)
    k2 = adam_step(*k1[:1], grads, k1[1], LRS)
    p2 = adam_step_reference(*p1[:1], grads, p1[1], LRS)
    adam_step(*k2[:1], grads, k2[1], LRS)
    assert _adam_launches() == launched + 3
    _same_result(k2, p2)


@pytest.mark.cuda
def test_card_stats_off_step(cuda_device, monkeypatch):
    """A step of 100,000 gaussians at 66x515 on the card with the
    statistics off launches Adam once and computes no statistics' splat
    frame and no viewspace gradient; with them on, one of each."""
    step, state, cam = _step_case(cuda_device, P=100_000, h=66, w=515)
    calls = _Calls(monkeypatch)
    for on in (False, True):
        calls.n.clear()
        launched = _adam_launches()
        new = step(state, cam, 7001, 3, 0.0, on)[0]
        torch.cuda.synchronize()
        assert _adam_launches() == launched + 1
        assert calls.n == ({"_transmat_for_stats": 1,
                            "densify_grads_from_T_tap": 1} if on else {})
        assert (new.aux is state.aux) != on


@pytest.mark.cuda
def test_card_profiler_links_the_launch_to_its_span(cuda_device):
    """Under ``torch.profiler`` the kernel, which no torch op launches, is
    linked to the host span ``gs.adam.kernel`` that opens inside
    ``adam_step``, so a reader of the work launched inside ``adam_step``
    finds it."""
    from torch.profiler import ProfilerActivity, profile
    from gslidar_tpu_torch.models.optim import adam_step
    params, grads, state = _groups(100_003, 5, cuda_device)
    adam_step(params, grads, state, LRS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        adam_step(params, grads, state, LRS)
        torch.cuda.synchronize()
    linked = [k.name for e in prof.events() if e.name == "gs.adam.kernel"
              for k in e.kernels]
    assert len(linked) == 1 and "adam_kernel" in linked[0], linked


if __name__ == "__main__":
    _write_jax_golden()
