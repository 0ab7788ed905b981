"""The chamfer term's kernel pair (``gslidar_tpu_torch/ops/chamfer.py``,
``csrc/chamfer.cu``) against its plain version, ``chamfer_reference``.

On the CPU: ``chamfer_distance`` takes the plain path for CPU tensors,
bit for bit, with its host syncs counted and no launch; it refuses other
devices; ``microbench/bounds.py::chamfer_bound``'s arithmetic.

On the card (``-m cuda``, an H100): the forward and backward kernels on a
training step's two 66x515 panorama clouds with ~10 % of each invalid,
eval's 66x1030 clouds unmasked, ragged sizes, an empty side, an all-invalid
mask and duplicated points. Each distance is the kernel's own pick's,
(dx^2 + dy^2) + dz^2 bit for bit, and equals the plain version's within
the rounding of the sum's order (``SUM_ORDER_ROUNDING``) wherever the two
pick the same neighbour; where they pick another the kernel's is no larger
and the two are a near-tie, within the rounding of the plain version's
|a|^2 + |b|^2 - 2 a.b (``_check_side``); ties go to the lowest index. The
means and the gradients match within stated tolerances; one launch of each
kernel a call, and no host sync.
"""

import numpy as np
import pytest
import torch

# float32's unit roundoff, 2^-24, twice: the rounding of one expansion
# |a|^2 + |b|^2 - 2 a.b relative to |a|^2 + |b|^2
EXPANSION_ROUNDING = 1.2e-7
# a sum of 3 non-negative float32 terms in two orders: each is within 2
# roundoffs (2^-24) of the exact sum, so the two within 4 of each other,
# 2 ulps; held to 4 ulps (2^-21 of the sum), a few ulps as a bound
SUM_ORDER_ROUNDING = 2.0 ** -21


def _launches():
    from gslidar_tpu_torch.utils.trace import counters
    c = counters()
    return (c.get("launches.chamfer_fwd", 0),
            c.get("launches.chamfer_bwd", 0))


def _pano_cloud(rng, h, w, invalid, device):
    """The points of a seeded range panorama of h x w (ranges 2-40) and
    its validity mask, ``invalid`` of the pixels dropped, as
    ``engine/losses.py`` makes them (``pano_to_lidar``)."""
    from gslidar_tpu_torch.ops.pano import pano_to_lidar
    depth = rng.uniform(2, 40, (1, h, w)).astype(np.float32)
    depth[rng.random((1, h, w)) < invalid] = 0
    pts, mask = pano_to_lidar(torch.as_tensor(depth, device=device),
                              (-24.9, 2.0), (-90, 90))
    return pts, mask


# ------------------------------------------------------------------- CPU
def test_cpu_tensors_take_the_plain_path():
    """CPU tensors run ``chamfer_reference``: the same bits, values and
    gradients, its host syncs counted, no kernel launched."""
    from gslidar_tpu_torch.ops.chamfer import (chamfer_distance,
                                               chamfer_reference)
    from gslidar_tpu_torch.utils.trace import counters
    rng = np.random.default_rng(5)
    x1 = torch.as_tensor(rng.normal(size=(300, 3)).astype(np.float32))
    x2 = torch.as_tensor(rng.normal(size=(200, 3)).astype(np.float32))
    m1 = torch.as_tensor(rng.random(300) < 0.9)
    m2 = torch.as_tensor(rng.random(200) < 0.8)
    outs, grads = [], []
    for fn in (chamfer_distance, chamfer_reference):
        a = x1.clone().requires_grad_(True)
        before, launched = counters(), _launches()
        d1, d2, s1, s2 = fn(a, x2, m1, m2, chunk=64)
        grads.append(torch.autograd.grad(s1 + s2, a)[0])
        after = counters()
        syncs = {k: after[k] - before.get(k, 0) for k in after
                 if k.startswith("host_syncs.chamfer")
                 and after[k] != before.get(k, 0)}
        assert syncs == {"host_syncs.chamfer_mask": 2,
                         "host_syncs.chamfer_index_bwd": 1,
                         "host_syncs.chamfer_scatter_bwd": 2}
        assert _launches() == launched
        outs.append((d1, d2, s1, s2))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert torch.equal(*grads)


def test_other_devices_are_refused():
    """A meta tensor is neither a CPU nor a CUDA tensor: refused."""
    from gslidar_tpu_torch.ops.chamfer import chamfer_distance
    x = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        chamfer_distance(x, x)


def test_chamfer_bound_arithmetic():
    """``chamfer_bound``: the forward at 6 float32 instructions a pair of
    each direction (3 subtractions, a multiplication, 2 FMAs) against 21
    bytes a point, the backward at 7 a query against 32 bytes a point;
    128 instructions a clock on 132 SMs, 3.35 TB/s. The fp32 term sets the
    forward at a step's size, the bytes the backward and the forward at a
    handful of points."""
    from gslidar_tpu_torch.microbench.bounds import (
        CHAMFER_PAIR_FP32_UNFUSED, chamfer_bound)
    n, clock = 33990, 1.98e9
    fwd, bwd = chamfer_bound(n, n, clock)
    assert fwd.by == "fp32"
    assert fwd.ms == pytest.approx(2 * n * n * 6 / (128 * 132 * clock) * 1e3)
    assert 0.41 < fwd.ms < 0.42
    # the kernel's unfused 8 a pair would read 4/3 of it
    assert fwd.ms * CHAMFER_PAIR_FP32_UNFUSED / 6 == pytest.approx(
        2 * n * n * 8 / (128 * 132 * clock) * 1e3)
    assert fwd.terms["bytes"] == pytest.approx(2 * n * 21 / 3.35e12 * 1e3)
    assert bwd.by == "bytes"
    assert bwd.ms == pytest.approx(2 * n * 32 / 3.35e12 * 1e3)
    assert bwd.terms["fp32"] == pytest.approx(
        2 * n * 7 / (128 * 132 * clock) * 1e3)
    assert chamfer_bound(2, 3, clock)[0].by == "bytes"
    assert [b.ms for b in chamfer_bound(0, 0, clock)] == [0.0, 0.0]


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _plain_nearest(a, b, chunk=4096):
    """The plain version's pick, by the expansion form's argmin (as
    ``_one_sided_min_sqdist``), over all of a and b (-1 where b is
    empty)."""
    if b.shape[0] == 0:
        return torch.full((a.shape[0],), -1, dtype=torch.int64,
                          device=a.device)
    bsq = torch.sum(b * b, dim=-1)
    out = []
    for i in range(0, a.shape[0], chunk):
        blk = a[i:i + chunk]
        d2 = (torch.sum(blk * blk, dim=-1)[:, None] + bsq[None, :]
              - 2.0 * blk @ b.T)
        out.append(torch.argmin(d2, dim=1))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64,
                                                  device=a.device)


def _amax(t):
    """The largest element of t, 0 when t is empty."""
    return float(t.max()) if t.numel() else 0.0


def _sqdist(a, b):
    d = a - b
    return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]


def _check_side(x, y, mx, my, dist, idx, plain_dist):
    """One direction: the kernel's (dist, idx) of queries x against y
    against the plain version's distances and picks. Returns the queries
    whose picks differ."""
    qi = torch.nonzero(mx).squeeze(1)
    ri = torch.nonzero(my).squeeze(1)
    assert torch.all(dist[~mx] == 0) and torch.all(idx[~mx] == -1)
    if ri.numel() == 0:
        assert torch.all(dist == 0) and torch.all(idx == -1)
        return torch.zeros(0, dtype=torch.int64, device=x.device)
    k = idx[qi].long()
    assert torch.all(my[k]), "an invalid point won"
    # the kernel's distance is its own pick's, and the least of them all
    assert torch.equal(dist[qi], _sqdist(x[qi], y[k]))
    p = ri[_plain_nearest(x[qi], y[ri])]
    same = p == k
    dk, dp = dist[qi][same], plain_dist[qi][same]
    assert torch.all((dk - dp).abs() <= SUM_ORDER_ROUNDING * dp), \
        float(((dk - dp).abs() / dp.clamp_min(1e-30)).max())
    diff = ~same
    if bool(diff.any()):
        a, bk, bp = x[qi][diff], y[k[diff]], y[p[diff]]
        dk, dp = dist[qi][diff], _sqdist(a, bp)
        assert torch.all(dk <= dp)
        na = torch.sum(a * a, -1)
        scale = (na + torch.sum(bk * bk, -1)) + (na + torch.sum(bp * bp, -1))
        assert torch.all(dp - dk <= EXPANSION_ROUNDING * scale), \
            float(((dp - dk) / scale).max())
    return qi[diff]


def _gradient_formula(x1, x2, i1, i2, g1, g2):
    """The kernel's gradients written out in float64 from its own
    picks: g (2 (a - b)) to each valid query, its negation to its
    neighbour."""
    d1 = torch.zeros(x1.shape, dtype=torch.float64, device=x1.device)
    d2 = torch.zeros(x2.shape, dtype=torch.float64, device=x1.device)
    for a, b, idx, g, da, db in ((x1, x2, i1, g1, d1, d2),
                                 (x2, x1, i2, g2, d2, d1)):
        q = torch.nonzero(idx >= 0).squeeze(1)
        j = idx[q].long()
        t = g[q, None].double() * (2.0 * (a[q].double() - b[j].double()))
        da.index_add_(0, q, t)
        db.index_add_(0, j, -t)
    return d1, d2


def _run(x1, x2, m1, m2, grad_both=True):
    """Kernel and plain version on the same clouds; checks everything
    the docstring names. Returns the number of queries whose picks
    differ."""
    from gslidar_tpu_torch.ops.chamfer import (chamfer_distance,
                                               chamfer_nearest,
                                               chamfer_reference)
    dev = x1.device
    if m1 is None:
        m1 = torch.ones(x1.shape[0], dtype=torch.bool, device=dev)
    if m2 is None:
        m2 = torch.ones(x2.shape[0], dtype=torch.bool, device=dev)
    a = x1.detach().clone().requires_grad_(True)
    b = x2.detach().clone().requires_grad_(grad_both)
    before = _launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        d1, d2, s1, s2 = chamfer_distance(a, b, m1, m2)
        loss = s1 + 0.5 * s2
        want = [a, b] if grad_both else [a]
        got = torch.autograd.grad(loss, want)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 1, before[1] + 1)
    dist1, idx1, dist2, idx2 = chamfer_nearest(x1, x2, m1, m2)
    assert torch.equal(dist1, d1) and torch.equal(dist2, d2)

    pa = x1.detach().clone().requires_grad_(True)
    pb = x2.detach().clone().requires_grad_(grad_both)
    p1, p2, ps1, ps2 = chamfer_reference(pa, pb, m1, m2)
    pwant = [pa, pb] if grad_both else [pa]
    ploss = ps1 + 0.5 * ps2
    # with an empty or all-invalid side the plain version's terms are new
    # zeros, off the graph: its gradient is zero
    pgot = (torch.autograd.grad(ploss, pwant) if ploss.requires_grad
            else [torch.zeros_like(t) for t in pwant])
    s1, s2, ps1, ps2 = (t.detach() for t in (s1, s2, ps1, ps2))
    off1 = _check_side(x1, x2, m1, m2, dist1, idx1, p1.detach())
    off2 = _check_side(x2, x1, m2, m1, dist2, idx2, p2.detach())

    # means: within the sums' rounding and the near-ties' share
    for s, ps in ((s1, ps1), (s2, ps2)):
        assert abs(float(s - ps)) <= 1e-6 * abs(float(ps)) + 1e-12

    # gradients: against the formula from the kernel's own picks (the
    # atomics add in no fixed order: 1e-5 of the largest), and against
    # autograd through the plain version wherever no differing pick
    # reaches a point
    n1, n2 = torch.clamp_min(m1.sum(), 1), torch.clamp_min(m2.sum(), 1)
    g1 = torch.where(m1, 1.0 / n1, 0.0).float()
    g2 = torch.where(m2, 0.5 / n2, 0.0).float()
    f1, f2 = _gradient_formula(x1, x2, idx1, idx2, g1, g2)
    for k, f in zip(got, (f1, f2)):
        assert _amax((k.double() - f).abs()) <= 1e-5 * _amax(f.abs())
    touched1 = torch.zeros(x1.shape[0], dtype=torch.bool, device=dev)
    touched2 = torch.zeros(x2.shape[0], dtype=torch.bool, device=dev)
    touched1[off1] = True
    touched2[off2] = True
    touched2[idx1[off1].long()] = True
    touched1[idx2[off2].long()] = True
    pick1 = _plain_nearest(x1[off1], x2[m2]) if off1.numel() else None
    pick2 = _plain_nearest(x2[off2], x1[m1]) if off2.numel() else None
    if pick1 is not None:
        touched2[torch.nonzero(m2).squeeze(1)[pick1]] = True
    if pick2 is not None:
        touched1[torch.nonzero(m1).squeeze(1)[pick2]] = True
    for k, p, t in zip(got, pgot, (touched1, touched2)):
        assert _amax((k - p)[~t].abs()) <= 1e-5 * _amax(p.abs())
    return off1.numel() + off2.numel()


@pytest.mark.cuda
def test_card_step_panoramas(cuda_device):
    """A training step's two 66x515 clouds, 33,990 points each, ~10 % of
    each invalid (seeded); the predicted cloud alone needs a gradient, as
    in the step."""
    rng = np.random.default_rng(2718)
    x1, m1 = _pano_cloud(rng, 66, 515, 0.1, cuda_device)
    x2, m2 = _pano_cloud(rng, 66, 515, 0.1, cuda_device)
    assert x1.shape == (33990, 3)
    _run(x1 / 7.0, x2 / 7.0, m1, m2, grad_both=False)


@pytest.mark.cuda
def test_card_eval_clouds(cuda_device):
    """Eval's 66x1030 clouds, 67,980 points each, unmasked."""
    rng = np.random.default_rng(31)
    x1, _ = _pano_cloud(rng, 66, 1030, 0.0, cuda_device)
    x2, _ = _pano_cloud(rng, 66, 1030, 0.0, cuda_device)
    _run(x1, x2, None, None)


@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2", [(1, 257), (255, 4097), (4097, 1),
                                   (257, 255), (0, 100), (100, 0)])
def test_card_ragged_and_empty(cuda_device, n1, n2):
    """Ragged sizes about a warp, a block and a tile, and an empty side
    (its partner's distances 0, its picks -1)."""
    rng = np.random.default_rng(n1 * 7919 + n2)
    x1 = torch.as_tensor(rng.normal(size=(n1, 3)).astype(np.float32) * 4,
                         device=cuda_device)
    x2 = torch.as_tensor(rng.normal(size=(n2, 3)).astype(np.float32) * 4,
                         device=cuda_device)
    m1 = torch.as_tensor(rng.random(n1) < 0.9, device=cuda_device)
    m2 = torch.as_tensor(rng.random(n2) < 0.9, device=cuda_device)
    _run(x1, x2, m1, m2)


@pytest.mark.cuda
def test_card_all_invalid_mask(cuda_device):
    """One cloud all invalid: its distances 0, and the other cloud's 0
    with no neighbour; no gradient."""
    from gslidar_tpu_torch.ops.chamfer import chamfer_nearest
    rng = np.random.default_rng(3)
    x1 = torch.as_tensor(rng.normal(size=(1500, 3)).astype(np.float32),
                         device=cuda_device)
    x2 = torch.as_tensor(rng.normal(size=(900, 3)).astype(np.float32),
                         device=cuda_device)
    m1 = torch.zeros(1500, dtype=torch.bool, device=cuda_device)
    m2 = torch.ones(900, dtype=torch.bool, device=cuda_device)
    _run(x1, x2, m1, m2)
    d1, i1, d2, i2 = chamfer_nearest(x1, x2, m1, m2)
    assert torch.all(d1 == 0) and torch.all(i1 == -1)
    assert torch.all(d2 == 0) and torch.all(i2 == -1)


@pytest.mark.cuda
def test_card_ties_go_to_the_lowest_index(cuda_device):
    """Every point of the second cloud twice, the copies 3,000 apart and
    so in other slices of the scan: each pick is the first copy, as the
    plain version's argmin picks; a query on a point has distance 0 and
    picks it."""
    from gslidar_tpu_torch.ops.chamfer import chamfer_nearest
    rng = np.random.default_rng(11)
    p = rng.normal(size=(3000, 3)).astype(np.float32)
    q = np.concatenate([p[:500], rng.normal(size=(2000, 3))]).astype(
        np.float32)
    x1 = torch.as_tensor(q, device=cuda_device)
    x2 = torch.as_tensor(np.concatenate([p, p]), device=cuda_device)
    _run(x1, x2, None, None)
    d1, i1, _, _ = chamfer_nearest(
        x1, x2, torch.ones(2500, dtype=torch.bool, device=cuda_device),
        torch.ones(6000, dtype=torch.bool, device=cuda_device))
    assert torch.all(i1 < 3000)
    assert torch.all(d1[:500] == 0)
    assert torch.equal(i1[:500].long(), torch.arange(500, device=cuda_device))
