"""The port's sharded 360-degree renders (gslidar_tpu_torch.parallel.
pano_shard) at n = 4 slices on tests/test_parallel_pano.py's inputs (512
splats, 32x256 pixels, 8x32 tiles) and on a scene whose splats straddle
the phi = +-pi seam, for each of the hfov-sliced, SH-sharded and
gaussian-sharded renders:

* sliced through the loopback against the port's own unsliced
  ``rasterize`` at the JAX test's bars (mean |d| < 2e-4 * scale, its
  99.9th percentile < 5e-3 * scale, scale = 1 + mean |ref|), the seam
  scene against the circular (``wrap_x``) unsliced render;
* over 4 spawned gloo ranks, every rank's result bit for bit the
  loopback's;
* the gaussian-sharded render against the dense oracle
  (``raster/oracle.py``), which bins nothing, at the same bars, with no
  instance dropped and every routed record received;
* the guards' ValueErrors;
* (slow: JAX compiles its three shard_map renders for ~190 s on the CPU)
  the gloo result against gslidar_tpu's render on a 4-device CPU mesh,
  at tests/test_torch_render.py's bars.

The dense oracle is also held against gslidar_tpu's.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch_dist import run_ranks

from gslidar_tpu_torch.raster.scenes import pano_scene

torch.set_num_threads(2)

N = 4
KINDS = ("hfov", "sh", "gaussian")
PLANES = ("color", "feature", "depth", "alpha", "contrib", "final_T")


def _settings(kind, **kw):
    from gslidar_tpu_torch.raster.settings import RasterSettings
    return RasterSettings(height=32, width=256, vfov=(-24.9, 2.0),
                          hfov=(-180, 180), num_extra_features=4, tile_h=8,
                          tile_w=32, wrap_x=kind == "gaussian", **kw)


def _scene(seam):
    sc = pano_scene(np.random.default_rng(7), 512, seam=seam)
    return {k: torch.as_tensor(v) for k, v in sc.items()}


def _args(sc):
    return (sc["means"], sc["scales"], sc["quats"], sc["opac"], sc["shs"],
            sc["feats"], sc["mask"], sc["viewmat"], sc["campos"],
            torch.tensor([0.0, 0.0, 0.0, 1.0]), 3, 1.0)


def _render(kind, sc, group, settings=None, stats=None):
    """The sharded render's planes as numpy (and num_dropped)."""
    from gslidar_tpu_torch.parallel import pano_shard as ps
    st = settings or _settings(kind)
    with torch.no_grad():
        if kind == "hfov":
            out = ps.render_pano_sharded(*_args(sc), st, group)
        elif kind == "sh":
            out = ps.render_pano_sh_sharded(*_args(sc), st, group)
        else:
            out = ps.render_pano_gaussian_sharded(*_args(sc), st, group,
                                                  stats=stats)
    planes = {k: v.numpy() for k, v in zip(PLANES, out)}
    return planes, (out[6] if kind == "gaussian" else 0)


def _unsliced(kind, sc, circular=False):
    from gslidar_tpu_torch.raster.rasterize import rasterize
    st = dataclasses.replace(_settings(kind), wrap_x=True) if circular \
        else _settings(kind)
    with torch.no_grad():
        out = rasterize(*_args(sc), st)
    return {k: getattr(out, k).numpy() for k in PLANES}


def _check(tag, ref, got, names=("color", "feature", "depth", "alpha",
                                  "final_T")):
    """The JAX test's bars (tests/test_parallel_pano.py:48-60)."""
    for name in names:
        a, b = np.asarray(ref[name]), np.asarray(got[name])
        assert a.shape == b.shape, (tag, name, a.shape, b.shape)
        d = np.abs(a - b)
        scale = 1.0 + float(np.abs(a).mean())
        assert d.mean() < 2e-4 * scale, (tag, name, d.mean(), scale)
        assert np.quantile(d, 0.999) < 5e-3 * scale, \
            (tag, name, np.quantile(d, 0.999), scale)


@pytest.mark.parametrize("seam", [False, True], ids=["scene", "seam"])
@pytest.mark.parametrize("kind", KINDS)
def test_sliced_matches_unsliced(kind, seam):
    from gslidar_tpu_torch.parallel.comm import Loopback
    sc = _scene(seam)
    group = Loopback(N)
    got, dropped = _render(kind, sc, group)
    # the seam scene's reference is the circular render: the non-circular
    # one does not wrap the 2D low-pass distance at the seam, where each
    # slice, rendered in its own yawed frame, does
    _check(f"{kind} seam={seam}", _unsliced(kind, sc, circular=seam), got)
    assert dropped == 0
    assert group.calls["all_gather"] == (2 if kind == "sh" else 1)
    assert group.calls["all_to_all"] == (1 if kind == "gaussian" else 0)


def test_jit_closure_matches_direct_call():
    from gslidar_tpu_torch.parallel import pano_shard as ps
    from gslidar_tpu_torch.parallel.comm import Loopback
    sc = _scene(False)
    want, _ = _render("hfov", sc, Loopback(N))
    run = ps.render_pano_sharded_jit(_settings("hfov"), Loopback(N), 3, 1.0)
    with torch.no_grad():
        got = run(*_args(sc)[:10])
    for name, g in zip(PLANES, got):
        np.testing.assert_array_equal(g.numpy(), want[name], err_msg=name)


def _gloo_rank(rank, n):
    from gslidar_tpu_torch.parallel.comm import ProcessGroup
    group = ProcessGroup()
    return {(kind, seam): _render(kind, _scene(seam), group)
            for kind in KINDS for seam in (False, True)}


@pytest.fixture(scope="module")
def gloo_out():
    return run_ranks(_gloo_rank, N, timeout=240)


@pytest.mark.parametrize("kind", KINDS)
def test_gloo_matches_loopback_bitwise(kind, gloo_out):
    from gslidar_tpu_torch.parallel.comm import Loopback
    for seam in (False, True):
        want, want_drop = _render(kind, _scene(seam), Loopback(N))
        for rank, res in enumerate(gloo_out):
            got, drop = res[(kind, seam)]
            assert drop == want_drop == 0
            for name in PLANES:
                np.testing.assert_array_equal(got[name], want[name],
                                              err_msg=f"{rank} {name}")


@pytest.mark.parametrize("seam", [False, True], ids=["scene", "seam"])
def test_gaussian_sharded_matches_dense_oracle(seam):
    from gslidar_tpu_torch.parallel.comm import Loopback
    from gslidar_tpu_torch.raster.oracle import rasterize_dense
    sc = _scene(seam)
    stats = {}
    got, dropped = _render("gaussian", sc, Loopback(N), stats=stats)
    dense = {k: v.numpy() for k, v in rasterize_dense(
        *_args(sc), _settings("gaussian")).items()}
    _check(f"oracle seam={seam}", dense, got)
    assert dropped == 0
    assert sum(s["records_sent"] for s in stats.values()) == \
        sum(s["records_received"] for s in stats.values()) > 0
    assert all(s["instances"] > 0 for s in stats.values())
    if seam:
        # splats straddle the seam: the first and last slices both hold
        # records of run-split splats
        assert stats[0]["records_received"] > stats[1]["records_received"]
        assert stats[N - 1]["records_received"] > \
            stats[1]["records_received"]


@pytest.mark.parametrize("kind,change,match", [
    ("hfov", dict(width=250), "width 250 not divisible"),
    ("sh", dict(), "P 510 not divisible"),
    ("gaussian", dict(wrap_x=False), "circular pano"),
    ("gaussian", dict(width=320), "whole 32-pixel tile columns"),
    ("gaussian", dict(), "P 510 not divisible"),
])
def test_guards_raise(kind, change, match):
    from gslidar_tpu_torch.parallel.comm import Loopback
    sc = _scene(False)
    if match.startswith("P "):
        sc = {k: (v[:510] if v.dim() and v.shape[0] == 512 else v)
              for k, v in sc.items()}
    st = dataclasses.replace(_settings(kind), **change)
    with pytest.raises(ValueError, match=match):
        _render(kind, sc, Loopback(N), settings=st)


def test_dense_oracle_matches_jax():
    import jax.numpy as jnp
    from gslidar_tpu.raster.oracle import rasterize_dense as jdense
    from gslidar_tpu.raster.settings import RasterSettings as JS
    from gslidar_tpu_torch.raster.oracle import rasterize_dense
    sc = pano_scene(np.random.default_rng(11), 96, seam=True)
    ts = _settings("gaussian")
    js = JS(height=32, width=256, vfov=(-24.9, 2.0), hfov=(-180, 180),
            num_extra_features=4, tile_h=8, tile_w=32, wrap_x=True,
            backend="xla")
    args = ("means", "scales", "quats", "opac", "shs", "feats", "mask",
            "viewmat", "campos")
    bg = [0.0, 0.0, 0.0, 1.0]
    want = jdense(*(jnp.asarray(sc[k]) for k in args), jnp.asarray(bg), 3,
                  1.0, js)
    got = rasterize_dense(*(torch.as_tensor(sc[k]) for k in args),
                          torch.tensor(bg), 3, 1.0, ts)
    for name, tol in (("color", 5e-4), ("feature", 2e-3), ("alpha", 5e-4),
                      ("final_T", 5e-4), ("radii", 0)):
        np.testing.assert_allclose(got[name].numpy(),
                                   np.asarray(want[name]), atol=tol,
                                   err_msg=name)
    np.testing.assert_allclose(got["depth"][0].numpy(),
                               np.asarray(want["depth"][0]), atol=2e-2)
    assert float(np.asarray(want["alpha"]).max()) > 0.5


_JAX_CODE = r"""
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
sys.path.insert(0, "tests")
from gslidar_tpu.raster import RasterSettings
from gslidar_tpu.parallel.pano_shard import (render_pano_sharded,
    render_pano_sh_sharded, render_pano_gaussian_sharded)
from gslidar_tpu_torch.raster.scenes import pano_scene

assert len(jax.devices()) == 4, jax.devices()
mesh = Mesh(np.array(jax.devices()), ("data",))
st = RasterSettings(height=32, width=256, vfov=(-24.9, 2.0),
                    hfov=(-180, 180), num_extra_features=4,
                    pair_cap=1 << 14, tile_chunk=64, tile_list_cap=512,
                    tile_h=8, tile_w=32, backend="xla")
out = {}
for seam in (False, True):
    sc = pano_scene(np.random.default_rng(7), 512, seam=seam)
    a = [jnp.asarray(sc[k]) for k in ("means", "scales", "quats", "opac",
         "shs", "feats", "mask", "viewmat", "campos")]
    a += [jnp.asarray([0.0, 0.0, 0.0, 1.0]), 3, 1.0]
    for kind, fn, s in (
            ("hfov", render_pano_sharded, st),
            ("sh", render_pano_sh_sharded, st),
            ("gaussian", render_pano_gaussian_sharded,
             dataclasses.replace(st, wrap_x=True))):
        r = fn(*a, s, mesh)
        if kind == "gaussian":
            assert int(r[6]) == 0, int(r[6])
        for name, v in zip(("color", "feature", "depth", "alpha",
                            "contrib", "final_T"), r):
            out[f"{kind}-{int(seam)}-{name}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
print("JAX_PANO_OK")
"""


@pytest.mark.slow
@pytest.mark.parametrize("kind", KINDS)
def test_gloo_matches_jax(kind, gloo_out, tmp_path_factory):
    import os
    import subprocess
    import sys
    from tests.conftest import REPO
    path = tmp_path_factory.getbasetemp() / "jax_pano.npz"
    if not path.exists():
        env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        r = subprocess.run([sys.executable, "-c", _JAX_CODE, str(path)],
                           env=env, cwd=REPO, capture_output=True,
                           text=True, timeout=900)
        assert r.returncode == 0 and "JAX_PANO_OK" in r.stdout, \
            r.stderr[-3000:]
    ref = np.load(path)
    for seam in (False, True):
        got, _ = gloo_out[0][(kind, seam)]
        pre = f"{kind}-{int(seam)}-"
        assert (ref[pre + "alpha"][0] > 0.5).mean() > 0.1
        report = {}
        for name, tol in (("color", 5e-4), ("feature", 2e-3),
                          ("alpha", 5e-4), ("final_T", 5e-4)):
            d = np.abs(got[name] - ref[pre + name])
            report[name] = float(d.max())
            np.testing.assert_allclose(got[name], ref[pre + name], atol=tol,
                                       err_msg=f"{pre}{name}")
        np.testing.assert_allclose(got["depth"][0], ref[pre + "depth"][0],
                                   atol=2e-2, err_msg=pre + "depth")
        print(kind, seam, json.dumps(report))
