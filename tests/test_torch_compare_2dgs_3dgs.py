"""The port's 2DGS / 3DGS comparison script
(``gslidar_tpu_torch/scripts/compare_2dgs_3dgs.py``) against
scripts/compare_2dgs_3dgs.py, whose functions are imported here on the
CPU:

* the port's ``make_scene`` gives the script's scene (to float32 rounding:
  each package rotates the grid with its own float32 ``quat_to_rotmat``);
* on the script's scenes (8 x 8 and 2 x 2 disks) at its 150 x 625
  panorama, ``surface_splatting`` and ``volume_splatting`` give its colour
  and depth maps within 1e-5 of each map's largest magnitude;
* ``python -m gslidar_tpu_torch.scripts.compare_2dgs_3dgs --device cpu``
  writes case1.png and case2.png.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_compare_2dgs_3dgs",
        os.path.join(REPO, "scripts", "compare_2dgs_3dgs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n", [8, 2])
def test_splatting_matches_script(n):
    import jax.numpy as jnp
    from gslidar_tpu_torch.scripts import compare_2dgs_3dgs as C
    J = _jax_script()
    scene = [np.asarray(a) for a in J.make_scene(n)]
    for got, want in zip(C.make_scene(n), scene):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    for name in ("surface_splatting", "volume_splatting"):
        want = getattr(J, name)(*map(jnp.asarray, scene), jnp.eye(4), C.H,
                                C.W)
        got = getattr(C, name)(*map(torch.tensor, scene), torch.eye(4), C.H,
                               C.W)
        for kind, a, b in zip(("colour", "depth"), got, want):
            b = np.asarray(b)
            assert a.shape == b.shape and np.abs(b).max() > 0
            err = float(np.abs(a.numpy() - b).max() / np.abs(b).max())
            assert err <= 1e-5, f"{name} {kind}: {err:.3g} of the largest"


def test_script_writes_its_grids(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "gslidar_tpu_torch.scripts.compare_2dgs_3dgs",
         "--device", "cpu", "--out", str(tmp_path / "out")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    for case in ("case1", "case2"):
        png = tmp_path / "out" / f"{case}.png"
        assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
