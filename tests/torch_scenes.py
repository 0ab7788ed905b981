"""Seeded inputs shared by the tests/test_torch_*.py parity tests.

Every scene is numpy, made from a seed, and handed to both packages: the
JAX reference (``gslidar_tpu``) and the PyTorch port
(``gslidar_tpu_torch``). The JAX side runs its plain XLA path
(``backend="xla"``) with caps large enough that nothing is dropped. The
scenes themselves are the port's (``gslidar_tpu_torch.raster.scenes``),
which its smoke test on the card uses too.
"""

from gslidar_tpu_torch.raster.scenes import (  # noqa: F401
    deep_tile_scene, long_tile_scene, opaque_front_tile_scene, port_rows,
    splat_scene)


def settings_pair(height=30, width=130, hfov=(-60.0, 60.0), S=2,
                  wrap=False, tile_h=16, tile_w=16, **kw):
    """(JAX RasterSettings, port RasterSettings) of one panorama."""
    from gslidar_tpu.raster.settings import RasterSettings as JS
    from gslidar_tpu_torch.raster.settings import RasterSettings as TS
    common = dict(height=height, width=width, vfov=(-20.0, 20.0), hfov=hfov,
                  num_extra_features=S, tile_h=tile_h, tile_w=tile_w,
                  wrap_x=wrap, **kw)
    js = JS(pair_cap=1 << 16, tile_chunk=32, tile_list_cap=1 << 12,
            backend="xla", **common)
    return js, TS(**common)


def to_torch(sc):
    import torch
    return {k: torch.as_tensor(v) for k, v in sc.items()}


def to_jax(sc):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in sc.items()}
