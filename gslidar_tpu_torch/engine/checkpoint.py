"""Checkpoints in gslidar_tpu's format, without JAX (port of
gslidar_tpu/engine/checkpoint.py).

A ``gslidar_tpu`` checkpoint is an npz of the leaves of its TrainState
pytree, ``leaf_0 .. leaf_{n-1}`` in ``jax.tree.flatten`` order, plus
``iteration``. That order is:

* the 10 params, in sorted-key order (dict leaves flatten sorted);
* ``GaussianAux``: alive, max_radii2D, xyz_gradient_accum,
  xyz_gradient_accum_abs, t_gradient_accum, denom;
* ``AdamState``: 10 first moments, 10 second moments, count;
* ``prior``;
* the prior's Adam state: first moment, second moment, count.

This package writes that layout with ``alive`` all True, so that
``gslidar_tpu.engine.checkpoint.load_checkpoint`` reads it unchanged, and
reads a ``gslidar_tpu`` one cut to its ``alive`` rows. It writes with
``np.savez``, uncompressed: the leaves of a 1M-gaussian state are ~1 GB
of floats that do not compress, and deflating them would take tens of
seconds. tests/test_torch_checkpoint.py pins the layout against the JAX
package's own ``save_checkpoint`` and ``load_checkpoint``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from gslidar_tpu_torch.engine.train import (TrainState, state_from_numpy,
                                            state_to_numpy)
from gslidar_tpu_torch.models.gaussians import (PARAM_KEYS, GaussianAux,
                                                params_from_numpy)
from gslidar_tpu_torch.models.optim import AdamState

SORTED_KEYS = sorted(PARAM_KEYS)
AUX_FIELDS = [f.name for f in dataclasses.fields(GaussianAux)]
N_LEAVES = 3 * len(PARAM_KEYS) + len(AUX_FIELDS) + 1 + 4


def state_leaves(s: TrainState) -> list:
    """A TrainState of numpy leaves (``state_to_numpy``) -> its leaves in
    gslidar_tpu's flatten order."""
    return ([s.params[k] for k in SORTED_KEYS]
            + [getattr(s.aux, f) for f in AUX_FIELDS]
            + [s.opt.mu[k] for k in SORTED_KEYS]
            + [s.opt.nu[k] for k in SORTED_KEYS]
            + [s.opt.count, s.prior, *s.prior_opt])


def state_from_leaves(leaves) -> TrainState:
    """The inverse of ``state_leaves``."""
    n = len(PARAM_KEYS)
    it = iter(leaves)

    def take(k):
        return [next(it) for _ in range(k)]
    params = dict(zip(SORTED_KEYS, take(n)))
    aux = GaussianAux(**dict(zip(AUX_FIELDS, take(len(AUX_FIELDS)))))
    mu, nu = dict(zip(SORTED_KEYS, take(n))), dict(zip(SORTED_KEYS, take(n)))
    (count,) = take(1)
    prior, p_mu, p_nu, p_count = take(4)
    return TrainState(params=params, aux=aux,
                      opt=AdamState(mu=mu, nu=nu, count=count),
                      prior=prior, prior_opt=(p_mu, p_nu, p_count))


def save_checkpoint(path: str, state: TrainState, iteration: int) -> None:
    arrays = {f"leaf_{i}": x
              for i, x in enumerate(state_leaves(state_to_numpy(state)))}
    arrays["iteration"] = np.asarray(iteration)
    np.savez(path, **arrays)


def read_checkpoint(path: str):
    """(TrainState of numpy leaves as saved, iteration)."""
    with np.load(path) as data:
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        if n != N_LEAVES:
            raise ValueError(f"{path}: {n} leaves, a gslidar_tpu TrainState "
                             f"has {N_LEAVES}")
        leaves = [data[f"leaf_{i}"] for i in range(n)]
        iteration = int(data["iteration"])
    s = state_from_leaves(leaves)
    if s.aux.alive.dtype != np.bool_ or s.prior.ndim != 3:
        raise ValueError(f"{path}: unexpected leaf layout (alive "
                         f"{s.aux.alive.dtype}, prior {s.prior.shape})")
    return s, iteration


def load_train_state(path: str, device):
    """(TrainState on ``device``, cut to the saved ``alive`` rows with
    their moments, aux and step counts; iteration): what a resume
    starts from."""
    s, iteration = read_checkpoint(path)
    return state_from_numpy(s, device), iteration


def load_checkpoint(path: str, device):
    """Returns (params dict, alive [N] bool, prior [1, h, 2w], iteration)
    as tensors on ``device``: what the serving CLI reads."""
    s, iteration = read_checkpoint(path)
    return (params_from_numpy(s.params, device),
            torch.as_tensor(s.aux.alive, device=device),
            torch.as_tensor(s.prior, dtype=torch.float32, device=device),
            iteration)


def checkpoint_path(model_path: str, iteration: int) -> str:
    return os.path.join(model_path, "ckpt", f"chkpnt{iteration}.npz")


def latest_checkpoint(model_path: str, iterations) -> str | None:
    """The checkpoint of the last of ``iterations`` that exists."""
    found = None
    for it in iterations:
        p = checkpoint_path(model_path, it)
        if os.path.exists(p):
            found = p
    return found
