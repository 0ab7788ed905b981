"""Per-group Adam with explicit moments (port of
gslidar_tpu/models/optim.py; reference torch.optim.Adam(param_groups,
eps=1e-15), scene/gaussian_model.py:278-321).

The moments are plain tensors rather than a ``torch.optim`` state, so that
densification can cut, gather and zero them per gaussian, as the
reference's optimizer surgery does (gaussian_model.py:328-412). xyz and t
decay log-linearly over training; the other groups are constant.

``adam_step`` updates every group: on CUDA tensors in one launch of the
kernel of csrc/adam.cu (``_adam_step_kernel``, counted as
``launches.adam``), on CPU tensors by the plain version,
``adam_step_reference``. Both return new tensors and leave their inputs
as they are; on the card the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from gslidar_tpu_torch.kernels import launch
from gslidar_tpu_torch.models.gaussians import PARAM_KEYS, Params
from gslidar_tpu_torch.utils.trace import count, span

B1, B2, EPS = 0.9, 0.999, 1e-15


class AdamState(NamedTuple):
    mu: Params
    nu: Params
    count: int


def init_adam(params: Params) -> AdamState:
    return AdamState(mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()},
                     count=0)


def adam_from_numpy(mu, nu, count, device, keep=None) -> AdamState:
    """gslidar_tpu's AdamState (numpy leaves; ``keep`` selects rows, e.g.
    its ``alive`` slots) -> AdamState on ``device``."""
    def t(d):
        return {k: torch.as_tensor(np.asarray(d[k], np.float32)
                                   [slice(None) if keep is None else keep],
                                   device=device) for k in PARAM_KEYS}
    return AdamState(mu=t(mu), nu=t(nu), count=int(count))


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1000000) -> float:
    """Log-linear decay (reference utils/general_utils.py:61-94; the JAX
    package's expon_lr_jnp)."""
    if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
        return 0.0
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
    else:
        delay_rate = 1.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return delay_rate * math.exp(math.log(lr_init) * (1 - t)
                                 + math.log(lr_final) * t)


def group_lrs(args, iteration) -> Dict[str, float]:
    """Per-group learning rates at ``iteration`` (training_setup and
    update_learning_rate, gaussian_model.py:285-321; spatial_lr_scale 1)."""
    final_decay = args.position_lr_final / args.position_lr_init
    return {
        "xyz": expon_lr(iteration, args.position_lr_init,
                        args.position_lr_final,
                        lr_delay_mult=args.position_lr_delay_mult,
                        max_steps=args.iterations),
        "t": expon_lr(iteration, args.t_lr_init,
                      args.t_lr_init * final_decay,
                      lr_delay_mult=args.position_lr_delay_mult,
                      max_steps=args.iterations),
        "f_dc": args.feature_lr,
        "f_rest": args.feature_lr / 20.0,
        "opacity": args.opacity_lr,
        "scaling": args.scaling_lr,
        "rotation": args.rotation_lr,
        "scaling_t": args.scaling_t_lr,
        "intensity": args.intensity_lr,
        "velocity": args.velocity_lr if args.dynamic else 0.0,
    }


def adam_step(params: Params, grads: Params, state: AdamState,
              lrs: Dict[str, float]) -> tuple[Params, AdamState]:
    """One Adam step of every group (``PARAM_KEYS``); returns new tensors
    and leaves its inputs as they are. ``_adam_step_kernel`` on CUDA
    tensors, ``adam_step_reference`` on CPU tensors; any other device, a
    dtype other than float32, mixed devices, shapes that differ, or a
    layout ``_rows`` does not take raises (``_check_groups``)."""
    dev = params[PARAM_KEYS[0]].device
    if dev.type == "cuda":
        return _adam_step_kernel(params, grads, state, lrs)
    _check_groups(params, grads, state)
    if dev.type != "cpu":
        raise ValueError(f"adam_step runs on cpu or cuda tensors, not {dev}")
    return adam_step_reference(params, grads, state, lrs)


def adam_step_reference(params: Params, grads: Params, state: AdamState,
                        lrs: Dict[str, float]) -> tuple[Params, AdamState]:
    """The plain version of ``adam_step``, on any device: a dozen torch
    ops a group, each group in a span ``adam.<group>``."""
    n = state.count + 1
    c1 = 1.0 - B1 ** n
    c2 = 1.0 - B2 ** n
    new_p, new_mu, new_nu = {}, {}, {}
    for k in PARAM_KEYS:
        with span("adam." + k):
            g = grads[k]
            mu = B1 * state.mu[k] + (1 - B1) * g
            nu = B2 * state.nu[k] + (1 - B2) * g * g
            update = (mu / c1) / (torch.sqrt(nu / c2) + EPS)
            new_p[k] = params[k] - lrs[k] * update
            new_mu[k], new_nu[k] = mu, nu
    return new_p, AdamState(mu=new_mu, nu=new_nu, count=n)


def _rows(name: str, t: torch.Tensor) -> tuple[int, int]:
    """(row length, row stride), in elements, of ``t`` read as rows over
    its first dimension: (numel, numel) where it is contiguous; else its
    rows must each be contiguous and apart by at least their length, as
    f_dc and f_rest are column ranges of one [P, 16, C] tensor in a model
    from ``create_from_pcd`` and in the gradient of the cat that joins
    them. Raises on any other layout."""
    n = t.numel()
    if t.is_contiguous():
        return max(n, 1), max(n, 1)
    row = n // t.shape[0]
    if not t[0].is_contiguous() or t.stride(0) < row:
        raise ValueError(f"{name} is neither contiguous nor contiguous "
                         f"rows: shape {tuple(t.shape)}, strides "
                         f"{t.stride()}")
    return row, t.stride(0)


def _check_groups(params: Params, grads: Params, state: AdamState):
    """Raise unless every group's parameter, gradient and moments are
    float32 of one shape on one device; returns each group's four
    ``_rows`` layouts, which raises on any other."""
    dev = params[PARAM_KEYS[0]].device
    layouts = []
    for k in PARAM_KEYS:
        shape = params[k].shape
        for what, t in (("parameter", params[k]), ("gradient", grads[k]),
                        ("mu", state.mu[k]), ("nu", state.nu[k])):
            if t.dtype is not torch.float32:
                raise TypeError(f"the {what} of {k} is {t.dtype}, not "
                                f"float32")
            if t.device != dev:
                raise ValueError(f"the {what} of {k} is on {t.device}, the "
                                 f"parameters on {dev}")
            if t.shape != shape:
                raise ValueError(f"the {what} of {k} is {tuple(t.shape)}, "
                                 f"the parameter {tuple(shape)}")
            layouts += _rows(f"the {what} of {k}", t)
    return layouts


@span("adam.kernel")
def _adam_step_kernel(params: Params, grads: Params, state: AdamState,
                      lrs: Dict[str, float]) -> tuple[Params, AdamState]:
    """``adam_step`` as one launch of the kernel of csrc/adam.cu over every
    group of CUDA tensors, which ``_check_groups`` checks first, in a span
    ``adam.kernel`` (a profiler links the launch, which no torch op
    makes, to it). The constants are the float32s the plain version's ops
    make of its host scalars (each ``c_float`` argument rounds its double
    to the nearest float32, as torch does)."""
    layouts = _check_groups(params, grads, state)
    dev = params[PARAM_KEYS[0]].device
    n = state.count + 1
    c1 = 1.0 - B1 ** n
    c2 = 1.0 - B2 ** n
    ptrs = (ctypes.c_void_p * (7 * len(PARAM_KEYS)))()
    sizes = (ctypes.c_longlong * (9 * len(PARAM_KEYS)))()
    rates = (ctypes.c_float * len(PARAM_KEYS))()
    new_p, new_mu, new_nu = {}, {}, {}
    for i, k in enumerate(PARAM_KEYS):
        p = params[k]
        new_p[k], new_mu[k], new_nu[k] = outs = [
            torch.empty(p.shape, dtype=torch.float32, device=dev)
            for _ in range(3)]
        ptrs[7 * i:7 * i + 7] = [t.data_ptr() for t in (
            p, grads[k], state.mu[k], state.nu[k], *outs)]
        sizes[9 * i:9 * i + 9] = [p.numel(), *layouts[8 * i:8 * i + 8]]
        rates[i] = float(lrs[k])
    if any(p.numel() for p in params.values()):
        # torch multiplies a CUDA tensor divided by a host scalar c by
        # 1 / c taken in double and rounded to float32
        launch("gslidar_adam", dev, len(PARAM_KEYS), ptrs, sizes, rates,
               B1, 1 - B1, B2, 1 - B2, 1.0 / c1, 1.0 / c2, EPS)
        count("launches.adam")
    return new_p, AdamState(mu=new_mu, nu=new_nu, count=n)


def zero_moments_at(state: AdamState, row_mask: torch.Tensor,
                    keys=None) -> AdamState:
    """Zero the moments of the masked rows (gslidar_tpu's zero_moments_at;
    the optimizer surgery of reset_opacity, gaussian_model.py:328-341)."""
    keys = keys or PARAM_KEYS
    mu, nu = dict(state.mu), dict(state.nu)
    for k in keys:
        m = row_mask.reshape((-1,) + (1,) * (mu[k].dim() - 1))
        mu[k] = torch.where(m, 0.0, mu[k])
        nu[k] = torch.where(m, 0.0, nu[k])
    return AdamState(mu=mu, nu=nu, count=state.count)


def cut_and_append_moments(state: AdamState, rows: torch.Tensor,
                           n_new: int = 0) -> AdamState:
    """The moments of the exact-size layout's densify: keep ``rows`` (an
    index or a bool mask over the old rows, in order) and append ``n_new``
    zero rows for the new gaussians (the reference's cat of zero exp_avg /
    exp_avg_sq and its prune, gaussian_model.py:343-412). The step count
    stays as it is."""
    def cut(d):
        out = {}
        for k, v in d.items():
            kept = v[rows]
            out[k] = (torch.cat([kept, kept.new_zeros((n_new,) + v.shape[1:])])
                      if n_new else kept)
        return out
    return AdamState(mu=cut(state.mu), nu=cut(state.nu), count=state.count)
