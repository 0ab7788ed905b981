"""Real spherical harmonics of 4-channel features.

A frozen copy of the port's plain PyTorch version (ops/sh.py), held here
so that a change to the program cannot move the reference it is judged
by. It imports nothing of the program."""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814


SH_C1 = 0.4886025119029199


SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)


SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


# band index (degree) of each of the 16 coefficients
_BAND = (0,) + (1,) * 3 + (2,) * 5 + (3,) * 7


def _basis_terms(dirs: torch.Tensor) -> list:
    """The 16 basis values of [..., 3] unit directions, each [...]."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    one = torch.ones_like(x)
    return [
        SH_C0 * one,
        -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2.0 * zz - xx - yy),
        SH_C2[3] * xz, SH_C2[4] * (xx - yy),
        SH_C3[0] * y * (3.0 * xx - yy), SH_C3[1] * xy * z,
        SH_C3[2] * y * (4.0 * zz - xx - yy),
        SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
        SH_C3[4] * x * (4.0 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
        SH_C3[6] * x * (xx - 3.0 * yy),
    ]


def active_coeffs(degree: int, K: int) -> int:
    """How many of the first K coefficients lie in bands <= degree."""
    return sum(1 for b in _BAND[:K] if b <= int(degree))


def eval_sh(degree: int, sh_coeffs: torch.Tensor, dirs: torch.Tensor,
            clamp: bool = True):
    """SH -> per-channel value (+ 0.5, clamped at 0): ((b_0 c_0 + b_1 c_1)
    + ...) + 0.5 over the active coefficients.

    Args:
        degree: active SH degree.
        sh_coeffs: [P, K, C] coefficients, K <= 16.
        dirs: [P, 3] unit directions (gaussian center - camera center).
    Returns:
        (values [P, C], clamped mask [P, C]).
    """
    n = active_coeffs(degree, sh_coeffs.shape[-2])
    basis = _basis_terms(dirs)
    vals = basis[0][:, None] * sh_coeffs[:, 0]
    for k in range(1, n):
        vals = vals + basis[k][:, None] * sh_coeffs[:, k]
    vals = vals + 0.5
    clamped = vals < 0
    if clamp:
        vals = torch.clamp_min(vals, 0.0)
    return vals, clamped

