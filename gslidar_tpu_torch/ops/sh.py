"""Real spherical harmonics for 4-channel (RGB + raydrop) features
(port of gslidar_tpu/ops/sh.py; reference forward.cu:17-69 and its
backward, backward.cu:22-147).

The active degree leaves the bands above it out of the sum (the JAX
package multiplies them by 0), so one code path serves every degree of
the training ramp. The sum runs over the coefficients in order, as the
preprocess kernel (csrc/preprocess.cu) sums them.
"""

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


def _basis_jacobian(dirs: torch.Tensor) -> list:
    """d basis_k / d(x, y, z) of [P, 3] directions for k = 1..15, each
    [P, 3] (basis_0 is constant)."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    zero = torch.zeros_like(x)
    c1 = SH_C1 * torch.ones_like(x)
    rows = [
        (zero, -c1, zero), (zero, zero, c1), (-c1, zero, zero),
        (SH_C2[0] * y, SH_C2[0] * x, zero),
        (zero, SH_C2[1] * z, SH_C2[1] * y),
        (-2.0 * SH_C2[2] * x, -2.0 * SH_C2[2] * y, 4.0 * SH_C2[2] * z),
        (SH_C2[3] * z, zero, SH_C2[3] * x),
        (2.0 * SH_C2[4] * x, -2.0 * SH_C2[4] * y, zero),
        (6.0 * SH_C3[0] * xy, SH_C3[0] * (3.0 * xx - 3.0 * yy), zero),
        (SH_C3[1] * yz, SH_C3[1] * xz, SH_C3[1] * xy),
        (-2.0 * SH_C3[2] * xy, SH_C3[2] * (4.0 * zz - xx - 3.0 * yy),
         8.0 * SH_C3[2] * yz),
        (-6.0 * SH_C3[3] * xz, -6.0 * SH_C3[3] * yz,
         SH_C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy)),
        (SH_C3[4] * (4.0 * zz - 3.0 * xx - yy), -2.0 * SH_C3[4] * xy,
         8.0 * SH_C3[4] * xz),
        (2.0 * SH_C3[5] * xz, -2.0 * SH_C3[5] * yz, SH_C3[5] * (xx - yy)),
        (SH_C3[6] * (3.0 * xx - 3.0 * yy), -6.0 * SH_C3[6] * xy, zero),
    ]
    return [torch.stack(r, -1) for r in rows]


def sh_basis(dirs: torch.Tensor) -> torch.Tensor:
    """[..., 3] unit directions -> [..., 16] basis values (degree 0..3)."""
    return torch.stack(_basis_terms(dirs), dim=-1)


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


def eval_sh_backward(degree: int, sh_coeffs: torch.Tensor,
                     dirs: torch.Tensor, clamped: torch.Tensor,
                     dcolor: torch.Tensor):
    """The gradient of ``eval_sh`` (clamp on), written out: (d sh_coeffs
    [P, K, C], d dirs [P, 3]) from the values' cotangent ``dcolor`` [P, C]
    and the forward's ``clamped`` mask, where the clamp stops it. The
    bands above ``degree`` get none."""
    n = active_coeffs(degree, sh_coeffs.shape[-2])
    dv = torch.where(clamped, 0.0, dcolor)
    basis = _basis_terms(dirs)
    dshs = torch.zeros_like(sh_coeffs)
    for k in range(n):
        dshs[:, k] = basis[k][:, None] * dv
    ddirs = torch.zeros_like(dirs)
    for k, jac in enumerate(_basis_jacobian(dirs)[:max(n - 1, 0)], 1):
        ddirs = ddirs + torch.sum(sh_coeffs[:, k] * dv, -1)[:, None] * jac
    return dshs, ddirs


def rgb2sh(rgb):
    return (rgb - 0.5) / SH_C0
