"""Dense (untiled) oracle renderer, a test fixture (port of
gslidar_tpu/raster/oracle.py).

Every gaussian is evaluated on every pixel with the compositor's math,
in depth order, with no binning: the reference's pure-torch sanity
renderer (scripts/compare_2dgs_3dgs.py:152-263) extended to the training
features. With ``respect_tile_rect`` each pixel's candidates are masked
by the tile-rect rule binning applies and the order is binning's
quantized depth with gaussian-index ties, so on any scene the tiled
renderer must agree with it to float tolerance.

It is differentiable, and so the untiled gradient reference of the
compositors: every accumulator is built out of place, and as in the
kernels the S feature channels take their weights detached (they carry
no gradient into alpha) while the 3 normal channels do not. It runs in
the inputs' float dtype, float64 included. The loop is over gaussians in
Python and autograd keeps a few dozen pixel-sized tensors for each, so
its memory grows as P x H x W: it is sized for small scenes (2,048
gaussians on a 66x515 view take ~12 GiB and ~20 s on an H100).
"""

from __future__ import annotations

import torch

from gslidar_tpu_torch.raster.preprocess import preprocess_reference
from gslidar_tpu_torch.raster.settings import (ALPHA_EPS, FAR_N,
                                               FILTER_INV_SQUARE, MAX_ALPHA,
                                               NEAR_N, RasterSettings,
                                               T_STOP)


def rasterize_dense(means3D, scales, rotations, opacity, shs, features,
                    mask, viewmat, campos, bg, sh_degree, scale_factor,
                    settings: RasterSettings, colors_precomp=None,
                    respect_tile_rect=True):
    """Render by walking all P gaussians over all H*W pixels: a dict of
    color [C, H, W], feature [S + 3, H, W], depth [4, H, W], alpha and
    final_T [1, H, W], and radii [P]."""
    prep = preprocess_reference(means3D, scales, rotations, opacity, shs,
                                mask, viewmat, campos, sh_degree,
                                scale_factor, settings, 1.0, colors_precomp)
    H, W = settings.height, settings.width
    VFOV_min, VFOV_max, HFOV_min, HFOV_max = settings.angle_bounds
    near, far = NEAR_N * scale_factor, FAR_N * scale_factor
    dev = means3D.device
    dt = prep.T.dtype
    big = torch.iinfo(torch.int64).max
    if respect_tile_rect:
        # binning's quantized depth order; equal buckets keep gaussian
        # order (a stable sort)
        dq_max = (1 << settings.depth_bits) - 1
        dnorm = torch.clamp((prep.depth - near) / max(far - near, 1e-12),
                            0.0, 1.0)
        dq = torch.clamp_max((dnorm * float(dq_max)).to(torch.int32),
                             dq_max).to(torch.int64)
        order = torch.argsort(torch.where(prep.valid, dq, big), stable=True)
    else:
        order = torch.argsort(torch.where(prep.valid, prep.depth,
                                          float("inf")), stable=True)
    T = prep.T[order]
    xy = prep.xy[order]
    r_center = prep.depth[order]
    col = prep.color[order]
    nrm = prep.normal[order]
    opa = opacity[order]
    fea = features[order]
    valid = prep.valid[order]
    rect_min = prep.rect_min[order]
    rect_max = prep.rect_max[order]

    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    px, py = xx.reshape(-1), yy.reshape(-1)
    phi = px * (HFOV_max - HFOV_min) / W + HFOV_min
    theta = py * (VFOV_max - VFOV_min) / H + VFOV_min
    # float32 angles, as the kernels take them, then the inputs' dtype
    sp, cp = torch.sin(phi).to(dt), torch.cos(phi).to(dt)
    st, ct = torch.sin(theta).to(dt), torch.cos(theta).to(dt)
    tile_x = torch.div(px, settings.tile_w, rounding_mode="floor").long()
    tile_y = torch.div(py, settings.tile_h, rounding_mode="floor").long()
    px, py = px.to(dt), py.to(dt)
    Tcols = T.transpose(1, 2)      # [P, col(x, y, z), row(u, v, p)]

    npix = H * W
    C, S = col.shape[-1], fea.shape[-1]
    z = torch.zeros(npix, dtype=dt, device=dev)
    T_run = torch.ones(npix, dtype=dt, device=dev)
    C_acc = torch.zeros(C, npix, dtype=dt, device=dev)
    F_acc = torch.zeros(S + 3, npix, dtype=dt, device=dev)
    D = D2 = dist = M1 = M2 = med_d = med_pos = ncon = z
    for g in range(means3D.shape[0]):
        Tu, Tv, Tw = Tcols[g, 0], Tcols[g, 1], Tcols[g, 2]
        kx = cp * Tu[0] - sp * Tw[0]
        ky = cp * Tu[1] - sp * Tw[1]
        kz = cp * Tu[2] - sp * Tw[2]
        lx = sp * ct * Tu[0] + st * Tv[0] + cp * ct * Tw[0]
        ly = sp * ct * Tu[1] + st * Tv[1] + cp * ct * Tw[1]
        lz = sp * ct * Tu[2] + st * Tv[2] + cp * ct * Tw[2]
        p1 = ky * lz - kz * ly
        p2 = kz * lx - kx * lz
        p3 = kx * ly - ky * lx
        ok3 = p3 != 0
        p3s = torch.where(ok3, p3, 1.0)
        s1, s2 = p1 / p3s, p2 / p3s
        rho3d = s1 * s1 + s2 * s2
        dx = xy[g, 0] - px
        if settings.wrap_x:
            # the 2D pixel distance wraps at the phi seam
            dx = torch.remainder(dx + W / 2.0, float(W)) - W / 2.0
        dy = xy[g, 1] - py
        rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
        use3d = rho3d <= rho2d
        rho = torch.minimum(rho3d, rho2d)
        sTu = s1 * Tu[0] + s2 * Tu[1] + Tu[2]
        sTv = s1 * Tv[0] + s2 * Tv[1] + Tv[2]
        sTw = s1 * Tw[0] + s2 * Tw[1] + Tw[2]
        depth3d = sTu * st * sp - sTv * ct + sTw * st * cp
        depth = torch.where(use3d, depth3d, r_center[g])
        alpha = torch.clamp_max(opa[g] * torch.exp(-0.5 * rho), MAX_ALPHA)
        ok = (valid[g] & ok3 & (depth >= near) & (depth <= far)
              & (alpha >= ALPHA_EPS))
        if respect_tile_rect:
            if settings.wrap_x:
                # the circular rect covers the modular run rect_min_x ..
                # rect_min_x + width - 1
                wt = rect_max[g, 0] - rect_min[g, 0]
                in_x = torch.remainder(tile_x - rect_min[g, 0],
                                       settings.tiles_x) < wt
            else:
                in_x = (tile_x >= rect_min[g, 0]) & (tile_x < rect_max[g, 0])
            ok = ok & in_x & (tile_y >= rect_min[g, 1]) & \
                (tile_y < rect_max[g, 1])
        a = torch.where(ok, alpha, 0.0)
        depth = torch.where(ok, depth, far)

        accept = ok & (T_run * (1 - a) >= T_STOP)
        w = torch.where(accept, a * T_run, 0.0)
        C_acc = C_acc + w[None, :] * col[g][:, None]
        # the S features' weights are detached: they do not backprop
        # into alpha (JAX's w_mix); the normals' weights are not
        F_acc = F_acc + torch.cat([w.detach()[None, :] * fea[g][:, None],
                                   w[None, :] * nrm[g][:, None]])
        D = D + depth * w
        D2 = D2 + depth * depth * w
        m = far / (far - near) * (1 - near / depth)
        dist = dist + (m * m * (1 - T_run) + M2 - 2 * m * M1) * w
        M1 = M1 + m * w
        M2 = M2 + m * m * w
        med = accept & (T_run > 0.5)
        med_d = torch.where(med, depth, med_d)
        med_pos = torch.where(med, float(g + 1), med_pos)
        ncon = torch.where(accept, float(g + 1), ncon)
        # T decays for every passing instance, contributions or not
        T_run = T_run * (1 - a)

    return {
        "color": (C_acc + T_run[None] * bg[:, None]).reshape(C, H, W),
        "feature": F_acc.reshape(S + 3, H, W),
        "depth": torch.stack([D, med_d, dist, D2]).reshape(4, H, W),
        "alpha": (1 - T_run).reshape(1, H, W),
        "final_T": T_run.reshape(1, H, W),
        "radii": prep.radius,
    }
