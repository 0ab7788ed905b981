"""Backward compositing: the CUDA kernel's wrapper and its plain PyTorch
version (port of gslidar_tpu/raster/pallas_bwd.py::_bwd_kernel).

Both take what the forward took and gave — the sorted payload rows [N, D]
(D = 10 + C + S), the tile range table and the forward's ``CompositeOut``
— and the cotangents of its differentiable outputs: gC [C, H, W] (color),
gF [S + 3, H, W] (features, then the normal), gD4 [4, H, W] (mean depth,
median depth, distortion, sum w d^2) and gT [1, H, W] (final T). They
return the per-instance gradient table [N, D]: dL/d(9 T columns, opacity,
C colors, S features) of each sorted row. Rows the forward never walked
get zeros.

The walk is the forward's: each tile's instances in order, for the count
the forward walked (misc slot 5), with the forward's intersection, so that
every transmittance, ``ok`` and ``accept`` decision is the forward's.
Every back-to-front suffix sum is a total minus an inclusive prefix
(pallas_bwd.py:219-263): with cotangents constant per pixel they collapse
into one prefix P of w*q against qtot, built from the forward's totals.
The kernel walks each staging batch of each tile (a chunk) on its own,
started from the forward's checkpoint of that batch
(``composite_fwd.Checkpoints``): T as the forward had it, and P formed
from the checkpoint's running sums and the pixel's cotangents.
Each instance's row is a sum over its tile's pixels of 26 terms — the
bilinear basis of the T gradient (the linear ray-splat form), the
low-pass centre terms, the depth, opacity and channel terms — which are
then chained per instance into the T columns (cross products, the
spherical Jacobian of the centre, the normal's normalize(u x v)).

Gradient semantics, those of jax.grad through gslidar_tpu's XLA
compositor: the 0.99 alpha clamp stops gradients, the S features do not
feed back into alpha, the final-T cotangent reaches every ``ok`` instance
walked (accepted or under the 1e-4 floor) through its opacity and its
geometry, and the median depth cotangent reaches the median instance.

``composite_backward`` is the wrapper: CPU tensors go to the plain
version, CUDA tensors to the kernel in ``csrc/composite_bwd.cu``, anything
else raises. ``composite_backward_reference`` is the plain version; it
walks the same per-tile batches as ``composite_forward_reference``,
vectorized over tiles x instances x pixels, each batch started from its
checkpoint as the kernel does, or, without checkpoints, carried over from
the batch before.
"""

from __future__ import annotations

import torch

from gslidar_tpu_torch.raster.composite_fwd import (Checkpoints,
                                                    CompositeOut,
                                                    _check_checkpoints,
                                                    _check_inputs,
                                                    intersect, max_chunks,
                                                    stage_instances,
                                                    tile_grid)
from gslidar_tpu_torch.raster.settings import (FILTER_INV_SQUARE, MAX_ALPHA,
                                               RasterSettings, T_STOP)
from gslidar_tpu_torch.utils.trace import count, span

MAX_BLEND_BWD = 14   # C + S the kernel reduces (csrc MAX_BLEND_BWD)


def _tile(x: torch.Tensor, settings: RasterSettings) -> torch.Tensor:
    """[ch, H, W] -> [n_tiles, ch, pix], zero in the tile padding (the
    inverse of composite_fwd._untile)."""
    ch = x.shape[0]
    th, tw = settings.tile_h, settings.tile_w
    gy, gx = settings.tiles_y, settings.tiles_x
    pad = x.new_zeros(ch, gy * th, gx * tw)
    pad[:, :settings.height, :settings.width] = x
    return (pad.reshape(ch, gy, th, gx, tw).permute(1, 3, 0, 2, 4)
            .reshape(gy * gx, ch, th * tw))


def walked_per_tile(fwd: CompositeOut, settings: RasterSettings):
    """[n_tiles] int32: instances each tile's forward walked (misc slot 5,
    read at the tile's first pixel)."""
    return (fwd.misc[5, ::settings.tile_h, ::settings.tile_w]
            .reshape(-1).to(torch.int32).contiguous())


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def composite_backward_reference(rows, tile_starts, fwd: CompositeOut, cts,
                                 params, settings: RasterSettings, C: int,
                                 S: int, ckpt: Checkpoints | None = None
                                 ) -> torch.Tensor:
    """Plain PyTorch version of the backward compositing kernel. With
    ``ckpt`` each batch starts from its checkpoint, as the kernel's chunks
    do; without, from the batch before."""
    gC, gF, gD4, gT = cts
    dev = rows.device
    f32 = torch.float32
    B = settings.tile_pixels
    n_tiles = settings.num_tiles
    N, D = rows.shape
    NB = C + S
    g = tile_grid(params, settings, dev)
    near, far = g.near, g.far
    m_scale = far / (far - near)
    k = torch.arange(B, device=dev)
    kx = g.fW / (g.hmax - g.hmin)
    ky = g.fH / (g.vmax - g.vmin)

    # per-pixel cotangents and forward totals, [n_tiles, ch, pix]
    tgC, tgF, tgD = _tile(gC, settings), _tile(gF, settings), \
        _tile(gD4, settings)
    tgT = _tile(gT, settings)[:, 0]
    col_t = _tile(fwd.color, settings)
    nrm_t = _tile(fwd.feature[S:S + 3], settings)
    dep_t = _tile(fwd.depth, settings)
    misc_t = _tile(fwd.misc, settings)
    T_fin, med_pos = misc_t[:, 0], misc_t[:, 2]
    M1t, M2t, Wt = misc_t[:, 3], misc_t[:, 4], misc_t[:, 6]
    A_fin = 1.0 - T_fin
    gD, gMed, gDist, gD2 = tgD[:, 0], tgD[:, 1], tgD[:, 2], tgD[:, 3]
    gN = tgF[:, S:S + 3]
    gch = torch.cat([tgC, tgF], dim=1)                  # [t, C + S + 3, pix]
    qtot = torch.zeros_like(T_fin)
    for c in range(C):
        qtot = qtot + tgC[:, c] * col_t[:, c]
    for c in range(3):
        qtot = qtot + gN[:, c] * nrm_t[:, c]
    qtot = qtot + gD * dep_t[:, 0]
    qtot = qtot + gD2 * dep_t[:, 3]
    if settings.compute_distortion:
        qtot = qtot + gDist * (M2t * Wt + A_fin * M2t - 2.0 * M1t * M1t)

    grad = torch.zeros(N, D, dtype=f32, device=dev)
    starts = tile_starts[:-1].to(torch.int64)
    walked = walked_per_tile(fwd, settings).to(torch.int64)
    T_run = g.inside.to(f32)
    P_run = torch.zeros(n_tiles, B, dtype=f32, device=dev)
    n_batches = -(-int(walked.max()) // B) if n_tiles else 0

    for c in range(n_batches):
        idx = torch.nonzero(walked > c * B)[:, 0]
        if ckpt is not None:
            st = ckpt.state[ckpt.chunk_off[idx].to(torch.int64) + c]
            T_run[idx] = st[:, 0]
            P0 = torch.zeros_like(st[:, 0])
            for ch in range(C):
                P0 = P0 + tgC[idx, ch] * st[:, 1 + ch]
            for ch in range(3):
                P0 = P0 + gN[idx, ch] * st[:, 1 + C + ch]
            P0 = P0 + gD[idx] * st[:, 4 + C]
            P0 = P0 + gD2[idx] * st[:, 5 + C]
            if settings.compute_distortion:
                P0 = P0 + gDist[idx] * (M2t[idx] * st[:, 6 + C]
                                        + A_fin[idx] * st[:, 8 + C]
                                        - 2.0 * M1t[idx] * st[:, 7 + C])
            P_run[idx] = P0
        pos = starts[idx, None] + c * B + k[None, :]             # [t, B]
        in_rng = pos < (starts + walked)[idx, None]
        d_ = rows[torch.clamp(pos, max=max(N - 1, 0))]
        inst = stage_instances(d_, g, g.tcx[idx, None], C, S)
        h = intersect(inst, g, idx, in_rng)
        ok = h.ok & g.inside[idx, None, :]
        a = torch.where(ok, h.alpha, 0.0)
        d = torch.where(ok, h.depth, far)

        def px_(v):                       # per-pixel [t, pix] -> [t, 1, pix]
            return v[idx][:, None, :]

        u = 1.0 - a
        incl = torch.cumprod(u, dim=1)
        excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)
        T_before = T_run[idx, None, :] * excl
        accept = ok & (T_before * u >= T_STOP)
        w = torch.where(accept, a * T_before, 0.0)

        blend = inst.blend[..., :, None]                         # [t,B,NB,1]
        nrm = inst.nrm[..., :, None]
        q = torch.zeros_like(w)
        for ch in range(C):
            q = q + px_(tgC[:, ch]) * blend[:, :, ch]
        for ch in range(3):
            q = q + px_(gN[:, ch]) * nrm[:, :, ch]
        q = q + px_(gD) * d
        q = q + px_(gD2) * (d * d)
        if settings.compute_distortion:
            m = m_scale * (1.0 - near / d)
            q = q + px_(gDist) * (px_(M2t) + m * m * px_(A_fin)
                                  - 2.0 * m * px_(M1t))
        P = P_run[idx, None, :] + torch.cumsum(w * q, dim=1)
        dL_da = torch.where(accept, T_before * q - (px_(qtot) - P) / u, 0.0)
        dL_dd = w * (px_(gD) + 2.0 * d * px_(gD2))
        pos1 = (pos - starts[idx, None] + 1).to(f32)[:, :, None]
        dL_dd = dL_dd + torch.where(accept & (pos1 == px_(med_pos)),
                                    px_(gMed), 0.0)
        if settings.compute_distortion:
            dmd_dd = (far * near) / ((far - near) * d * d)
            dL_dd = dL_dd + (2.0 * w * (m * px_(A_fin) - px_(M1t))
                             * px_(gDist) * dmd_dd)
        dL_da = dL_da - px_(tgT) * torch.where(ok, px_(T_fin) / u, 0.0)
        clamp_ok = ok & (h.a_raw < MAX_ALPHA)
        dL_dG = torch.where(clamp_ok, inst.opa[:, :, None] * dL_da, 0.0)
        dL_dopa = torch.where(clamp_ok, h.G * dL_da, 0.0)
        dL_drho = -0.5 * h.G * dL_dG

        # branch values masked as values (rejected lanes may hold inf/NaN)
        u3 = ok & h.use3d
        u2 = ok & ~h.use3d
        s1 = torch.where(u3, h.s1, 0.0)
        s2 = torch.where(u3, h.s2, 0.0)
        rp3 = torch.where(u3, h.rp3, 0.0)
        dr3 = torch.where(u3, dL_drho, 0.0)
        dd3 = torch.where(u3, dL_dd, 0.0)
        dL_ds1 = dr3 * 2.0 * s1
        dL_ds2 = dr3 * 2.0 * s2
        dp = (dL_ds1 * rp3, dL_ds2 * rp3,
              -(dL_ds1 * s1 + dL_ds2 * s2) * rp3
              - dd3 * torch.where(u3, h.depth, 0.0) * rp3)
        drho2 = torch.where(u2, dL_drho, 0.0)

        def red(x):                       # sum over the tile's pixels
            return x.sum(dim=2)

        ca, ct, cg = (v[idx][:, None, :] for v in (g.ca, g.ct, g.cg))
        gA = tuple(red(ca * x) for x in dp)
        gB = tuple(red(ct * x) for x in dp)
        gG = tuple(red(cg * x) for x in dp)
        CcI = red(drho2)
        CcX = red(drho2 * g.fpx[idx][:, None, :])
        CcY = red(drho2 * g.fpy[idx][:, None, :])
        gri = red(torch.where(u2, dL_dd, 0.0))
        dnpc = red(dd3 * rp3)
        g_opa = red(dL_dopa)
        Wg = torch.einsum("tkp,tcp->tkc", w, gch[idx])           # [t,B,NB+3]

        # ---- per instance: chain the reduced terms into the row ---------
        Tux, Tuy, Tuz, Tvx, Tvy, Tvz, Twx, Twy, Twz = inst.T
        Tu, Tv, Tw = (Tux, Tuy, Tuz), (Tvx, Tvy, Tvz), (Twx, Twy, Twz)
        a1, a2 = _cross(Tv, gA), _cross(Tw, gB)
        b1, b2 = _cross(gA, Tu), _cross(Tw, gG)
        c1_, c2_ = _cross(gB, Tu), _cross(Tv, gG)

        gxi = 2.0 * FILTER_INV_SQUARE * (inst.cx * CcI - CcX)
        gyi = 2.0 * FILTER_INV_SQUARE * (inst.cy * CcI - CcY)
        u_p, v_p, w_p = Tuz, Tvz, Twz
        degen = (u_p * u_p + w_p * w_p) < 1e-20
        u_s = torch.where(degen, 0.0, u_p)
        w_s = torch.where(degen, 1.0, w_p)
        ruw2 = u_s * u_s + w_s * w_s
        ruw = torch.sqrt(ruw2)
        r2q = ruw2 + v_p * v_p
        inv_ruw2 = 1.0 / ruw2
        inv_rq = 1.0 / (ruw * r2q)
        inv_r = 1.0 / torch.sqrt(u_p * u_p + v_p * v_p + w_p * w_p + 1e-24)
        gU = (gxi * (kx * w_s * inv_ruw2) - gyi * (ky * u_s * v_p * inv_rq)
              + gri * (u_p * inv_r))
        gV = gyi * (ky * ruw / r2q) + gri * (v_p * inv_r)
        gW = (-gxi * (kx * u_s * inv_ruw2) - gyi * (ky * v_p * w_s * inv_rq)
              + gri * (w_p * inv_r))

        c1, c2, c3 = inst.c
        u_cam, v_cam, p_cam = (Tux, Tvx, Twx), (Tuy, Tvy, Twy), (u_p, v_p, w_p)
        vxp, pxu = _cross(v_cam, p_cam), _cross(p_cam, u_cam)
        n = (c1 * inst.si, c2 * inst.si, c3 * inst.si)
        gNr = (Wg[..., NB], Wg[..., NB + 1], Wg[..., NB + 2])
        gdot = n[0] * gNr[0] + n[1] * gNr[1] + n[2] * gNr[2]
        hh = tuple(inst.si * (gNr[i] - n[i] * gdot) for i in range(3))
        gu, gv = _cross(v_cam, hh), _cross(hh, u_cam)

        cols = [(a1[0] + a2[0]) + gu[0] + dnpc * vxp[0],
                (a1[1] + a2[1]) + gv[0] + dnpc * pxu[0],
                (a1[2] + a2[2]) + gU + dnpc * c1,
                (b1[0] - b2[0]) + gu[1] + dnpc * vxp[1],
                (b1[1] - b2[1]) + gv[1] + dnpc * pxu[1],
                (b1[2] - b2[2]) + gV + dnpc * c2,
                (c1_[0] + c2_[0]) + gu[2] + dnpc * vxp[2],
                (c1_[1] + c2_[1]) + gv[2] + dnpc * pxu[2],
                (c1_[2] + c2_[2]) + gW + dnpc * c3,
                g_opa]
        table = torch.cat([torch.stack(cols, dim=-1), Wg[..., :NB]], dim=-1)
        grad[pos[in_rng]] = table[in_rng]

        T_run[idx] = T_run[idx] * incl[:, -1]
        P_run[idx] = P[:, -1]
    return grad


def _check_cts(cts, fwd: CompositeOut, settings: RasterSettings, C, S, dev):
    H, W = settings.height, settings.width
    want = ((C, H, W), (S + 3, H, W), (4, H, W), (1, H, W))
    for name, x, shape in zip(("gC", "gF", "gD4", "gT"), cts, want):
        if x.dtype != torch.float32 or tuple(x.shape) != shape or \
                x.device != dev or not x.is_contiguous():
            raise ValueError(f"cotangent {name} must be a contiguous float32 "
                             f"{shape} tensor on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    for name, x, ch in zip(CompositeOut._fields, fwd, (C, S + 3, 4, 8)):
        if x.dtype != torch.float32 or tuple(x.shape) != (ch, H, W) or \
                x.device != dev or not x.is_contiguous():
            raise ValueError(f"forward output {name} must be a contiguous "
                             f"float32 {(ch, H, W)} tensor on {dev}")
    if C + S > MAX_BLEND_BWD:
        raise ValueError(f"C + S = {C + S} exceeds the backward kernel's "
                         f"{MAX_BLEND_BWD}")
    pix = settings.tile_pixels
    if pix % 32 or (pix > 256 and pix not in (512, 1024)):
        raise ValueError(f"the backward kernel takes tiles of a multiple of "
                         f"32 pixels up to 256, or of 512 or 1024, not "
                         f"{pix}")


@span("composite.bwd")
def composite_backward(rows: torch.Tensor, tile_starts: torch.Tensor,
                       fwd: CompositeOut, cts, params,
                       settings: RasterSettings, C: int, S: int,
                       ckpt: Checkpoints | None = None) -> torch.Tensor:
    """Per-instance gradient table [N, D] of the forward composite.

    ``cts`` is (gC, gF, gD4, gT); ``ckpt`` the checkpoints the forward
    wrote (``composite_forward(..., ckpt=new_checkpoints(...))``), which
    the kernel needs. CPU tensors run the plain version; CUDA tensors
    launch the kernel on the current stream (the counter
    ``launches.composite_bwd`` counts those launches); any other device
    raises.
    """
    _check_inputs(rows, tile_starts, settings, C, S)
    _check_cts(cts, fwd, settings, C, S, rows.device)
    if ckpt is not None:
        _check_checkpoints(ckpt, rows, settings, C)
    if rows.device.type == "cpu":
        return composite_backward_reference(rows, tile_starts, fwd, cts,
                                            params, settings, C, S, ckpt)
    if rows.device.type != "cuda":
        raise ValueError(f"composite_backward runs on cpu or cuda tensors, "
                         f"not {rows.device}")
    if ckpt is None:
        raise ValueError("the backward kernel starts every chunk from the "
                         "forward's checkpoints: pass the Checkpoints that "
                         "composite_forward filled")
    from gslidar_tpu_torch.kernels import load_library
    lib = load_library()
    grad = torch.zeros_like(rows)       # rows no chunk reaches stay zero
    # one CTA per possible (tile, staging batch), sized on the host with no
    # sync; those past the batches the forward walked return at once
    walked = walked_per_tile(fwd, settings)
    gC, gF, gD4, gT = cts
    dev = rows.device.index if rows.device.index is not None \
        else torch.cuda.current_device()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gslidar_composite_bwd(
            dev, rows.data_ptr(), rows.shape[1], tile_starts.data_ptr(),
            walked.data_ptr(), ckpt.chunk_off.data_ptr(),
            ckpt.state.data_ptr(), max_chunks(rows.shape[0], settings),
            settings.num_tiles, settings.tiles_x, settings.tile_h,
            settings.tile_w, settings.height, settings.width, C, S, *params,
            int(settings.compute_distortion), gC.data_ptr(), gF.data_ptr(),
            gD4.data_ptr(), gT.data_ptr(), fwd.color.data_ptr(),
            fwd.feature.data_ptr(), fwd.depth.data_ptr(),
            fwd.misc.data_ptr(), grad.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"composite_bwd kernel launch failed: CUDA error "
                           f"{err}")
    count("launches.composite_bwd")
    return grad
