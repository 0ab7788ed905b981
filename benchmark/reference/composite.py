"""Forward and backward compositing of sorted instance rows.

A frozen copy of the port's plain PyTorch version
(raster/composite_fwd.py, raster/composite_bwd.py), held here so that a
change to the program cannot move the reference it is judged by. It
imports nothing of the program."""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.geometry import (ALPHA_EPS, FAR_N, FILTER_INV_SQUARE,
                                          MAX_ALPHA, NEAR_N, RasterSettings,
                                          T_STOP)

PAYLOAD_BASE = 10    # 9 T columns + opacity, then C colors and S features


class CompositeOut(NamedTuple):
    color: torch.Tensor     # [C, H, W] blended channels (no background)
    feature: torch.Tensor   # [S + 3, H, W] extra features, then the normal
    depth: torch.Tensor     # [4, H, W] sum w*d, median d, distortion,
                            # sum w*d^2
    misc: torch.Tensor      # [8, H, W] final T, n_contrib, median position,


class Checkpoints(NamedTuple):
    """Each tile pixel's running state at the start of every staging batch
    the forward reaches (composite_common.cuh), where the backward kernel
    starts its chunks.

    ``state`` [chunks, 9 + C, tile pixels] float32: T, the C color sums,
    the three normal sums, sum w*d, sum w*d^2, sum w, M1, M2 (the S
    features do not feed back into alpha). Tile t's batches follow one
    another from ``chunk_off[t]`` ([n_tiles + 1] int32, the exclusive
    prefix sum of ceil(instances / tile pixels)). Batches the walk never
    reaches are not written."""
    state: torch.Tensor
    chunk_off: torch.Tensor


def pack_payload(prep, opacity, features):
    """[P, 10 + C + S] per-gaussian payload rows (the columns of T are
    component triples, forward.cu:385-387)."""
    Tcols = prep.T.transpose(1, 2).reshape(-1, 9)
    return torch.cat([Tcols, opacity[:, None], prep.color, features], dim=1)


def make_params(scale_factor, settings: RasterSettings, angle_bounds=None):
    """The kernel's 8 scalars: (near, far, VFOV_min, VFOV_max, HFOV_min,
    HFOV_max, wrap period, 1 / wrap period), both 0 without a wrap."""
    vmin, vmax, hmin, hmax = (angle_bounds if angle_bounds is not None
                              else settings.angle_bounds)
    wrap_w = settings.dxp_wrap_period
    wrap_inv = 1.0 / wrap_w if wrap_w else 0.0
    return (NEAR_N * float(scale_factor), FAR_N * float(scale_factor),
            float(vmin), float(vmax), float(hmin), float(hmax),
            float(wrap_w), float(wrap_inv))


def _untile(x: torch.Tensor, settings: RasterSettings) -> torch.Tensor:
    """[n_tiles, ch, pix] -> contiguous [ch, H, W] (cropping the tile
    padding)."""
    ch = x.shape[1]
    x = x.reshape(settings.tiles_y, settings.tiles_x, ch, settings.tile_h,
                  settings.tile_w)
    x = x.permute(2, 0, 3, 1, 4).reshape(
        ch, settings.tiles_y * settings.tile_h,
        settings.tiles_x * settings.tile_w)
    return x[:, :settings.height, :settings.width].contiguous()


class TileGrid(NamedTuple):
    """The kernel's scalars as float32 device scalars, and each tile
    pixel's coordinates and ray, [n_tiles, pix]."""
    near: torch.Tensor
    far: torch.Tensor
    fW: torch.Tensor
    fH: torch.Tensor
    hmin: torch.Tensor
    hmax: torch.Tensor
    vmin: torch.Tensor
    vmax: torch.Tensor
    wrap_w: torch.Tensor
    wrap_inv: torch.Tensor
    inside: torch.Tensor
    fpx: torch.Tensor
    fpy: torch.Tensor
    ca: torch.Tensor
    ct: torch.Tensor
    cg: torch.Tensor
    tcx: torch.Tensor       # [n_tiles] tile centre column


def tile_grid(params, settings: RasterSettings, dev) -> TileGrid:
    f32 = torch.float32

    def scalar(v):
        # device float32 scalars: the kernel's float arithmetic (a CPU
        # scalar divisor would be turned into a reciprocal multiply on CUDA)
        return torch.tensor(v, dtype=f32, device=dev)

    near, far, vmin, vmax, hmin, hmax, wrap_w, wrap_inv = (
        scalar(p) for p in params)
    H, W = settings.height, settings.width
    th, tw, gx = settings.tile_h, settings.tile_w, settings.tiles_x
    fW, fH = scalar(float(W)), scalar(float(H))
    tid = torch.arange(settings.num_tiles, device=dev)
    ty, tx = tid // gx, tid % gx
    k = torch.arange(settings.tile_pixels, device=dev)
    px = tx[:, None] * tw + k[None, :] % tw              # [n_tiles, pix]
    py = ty[:, None] * th + k[None, :] // tw
    fpx, fpy = px.to(f32), py.to(f32)
    phi = fpx * (hmax - hmin) / fW + hmin
    theta = fpy * (vmax - vmin) / fH + vmin
    sp, cp = torch.sin(phi), torch.cos(phi)
    st, ct = torch.sin(theta), torch.cos(theta)
    return TileGrid(near=near, far=far, fW=fW, fH=fH, hmin=hmin, hmax=hmax,
                    vmin=vmin, vmax=vmax, wrap_w=wrap_w, wrap_inv=wrap_inv,
                    inside=(px < W) & (py < H), fpx=fpx, fpy=fpy, ca=st * cp,
                    ct=ct, cg=-(st * sp),
                    tcx=(tx * tw).to(f32) + 0.5 * (tw - 1))


class Instances(NamedTuple):
    """The kernel's per-instance staging terms, [t, B] each (nrm and
    blend carry a trailing channel axis)."""
    T: tuple                # the 9 T columns Tux .. Twz
    A: tuple                # Tu x Tv
    Bc: tuple               # Tu x Tw
    Gc: tuple               # Tw x Tv
    npc: torch.Tensor
    cx: torch.Tensor        # seam-wrapped around the tile centre
    cy: torch.Tensor
    r_c: torch.Tensor
    opa: torch.Tensor
    c: tuple                # u_cam x v_cam
    si: torch.Tensor        # flip-signed inverse norm of c
    nrm: torch.Tensor       # [t, B, 3]
    blend: torch.Tensor     # [t, B, C + S]


def stage_instances(d_, g: TileGrid, tcx, C: int, S: int) -> Instances:
    """Per-instance terms of rows d_ [t, B, D] (composite_common.cuh
    stage_instance); tcx [t, 1] is each row's tile centre column."""
    Tux, Tuy, Tuz = d_[..., 0], d_[..., 1], d_[..., 2]
    Tvx, Tvy, Tvz = d_[..., 3], d_[..., 4], d_[..., 5]
    Twx, Twy, Twz = d_[..., 6], d_[..., 7], d_[..., 8]
    degen = (Tuz * Tuz + Twz * Twz) < 1e-20
    u_s = torch.where(degen, 0.0, Tuz)
    w_s = torch.where(degen, 1.0, Twz)
    phi_c = torch.atan2(u_s, w_s)
    theta_c = torch.atan2(torch.sqrt(u_s * u_s + w_s * w_s), -Tvz)
    r_c = torch.sqrt(Tuz * Tuz + Tvz * Tvz + Twz * Twz + 1e-24)
    cx = (phi_c - g.hmin) * g.fW / (g.hmax - g.hmin)
    cy = (theta_c - g.vmin) * g.fH / (g.vmax - g.vmin)
    cx = cx - g.wrap_w * torch.round((cx - tcx) * g.wrap_inv)
    c1 = Tvx * Twy - Twx * Tvy
    c2 = Twx * Tuy - Tux * Twy
    c3 = Tux * Tvy - Tvx * Tuy
    npc = c1 * Tuz + c2 * Tvz + c3 * Twz
    sign = torch.where(npc < 0, 1.0, -1.0)
    si = sign * torch.rsqrt(c1 * c1 + c2 * c2 + c3 * c3 + 1e-30)
    return Instances(
        T=(Tux, Tuy, Tuz, Tvx, Tvy, Tvz, Twx, Twy, Twz),
        A=(Tuy * Tvz - Tuz * Tvy, Tuz * Tvx - Tux * Tvz,
           Tux * Tvy - Tuy * Tvx),
        Bc=(Tuy * Twz - Tuz * Twy, Tuz * Twx - Tux * Twz,
            Tux * Twy - Tuy * Twx),
        Gc=(Twy * Tvz - Twz * Tvy, Twz * Tvx - Twx * Tvz,
            Twx * Tvy - Twy * Tvx),
        npc=npc, cx=cx, cy=cy, r_c=r_c, opa=d_[..., 9], c=(c1, c2, c3),
        si=si, nrm=torch.stack([c1 * si, c2 * si, c3 * si], dim=-1),
        blend=d_[..., PAYLOAD_BASE:PAYLOAD_BASE + C + S])


class Hits(NamedTuple):
    """One batch's (instance, pixel) pairs, [t, B(instances), pix]."""
    s1: torch.Tensor
    s2: torch.Tensor
    rp3: torch.Tensor
    use3d: torch.Tensor
    depth: torch.Tensor
    G: torch.Tensor
    a_raw: torch.Tensor
    alpha: torch.Tensor
    ok: torch.Tensor        # in range and accepted by the filters


def intersect(inst: Instances, g: TileGrid, idx, in_rng) -> Hits:
    """composite_common.cuh intersect() for the tiles ``idx``."""
    def i_(v):
        return v[:, :, None]
    ca, ct, cg = g.ca[idx, None, :], g.ct[idx, None, :], g.cg[idx, None, :]
    A, Bc, Gc = inst.A, inst.Bc, inst.Gc
    p1 = ca * i_(A[0]) + ct * i_(Bc[0]) + cg * i_(Gc[0])
    p2 = ca * i_(A[1]) + ct * i_(Bc[1]) + cg * i_(Gc[1])
    p3 = ca * i_(A[2]) + ct * i_(Bc[2]) + cg * i_(Gc[2])
    p3ok = p3 != 0.0
    rp3 = 1.0 / torch.where(p3ok, p3, 1.0)
    s1 = p1 * rp3
    s2 = p2 * rp3
    rho3d = s1 * s1 + s2 * s2
    dxp = i_(inst.cx) - g.fpx[idx, None, :]
    dyp = i_(inst.cy) - g.fpy[idx, None, :]
    rho2d = FILTER_INV_SQUARE * (dxp * dxp + dyp * dyp)
    use3d = rho3d <= rho2d
    rho = torch.minimum(rho3d, rho2d)
    depth = torch.where(use3d, i_(inst.npc) * rp3, i_(inst.r_c))
    G = torch.exp(-0.5 * rho)
    a_raw = i_(inst.opa) * G
    alpha = torch.clamp_max(a_raw, MAX_ALPHA)
    ok = (i_(in_rng) & p3ok & (depth >= g.near) & (depth <= g.far)
          & (alpha >= ALPHA_EPS))
    return Hits(s1=s1, s2=s2, rp3=rp3, use3d=use3d, depth=depth, G=G,
                a_raw=a_raw, alpha=alpha, ok=ok)


def composite_forward_reference(rows: torch.Tensor, tile_starts: torch.Tensor,
                                params, settings: RasterSettings, C: int,
                                S: int, ckpt: Checkpoints | None = None
                                ) -> CompositeOut:
    """Plain PyTorch version of the forward compositing kernel; with
    ``ckpt`` it also fills the checkpoint of every batch a tile reaches,
    from its running state before the block vote, as the kernel does."""
    dev = rows.device
    f32 = torch.float32
    B = settings.tile_pixels              # one CTA batch = one per pixel
    n_tiles = settings.num_tiles
    N = rows.shape[0]
    g = tile_grid(params, settings, dev)
    near, far = g.near, g.far
    k = torch.arange(B, device=dev)
    m_scale = far / (far - near)

    z = torch.zeros(n_tiles, B, dtype=f32, device=dev)
    T_run = g.inside.to(f32)
    acc = torch.zeros(n_tiles, C + S + 3, B, dtype=f32, device=dev)
    wsum, dsum, d2sum = z.clone(), z.clone(), z.clone()
    dist, M1, M2 = z.clone(), z.clone(), z.clone()
    med_d, med_pos, n_contrib = z.clone(), z.clone(), z.clone()
    walked = torch.zeros(n_tiles, dtype=torch.int64, device=dev)

    starts = tile_starts[:-1].to(torch.int64)
    counts = tile_starts[1:].to(torch.int64) - starts
    alive = torch.ones(n_tiles, dtype=torch.bool, device=dev)
    n_batches = -(-int(counts.max()) // B) if n_tiles else 0

    for c in range(n_batches):
        reached = alive & (counts > c * B)
        if ckpt is not None:
            r = torch.nonzero(reached)[:, 0]
            ckpt.state[ckpt.chunk_off[r].to(torch.int64) + c] = torch.cat(
                [T_run[r, None], acc[r, :C], acc[r, C + S:],
                 torch.stack([dsum[r], d2sum[r], wsum[r], M1[r], M2[r]],
                             dim=1)], dim=1)
        # the kernel's vote: walk batch c while some pixel has T >= T_STOP
        alive = reached & (T_run >= T_STOP).any(dim=1)
        idx = torch.nonzero(alive)[:, 0]
        if idx.numel() == 0:
            break
        pos = starts[idx, None] + c * B + k[None, :]         # [t, B]
        in_rng = pos < (starts + counts)[idx, None]
        d_ = rows[torch.clamp(pos, max=max(N - 1, 0))]       # [t, B, D]
        inst = stage_instances(d_, g, g.tcx[idx, None], C, S)
        h = intersect(inst, g, idx, in_rng)
        ok = h.ok
        a = torch.where(ok, h.alpha, 0.0)
        d_safe = torch.where(ok, h.depth, far)

        one_m = 1.0 - a
        incl = torch.cumprod(one_m, dim=1)
        excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)
        T_before = T_run[idx, None, :] * excl
        accept = ok & (T_before * one_m >= T_STOP)
        w = torch.where(accept, a * T_before, 0.0)

        fields = torch.cat([inst.blend, inst.nrm], dim=-1)       # [t, B, F]
        acc[idx] += torch.einsum("tkp,tkf->tfp", w, fields)
        wsum[idx] += w.sum(1)
        dw = d_safe * w
        dsum[idx] += dw.sum(1)
        d2sum[idx] += (dw * d_safe).sum(1)
        if settings.compute_distortion:
            m = m_scale * (1.0 - near / d_safe)
            mw = m * w
            m2w = m * m * w
            M1_b = M1[idx, None, :] + torch.cumsum(mw, 1) - mw
            M2_b = M2[idx, None, :] + torch.cumsum(m2w, 1) - m2w
            A_b = 1.0 - T_before
            dist[idx] += ((m * m * A_b + M2_b - 2.0 * m * M1_b) * w).sum(1)
            M1[idx] += mw.sum(1)
            M2[idx] += m2w.sum(1)

        # median: the last accepted instance with T_before > 0.5
        pos1 = (pos - starts[idx, None] + 1).to(f32)[:, :, None]
        score = torch.where(accept & (T_before > 0.5), pos1, 0.0)
        best, arg = score.max(dim=1)
        best_d = torch.gather(d_safe, 1, arg[:, None, :])[:, 0]
        upd = (best > med_pos[idx]) & (best > 0)
        med_d[idx] = torch.where(upd, best_d, med_d[idx])
        med_pos[idx] = torch.maximum(med_pos[idx], best)
        if settings.compute_contrib:
            nc = torch.where(accept, pos1, 0.0).amax(dim=1)
            n_contrib[idx] = torch.maximum(n_contrib[idx], nc)

        T_run[idx] = T_run[idx] * incl[:, -1]
        walked[idx] += in_rng.sum(1)

    misc = torch.stack([T_run, n_contrib, med_pos, M1, M2,
                        walked[:, None].to(f32).expand(n_tiles, B), wsum,
                        z], dim=1)
    depth4 = torch.stack([dsum, med_d, dist, d2sum], dim=1)
    return CompositeOut(color=_untile(acc[:, :C], settings),
                        feature=_untile(acc[:, C:], settings),
                        depth=_untile(depth4, settings),
                        misc=_untile(misc, settings))


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

