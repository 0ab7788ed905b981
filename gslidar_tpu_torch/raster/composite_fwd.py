"""Forward compositing: the CUDA kernel's wrapper and its plain PyTorch
version (port of gslidar_tpu/raster/pallas_fwd.py::_kernel).

Both take the sorted payload rows of ``binning.bin_gaussians`` — [N, D]
float32 with D = 10 + C + S: the 9 columns of T (component triples
Tu, Tv, Tw), opacity, C colors, S features — and the [n_tiles + 1] tile
range table, and return the composited panorama as [channels, H, W]
planes (``CompositeOut``).

``composite_forward`` is the wrapper: CPU tensors go to the plain version,
CUDA tensors to the kernel in ``csrc/composite_fwd.cu``, and anything else
raises. ``composite_forward_reference`` is the plain version, written to
walk instances exactly as the kernel does: in per-tile batches of one
instance per tile pixel, with the block's early exit between batches.
Within a batch it is vectorized over tiles x instances x pixels, with a
cumprod for the transmittance, and runs on the CPU and on the card. It
performs the kernel's per-instance and per-pixel arithmetic in the same
order on float32 device scalars, so the two agree to rounding in the
transmittance products and the channel sums.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gslidar_tpu_torch.raster.settings import (ALPHA_EPS, FAR_N,
                                               FILTER_INV_SQUARE, MAX_ALPHA,
                                               NEAR_N, RasterSettings,
                                               T_STOP)

PAYLOAD_BASE = 10    # 9 T columns + opacity, then C colors and S features
MAX_BLEND = 16       # C + S the kernel accumulates (csrc MAX_BLEND)


class CompositeOut(NamedTuple):
    color: torch.Tensor     # [C, H, W] blended channels (no background)
    feature: torch.Tensor   # [S + 3, H, W] extra features, then the normal
    depth: torch.Tensor     # [4, H, W] sum w*d, median d, distortion,
                            # sum w*d^2
    misc: torch.Tensor      # [8, H, W] final T, n_contrib, median position,
                            # M1, M2, instances walked, sum w, 0


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
                                S: int) -> CompositeOut:
    """Plain PyTorch version of the forward compositing kernel."""
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
        # the kernel's vote: walk batch c while some pixel has T >= T_STOP
        alive = alive & (counts > c * B)
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

        T_new = T_run[idx] * incl[:, -1]
        T_run[idx] = T_new
        walked[idx] += in_rng.sum(1)
        alive[idx] = (T_new >= T_STOP).any(dim=1)

    misc = torch.stack([T_run, n_contrib, med_pos, M1, M2,
                        walked[:, None].to(f32).expand(n_tiles, B), wsum,
                        z], dim=1)
    depth4 = torch.stack([dsum, med_d, dist, d2sum], dim=1)
    return CompositeOut(color=_untile(acc[:, :C], settings),
                        feature=_untile(acc[:, C:], settings),
                        depth=_untile(depth4, settings),
                        misc=_untile(misc, settings))


def _check_inputs(rows, tile_starts, settings: RasterSettings, C, S):
    if rows.dtype != torch.float32 or rows.dim() != 2:
        raise TypeError(f"rows must be a 2-D float32 tensor, got "
                        f"{rows.dtype} {tuple(rows.shape)}")
    if rows.shape[1] != PAYLOAD_BASE + C + S:
        raise ValueError(f"rows have {rows.shape[1]} columns, expected "
                         f"{PAYLOAD_BASE + C + S} for C={C}, S={S}")
    if tile_starts.dtype != torch.int32 or \
            tuple(tile_starts.shape) != (settings.num_tiles + 1,):
        raise TypeError(f"tile_starts must be int32 [{settings.num_tiles + 1}]"
                        f", got {tile_starts.dtype} "
                        f"{tuple(tile_starts.shape)}")
    if rows.device != tile_starts.device:
        raise ValueError(f"rows on {rows.device}, tile_starts on "
                         f"{tile_starts.device}")
    if not (rows.is_contiguous() and tile_starts.is_contiguous()):
        raise ValueError("rows and tile_starts must be contiguous")
    if C + S > MAX_BLEND:
        raise ValueError(f"C + S = {C + S} exceeds the kernel's {MAX_BLEND}")


def composite_forward(rows: torch.Tensor, tile_starts: torch.Tensor, params,
                      settings: RasterSettings, C: int,
                      S: int) -> CompositeOut:
    """Composite sorted instance rows into a panorama.

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (``composite_forward.launches`` counts those
    launches); any other device raises.
    """
    _check_inputs(rows, tile_starts, settings, C, S)
    if rows.device.type == "cpu":
        return composite_forward_reference(rows, tile_starts, params,
                                           settings, C, S)
    if rows.device.type != "cuda":
        raise ValueError(f"composite_forward runs on cpu or cuda tensors, "
                         f"not {rows.device}")
    from gslidar_tpu_torch.kernels import load_library
    lib = load_library()
    H, W = settings.height, settings.width
    empty = dict(dtype=torch.float32, device=rows.device)
    color = torch.empty(C, H, W, **empty)
    feat = torch.empty(S + 3, H, W, **empty)
    depth = torch.empty(4, H, W, **empty)
    misc = torch.empty(8, H, W, **empty)
    dev = rows.device.index if rows.device.index is not None \
        else torch.cuda.current_device()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gslidar_composite_fwd(
            dev, rows.data_ptr(), rows.shape[1], tile_starts.data_ptr(),
            settings.num_tiles, settings.tiles_x, settings.tile_h,
            settings.tile_w, H, W, C, S, *params,
            int(settings.compute_distortion), int(settings.compute_contrib),
            color.data_ptr(), feat.data_ptr(), depth.data_ptr(),
            misc.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"composite_fwd kernel launch failed: CUDA error "
                           f"{err}")
    composite_forward.launches += 1
    return CompositeOut(color=color, feature=feat, depth=depth, misc=misc)


composite_forward.launches = 0
