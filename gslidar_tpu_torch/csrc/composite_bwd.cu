// Backward compositing kernel for Hopper (sm_90a).
//
// Replaces: gslidar_tpu/raster/pallas_bwd.py::_bwd_kernel (launched by
// run_backward), the Pallas TPU kernel that turns the per-pixel
// cotangents of the composited panorama into one gradient row per sorted
// instance: dL/d(9 T columns, opacity, C colors, S features).
//
// What bounds it on this card: per-(instance, pixel) FP32 work and the
// per-instance reduction over the tile's pixels, not memory. Each pair
// repeats the forward's ~40 operations (one reciprocal, one expf) and
// adds ~60 for the gradient chain; each instance's row is a sum of 26
// per-pixel terms over up to 256 pixels. The bytes are one 72-byte row in
// and one out per instance, and 23 cotangent and forward-total planes
// read once per pixel.
//
// What the design does about it: the forward kernel's shape. One CTA per
// tile, one thread per pixel, the tile's instances staged through shared
// memory in batches of blockDim by composite_common.cuh's stage_instance,
// and walked FRONT TO BACK for exactly the count the forward walked (misc
// slot 5), with the forward's intersect(): every T, `ok` and `accept`
// decision is the forward's, bit for bit (--fmad=false). Every
// back-to-front suffix sum is total - inclusive prefix (pallas_bwd.py:
// 219-263): the cotangents are constant per pixel, so all of them collapse
// into one running prefix P of w*q against a qtot built from the forward
// totals, one scalar per thread. Per instance, each lane holds 26 terms
// (the bilinear basis of the T gradient, the low-pass centre terms, the
// depth, opacity and channel terms); a warp that has no `ok` lane skips
// the instance (__any_sync), which is most (instance, warp) pairs;
// otherwise a transpose reduction (31 shuffles for 32 values, lane l ends
// with the warp's sum of term l) reduces them, and the lanes write the
// warp's partial to shared memory. Every 32 instances (8 with 32 warps)
// the block syncs, and one thread per instance sums the warps' partials
// in warp order and forms the 18-float row (the cross products, the
// spherical Jacobian of the centre, the normal's normalize(u x v)): the
// reduction order is fixed, the table is deterministic, and each row is
// written once with no global atomics (each instance row belongs to one
// tile). Rows past the walked count are written as zeros.
//
// Gradient semantics (those of jax.grad through the XLA compositor):
//   * the 0.99 alpha clamp stops gradients;
//   * the S features do not feed back into alpha;
//   * the T_fin cotangent flows through every `ok` instance that was
//     walked, accepted or under the 1e-4 floor, into its opacity and its
//     geometry (the Pallas kernel sends it only to the opacity of the
//     instances under the floor);
//   * `|p3| = 0` lanes are rejected, and only `ok` lanes compute any
//     gradient term, so the edge-on inf/NaN of a rejected lane never
//     reaches a sum;
//   * the median depth cotangent goes to the median instance.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace gslidar;

constexpr int N_RED = 32;          // reduced terms per instance (warp width)
constexpr int RED_STRIDE = N_RED + 1;
constexpr int MAX_BLEND_BWD = N_RED - 18;   // C + S: 15 terms + C + S + 3
constexpr unsigned FULL = 0xffffffffu;

// reduced term layout
enum Term {
  R_CA = 0,           // ca * (dp1, dp2, dp3)
  R_CT = 3,           // ct * (dp1, dp2, dp3)
  R_CG = 6,           // cg * (dp1, dp2, dp3)
  R_C2D = 9,          // 2d branch: drho, drho * px, drho * py
  R_RC = 12,          // 2d branch depth: dL/d(centre range)
  R_NPC = 13,         // 3d branch depth: dL/d(npc)
  R_OPA = 14,         // dL/d(opacity)
  R_CH = 15           // w * cotangent of the C colors, S features, 3 normals
};

// Sums v[0..31] over the warp's lanes; lane l returns the sum of v[l].
// Recursive halving: at each step a lane keeps one half of its live
// values and adds its partner's copy of that half.
__device__ __forceinline__ float warp_transpose_sum(float (&v)[N_RED]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const float send = upper ? v[i] : v[i + o];
      const float keep = upper ? v[i + o] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, o);
    }
  }
  return v[0];
}

__device__ __forceinline__ void cross(const float* a, const float* b,
                                      float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// One instance's gradient row from its reduced terms R (pallas_bwd.py:
// 318-457): the T columns through the bilinear form, the centre pixel and
// range through the spherical Jacobian, the 3d depth through npc and the
// normal through the flip-signed normalize(u_cam x v_cam).
__device__ __forceinline__ void finish_row(const float* r, const float* R,
                                           float cx, float cy, int C, int S,
                                           float kx, float ky,
                                           float* __restrict__ out) {
  const float Tu[3] = {r[0], r[1], r[2]};
  const float Tv[3] = {r[3], r[4], r[5]};
  const float Tw[3] = {r[6], r[7], r[8]};
  const float gA[3] = {R[R_CA], R[R_CA + 1], R[R_CA + 2]};
  const float gB[3] = {R[R_CT], R[R_CT + 1], R[R_CT + 2]};
  const float gG[3] = {R[R_CG], R[R_CG + 1], R[R_CG + 2]};
  // A = Tu x Tv, B = Tu x Tw, G = Tw x Tv
  float a1[3], a2[3], b1[3], b2[3], c1_[3], c2_[3];
  cross(Tv, gA, a1);
  cross(Tw, gB, a2);
  cross(gA, Tu, b1);
  cross(Tw, gG, b2);
  cross(gB, Tu, c1_);
  cross(Tv, gG, c2_);

  // centre pixel / range -> p_cam = (Tuz, Tvz, Twz)
  const float gxi = 2.0f * FILTER_INV_SQUARE * (cx * R[R_C2D] - R[R_C2D + 1]);
  const float gyi = 2.0f * FILTER_INV_SQUARE * (cy * R[R_C2D] - R[R_C2D + 2]);
  const float gri = R[R_RC];
  const float u_p = Tu[2], v_p = Tv[2], w_p = Tw[2];
  const bool degen = (u_p * u_p + w_p * w_p) < 1e-20f;
  const float u_s = degen ? 0.0f : u_p;
  const float w_s = degen ? 1.0f : w_p;
  const float ruw2 = u_s * u_s + w_s * w_s;
  const float ruw = sqrtf(ruw2);
  const float r2q = ruw2 + v_p * v_p;
  const float inv_ruw2 = 1.0f / ruw2;
  const float inv_rq = 1.0f / (ruw * r2q);
  const float inv_r = 1.0f / sqrtf(u_p * u_p + v_p * v_p + w_p * w_p + 1e-24f);
  const float gU = gxi * (kx * w_s * inv_ruw2) -
                   gyi * (ky * u_s * v_p * inv_rq) + gri * (u_p * inv_r);
  const float gV = gyi * (ky * ruw / r2q) + gri * (v_p * inv_r);
  const float gW = -gxi * (kx * u_s * inv_ruw2) -
                   gyi * (ky * v_p * w_s * inv_rq) + gri * (w_p * inv_r);

  // depth = npc * rp3 with npc = det(u_cam, v_cam, p_cam); and the normal
  float c1, c2, c3, npc, si;
  splat_normal(r, c1, c2, c3, npc, si);
  const float u_cam[3] = {Tu[0], Tv[0], Tw[0]};
  const float v_cam[3] = {Tu[1], Tv[1], Tw[1]};
  const float p_cam[3] = {u_p, v_p, w_p};
  float vxp[3], pxu[3];
  cross(v_cam, p_cam, vxp);
  cross(p_cam, u_cam, pxu);
  const float dnpc = R[R_NPC];
  const float n[3] = {c1 * si, c2 * si, c3 * si};
  const int gn = R_CH + C + S;
  const float gN[3] = {R[gn], R[gn + 1], R[gn + 2]};
  const float gdot = n[0] * gN[0] + n[1] * gN[1] + n[2] * gN[2];
  const float h[3] = {si * (gN[0] - n[0] * gdot), si * (gN[1] - n[1] * gdot),
                      si * (gN[2] - n[2] * gdot)};
  float gu[3], gv[3];
  cross(v_cam, h, gu);
  cross(h, u_cam, gv);

  out[0] = (a1[0] + a2[0]) + gu[0] + dnpc * vxp[0];
  out[1] = (a1[1] + a2[1]) + gv[0] + dnpc * pxu[0];
  out[2] = (a1[2] + a2[2]) + gU + dnpc * c1;
  out[3] = (b1[0] - b2[0]) + gu[1] + dnpc * vxp[1];
  out[4] = (b1[1] - b2[1]) + gv[1] + dnpc * pxu[1];
  out[5] = (b1[2] - b2[2]) + gV + dnpc * c2;
  out[6] = (c1_[0] + c2_[0]) + gu[2] + dnpc * vxp[2];
  out[7] = (c1_[1] + c2_[1]) + gv[2] + dnpc * pxu[2];
  out[8] = (c1_[2] + c2_[2]) + gW + dnpc * c3;
  out[9] = R[R_OPA];
  for (int c = 0; c < C + S; ++c) out[10 + c] = R[R_CH + c];
}

template <int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
composite_bwd_kernel(const float* __restrict__ rows, int D,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ walked, int tiles_x, int tile_h,
                     int tile_w, int H, int W, int C, int S, Params prm,
                     int compute_distortion, int sub,
                     const float* __restrict__ gC,
                     const float* __restrict__ gF,
                     const float* __restrict__ gD4,
                     const float* __restrict__ gT,
                     const float* __restrict__ color,
                     const float* __restrict__ feat,
                     const float* __restrict__ depth,
                     const float* __restrict__ misc,
                     float* __restrict__ grad) {
  extern __shared__ float smem[];
  const int B = blockDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_warps = B >> 5;
  const int tile = blockIdx.x;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int px = tx * tile_w + tid % tile_w;
  const int py = ty * tile_h + tid / tile_w;
  const bool inside = px < W && py < H;
  const int NB = C + S;
  const int NCH = NB + 3;               // channel terms: C, S, 3 normals
  const int NV = R_CH + NCH;            // reduced terms per instance
  float* stage = smem;                          // [F_BLEND + NB][B]
  float* red = smem + (F_BLEND + NB) * B;       // [n_warps][sub][RED_STRIDE]

  const float fW = (float)W;
  const float fH = (float)H;
  const Ray ray = pixel_ray(px, py, W, H, prm);
  const float tcx = (float)(tx * tile_w) + 0.5f * (float)(tile_w - 1);
  const float m_scale = prm.far / (prm.far - prm.near);

  // per-pixel cotangents and forward totals; gq holds the cotangent of
  // each blended channel that feeds back into alpha (colors, not S)
  float gch[MAX_BLEND_BWD + 3];       // all channels, for the row terms
  float gq[MAX_BLEND_BWD];
  float gN[3] = {0.f, 0.f, 0.f};      // the normals' cotangents
  float gTfin = 0.f, gD = 0.f, gMed = 0.f, gDist = 0.f, gD2 = 0.f;
  float T_fin = 0.f, med_pos = 0.f, M1t = 0.f, M2t = 0.f, A_fin = 0.f;
  float qtot = 0.f;
  const size_t HW = (size_t)H * W;
  const size_t o = (size_t)py * W + px;
#pragma unroll
  for (int c = 0; c < MAX_BLEND_BWD + 3; ++c) gch[c] = 0.f;
#pragma unroll
  for (int c = 0; c < MAX_BLEND_BWD; ++c) gq[c] = 0.f;
  if (inside) {
#pragma unroll
    for (int c = 0; c < MAX_BLEND_BWD + 3; ++c) {
      if (c < C) gch[c] = gC[c * HW + o];
      else if (c < NCH) gch[c] = gF[(c - C) * HW + o];
    }
#pragma unroll
    for (int c = 0; c < MAX_BLEND_BWD; ++c)
      if (c < C) gq[c] = gch[c];
#pragma unroll
    for (int c = 0; c < 3; ++c) gN[c] = gF[(S + c) * HW + o];
    gD = gD4[0 * HW + o];
    gMed = gD4[1 * HW + o];
    gDist = gD4[2 * HW + o];
    gD2 = gD4[3 * HW + o];
    gTfin = gT[o];
    T_fin = misc[0 * HW + o];
    med_pos = misc[2 * HW + o];
    M1t = misc[3 * HW + o];
    M2t = misc[4 * HW + o];
    const float Wt = misc[6 * HW + o];
    A_fin = 1.0f - T_fin;
#pragma unroll
    for (int c = 0; c < MAX_BLEND_BWD; ++c)
      if (c < C) qtot += gq[c] * color[c * HW + o];
#pragma unroll
    for (int c = 0; c < 3; ++c) qtot += gN[c] * feat[(S + c) * HW + o];
    qtot += gD * depth[0 * HW + o];
    qtot += gD2 * depth[3 * HW + o];
    if (compute_distortion)
      qtot += gDist * (M2t * Wt + A_fin * M2t - 2.0f * M1t * M1t);
  }
  // outer-product factors of the centre chain, per instance
  const float kx = fW / (prm.hmax - prm.hmin);
  const float ky = fH / (prm.vmax - prm.vmin);

  float T = inside ? 1.0f : 0.0f;
  float P = 0.f;                        // inclusive prefix of w * q
  const int start = tile_starts[tile];
  const int end = tile_starts[tile + 1];
  const int stop = start + walked[tile];

  for (int base = start; base < stop; base += B) {
    __syncthreads();                    // the staging area is free
    const int k = base + tid;
    if (k < stop)
      stage_instance(rows + (size_t)k * D, stage + tid, B, NB, fW, fH, tcx,
                     prm);
    __syncthreads();
    const int n = min(B, stop - base);

    for (int j0 = 0; j0 < n; j0 += sub) {
      const int nj = min(sub, n - j0);
      for (int jj = 0; jj < nj; ++jj) {
        const int j = j0 + jj;
        const float* s = stage + j;
        const Hit h = intersect(s, B, ray, prm);
        const bool ok = inside && h.ok;
        float v[N_RED];
#pragma unroll
        for (int i = 0; i < N_RED; ++i) v[i] = 0.f;
        if (ok) {
          const float T_before = T;
          const float u = 1.0f - h.alpha;
          T = T_before * u;
          float dL_da = 0.f;
          float dL_dd = 0.f;
          if (T >= T_STOP) {                      // accepted
            const float w = h.alpha * T_before;
            const float d = h.d;
            float q = 0.f;
#pragma unroll
            for (int c = 0; c < MAX_BLEND_BWD; ++c)
              if (c < C) q += gq[c] * s[(F_BLEND + c) * B];
            q += gN[0] * s[F_N1 * B];
            q += gN[1] * s[F_N2 * B];
            q += gN[2] * s[F_N3 * B];
            q += gD * d;
            q += gD2 * (d * d);
            float m = 0.f;
            if (compute_distortion) {
              m = m_scale * (1.0f - prm.near / d);
              q += gDist * (M2t + m * m * A_fin - 2.0f * m * M1t);
            }
            P += w * q;
            dL_da = T_before * q - (qtot - P) / u;
            dL_dd = w * (gD + 2.0f * d * gD2);
            const float pos1 = (float)(base + j - start + 1);
            if (pos1 == med_pos) dL_dd += gMed;
            if (compute_distortion) {
              const float dmd_dd =
                  (prm.far * prm.near) / ((prm.far - prm.near) * d * d);
              dL_dd += 2.0f * w * (m * A_fin - M1t) * gDist * dmd_dd;
            }
#pragma unroll
            for (int c = 0; c < MAX_BLEND_BWD + 3; ++c)
              if (c < NCH) v[R_CH + c] = w * gch[c];
          }
          dL_da -= gTfin * (T_fin / u);
          const bool clamp_ok = h.a_raw < MAX_ALPHA;
          const float dL_dG = clamp_ok ? s[F_OPA * B] * dL_da : 0.f;
          v[R_OPA] = clamp_ok ? h.G * dL_da : 0.f;
          const float dL_drho = -0.5f * h.G * dL_dG;
          if (h.use3d) {
            const float dL_ds1 = dL_drho * 2.0f * h.s1;
            const float dL_ds2 = dL_drho * 2.0f * h.s2;
            const float dp1 = dL_ds1 * h.rp3;
            const float dp2 = dL_ds2 * h.rp3;
            const float dp3 = -(dL_ds1 * h.s1 + dL_ds2 * h.s2) * h.rp3 -
                              dL_dd * h.d * h.rp3;
            v[R_NPC] = dL_dd * h.rp3;
            v[R_CA + 0] = ray.ca * dp1;
            v[R_CA + 1] = ray.ca * dp2;
            v[R_CA + 2] = ray.ca * dp3;
            v[R_CT + 0] = ray.ct * dp1;
            v[R_CT + 1] = ray.ct * dp2;
            v[R_CT + 2] = ray.ct * dp3;
            v[R_CG + 0] = ray.cg * dp1;
            v[R_CG + 1] = ray.cg * dp2;
            v[R_CG + 2] = ray.cg * dp3;
          } else {
            v[R_C2D + 0] = dL_drho;
            v[R_C2D + 1] = dL_drho * ray.fpx;
            v[R_C2D + 2] = dL_drho * ray.fpy;
            v[R_RC] = dL_dd;
          }
        }
        float* slot = red + (warp * sub + jj) * RED_STRIDE;
        if (__any_sync(FULL, ok)) {
          const float total = warp_transpose_sum(v);
          if (lane < NV) slot[lane] = total;
        } else if (lane < NV) {
          slot[lane] = 0.f;
        }
      }
      __syncthreads();
      if (tid < nj) {
        const int j = j0 + tid;
        float R[N_RED];
#pragma unroll
        for (int i = 0; i < N_RED; ++i) R[i] = 0.f;
        for (int w_ = 0; w_ < n_warps; ++w_) {
          const float* part = red + (w_ * sub + tid) * RED_STRIDE;
#pragma unroll
          for (int i = 0; i < N_RED; ++i)
            if (i < NV) R[i] += part[i];
        }
        const int kk = base + j;
        finish_row(rows + (size_t)kk * D, R, stage[F_CX * B + j],
                   stage[F_CY * B + j], C, S, kx, ky,
                   grad + (size_t)kk * D);
      }
      __syncthreads();                  // the partials are free
    }
  }
  // instances the forward never reached get no gradient
  for (int k = stop + tid; k < end; k += B)
    for (int c = 0; c < D; ++c) grad[(size_t)k * D + c] = 0.f;
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an
// int (0 = cudaSuccess). All pointers are device pointers. rows and grad
// are [N, D] float32 with D = 10 + C + S; tile_starts is [n_tiles + 1]
// and walked [n_tiles] int32 (instances each tile's forward walked);
// the cotangents gC [C,H,W], gF [S+3,H,W], gD4 [4,H,W], gT [1,H,W] and
// the forward outputs color, feat, depth, misc are float32 planes.
extern "C" int gslidar_composite_bwd(
    int device, const float* rows, int D, const int* tile_starts,
    const int* walked, int n_tiles, int tiles_x, int tile_h, int tile_w,
    int H, int W, int C, int S, float near, float far, float vmin,
    float vmax, float hmin, float hmax, float wrap_w, float wrap_inv,
    int compute_distortion, const float* gC, const float* gF,
    const float* gD4, const float* gT, const float* color, const float* feat,
    const float* depth, const float* misc, float* grad, void* stream) {
  const int threads = tile_h * tile_w;
  if (C < 0 || S < 0 || C + S > MAX_BLEND_BWD || D != 10 + C + S ||
      threads > 1024 || threads % 32 != 0 || n_tiles <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // instances per reduction round: the warps' partials take
  // n_warps * sub * RED_STRIDE floats (34 KB)
  const int n_warps = threads / 32;
  const int sub = n_warps <= 8 ? 32 : 256 / n_warps;
  const size_t smem =
      ((size_t)(F_BLEND + C + S) * threads +
       (size_t)n_warps * sub * RED_STRIDE) * sizeof(float);
  auto kernel = threads <= 256 ? composite_bwd_kernel<256>
                               : composite_bwd_kernel<1024>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const Params prm{near, far, vmin, vmax, hmin, hmax, wrap_w, wrap_inv};
  kernel<<<n_tiles, threads, smem, (cudaStream_t)stream>>>(
      rows, D, tile_starts, walked, tiles_x, tile_h, tile_w, H, W, C, S, prm,
      compute_distortion, sub, gC, gF, gD4, gT, color, feat, depth, misc,
      grad);
  return (int)cudaGetLastError();
}
