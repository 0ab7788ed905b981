// Device code shared by the forward and backward compositing kernels.
//
// The backward kernel recomputes each pixel's walk: its transmittance, its
// `ok` decisions and its `accept` decisions. A T within rounding of the
// 1e-4 floor or of 0.5 (the median) would flip between the two passes
// unless both run exactly the same IEEE operations in the same order, so
// the per-instance staging and the per-pixel intersection live here, once.
// Both kernels are built with --fmad=false (kernels.py).

#pragma once

#include <cuda_runtime.h>

namespace gslidar {

constexpr int MAX_BLEND = 16;              // C + S
constexpr float T_STOP = 1e-4f;
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float MAX_ALPHA = 0.99f;
constexpr float FILTER_INV_SQUARE = 2.0f;

// per-instance fields staged in shared memory, laid out [field][blockDim]
enum Field {
  F_AX, F_AY, F_AZ,       // Tu x Tv
  F_BX, F_BY, F_BZ,       // Tu x Tw
  F_GX, F_GY, F_GZ,       // Tw x Tv
  F_NPC,                  // (u_cam x v_cam) . p_cam
  F_CX, F_CY, F_RC,       // splat centre pixel (seam-wrapped) and range
  F_OPA,
  F_N1, F_N2, F_N3,       // flip-signed unit normal
  F_BLEND                 // then C colors and S features
};

struct Params {
  float near, far, vmin, vmax, hmin, hmax, wrap_w, wrap_inv;
};

// A pixel's ray: its float coordinates and the three coefficients of the
// linear ray-splat form.
struct Ray {
  float fpx, fpy, ca, ct, cg;
};

__device__ __forceinline__ Ray pixel_ray(int px, int py, int W, int H,
                                         const Params& prm) {
  const float fW = (float)W;
  const float fH = (float)H;
  Ray ray;
  ray.fpx = (float)px;
  ray.fpy = (float)py;
  const float phi = ray.fpx * (prm.hmax - prm.hmin) / fW + prm.hmin;
  const float theta = ray.fpy * (prm.vmax - prm.vmin) / fH + prm.vmin;
  const float sp = sinf(phi), cp = cosf(phi);
  const float st = sinf(theta), ct = cosf(theta);
  ray.ca = st * cp;
  ray.ct = ct;
  ray.cg = -(st * sp);
  return ray;
}

// Splat centre pixel (cx wrapped once around the tile centre tcx) and
// range from the p_cam triple (Tuz, Tvz, Twz), guarded at the origin.
__device__ __forceinline__ void splat_centre(float Tuz, float Tvz, float Twz,
                                             float fW, float fH, float tcx,
                                             const Params& prm, float& cx,
                                             float& cy, float& r_c) {
  const bool degen = (Tuz * Tuz + Twz * Twz) < 1e-20f;
  const float u_s = degen ? 0.0f : Tuz;
  const float w_s = degen ? 1.0f : Twz;
  const float phi_c = atan2f(u_s, w_s);
  const float theta_c = atan2f(sqrtf(u_s * u_s + w_s * w_s), -Tvz);
  r_c = sqrtf(Tuz * Tuz + Tvz * Tvz + Twz * Twz + 1e-24f);
  cx = (phi_c - prm.hmin) * fW / (prm.hmax - prm.hmin);
  cy = (theta_c - prm.vmin) * fH / (prm.vmax - prm.vmin);
  // circular seam (a no-op when wrap_w = wrap_inv = 0)
  cx = cx - prm.wrap_w * rintf((cx - tcx) * prm.wrap_inv);
}

// The unnormalized normal c = u_cam x v_cam, npc = c . p_cam and the
// flip-signed inverse norm si (normal = c * si).
__device__ __forceinline__ void splat_normal(const float* r, float& c1,
                                             float& c2, float& c3,
                                             float& npc, float& si) {
  const float Tux = r[0], Tuy = r[1], Tuz = r[2];
  const float Tvx = r[3], Tvy = r[4], Tvz = r[5];
  const float Twx = r[6], Twy = r[7], Twz = r[8];
  c1 = Tvx * Twy - Twx * Tvy;
  c2 = Twx * Tuy - Tux * Twy;
  c3 = Tux * Tvy - Tvx * Tuy;
  npc = c1 * Tuz + c2 * Tvz + c3 * Twz;
  const float sign = npc < 0.0f ? 1.0f : -1.0f;
  si = sign * rsqrtf(c1 * c1 + c2 * c2 + c3 * c3 + 1e-30f);
}

// Stages instance row r (D = 10 + NB floats) into column s of the
// [field][B] staging area: the per-instance terms each pixel reads.
__device__ __forceinline__ void stage_instance(const float* r, float* s,
                                               int B, int NB, float fW,
                                               float fH, float tcx,
                                               const Params& prm) {
  const float Tux = r[0], Tuy = r[1], Tuz = r[2];
  const float Tvx = r[3], Tvy = r[4], Tvz = r[5];
  const float Twx = r[6], Twy = r[7], Twz = r[8];
  float cx, cy, r_c;
  splat_centre(Tuz, Tvz, Twz, fW, fH, tcx, prm, cx, cy, r_c);
  float c1, c2, c3, npc, si;
  splat_normal(r, c1, c2, c3, npc, si);
  s[F_AX * B] = Tuy * Tvz - Tuz * Tvy;
  s[F_AY * B] = Tuz * Tvx - Tux * Tvz;
  s[F_AZ * B] = Tux * Tvy - Tuy * Tvx;
  s[F_BX * B] = Tuy * Twz - Tuz * Twy;
  s[F_BY * B] = Tuz * Twx - Tux * Twz;
  s[F_BZ * B] = Tux * Twy - Tuy * Twx;
  s[F_GX * B] = Twy * Tvz - Twz * Tvy;
  s[F_GY * B] = Twz * Tvx - Twx * Tvz;
  s[F_GZ * B] = Twx * Tvy - Twy * Tvx;
  s[F_NPC * B] = npc;
  s[F_CX * B] = cx;
  s[F_CY * B] = cy;
  s[F_RC * B] = r_c;
  s[F_OPA * B] = r[9];
  s[F_N1 * B] = c1 * si;
  s[F_N2 * B] = c2 * si;
  s[F_N3 * B] = c3 * si;
  for (int c = 0; c < NB; ++c) s[(F_BLEND + c) * B] = r[10 + c];
}

// One (instance, pixel) pair: the ray-splat intersection, the low-pass
// filter, depth and alpha.
struct Hit {
  float p1, p2, p3, rp3, s1, s2;
  float d, G, a_raw, alpha;
  bool use3d, ok;
};

__device__ __forceinline__ Hit intersect(const float* s, int B,
                                         const Ray& ray, const Params& prm) {
  Hit h;
  // p = st*cp*(Tu x Tv) + ct*(Tu x Tw) - st*sp*(Tw x Tv)
  h.p1 = ray.ca * s[F_AX * B] + ray.ct * s[F_BX * B] + ray.cg * s[F_GX * B];
  h.p2 = ray.ca * s[F_AY * B] + ray.ct * s[F_BY * B] + ray.cg * s[F_GY * B];
  h.p3 = ray.ca * s[F_AZ * B] + ray.ct * s[F_BZ * B] + ray.cg * s[F_GZ * B];
  const bool p3ok = h.p3 != 0.0f;
  h.rp3 = 1.0f / (p3ok ? h.p3 : 1.0f);
  h.s1 = h.p1 * h.rp3;
  h.s2 = h.p2 * h.rp3;
  const float rho3d = h.s1 * h.s1 + h.s2 * h.s2;
  const float dxp = s[F_CX * B] - ray.fpx;
  const float dyp = s[F_CY * B] - ray.fpy;
  const float rho2d = FILTER_INV_SQUARE * (dxp * dxp + dyp * dyp);
  h.use3d = rho3d <= rho2d;
  // NaN-propagating min, like torch.minimum: a NaN rho3d rejects
  const float rho = rho3d > rho2d ? rho2d : rho3d;
  h.d = h.use3d ? s[F_NPC * B] * h.rp3 : s[F_RC * B];
  h.G = expf(-0.5f * rho);
  h.a_raw = s[F_OPA * B] * h.G;
  h.alpha = h.a_raw > MAX_ALPHA ? MAX_ALPHA : h.a_raw;
  h.ok = p3ok && h.d >= prm.near && h.d <= prm.far && h.alpha >= ALPHA_EPS;
  return h;
}

}  // namespace gslidar
