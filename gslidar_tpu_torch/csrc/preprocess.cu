// The panoramic preprocess pass and its SH evaluation, forward and
// backward, for Hopper (sm_90a).
//
// Replaces: the XLA stage gslidar_tpu/raster/preprocess.py:191
// (``preprocess``) together with gslidar_tpu/ops/sh.py:56 (``eval_sh``),
// which the JAX package leaves to one jit-fused XLA program, and their
// autodiff. Per gaussian: the splat frame T (rows u_cam, v_cam, p_cam),
// the camera-facing normal, the centre's pixel and range, the panoramic
// frustum cull, the 12-sample AABB of the cutoff ellipse, the tight
// per-axis tile rect (or the square one), the modular column run of a
// circular panorama, and the SH colour with its clamp mask. The backward
// takes the cotangents of T and of the colour to the gradients of the
// means, the first two scales, the quaternion and the SH coefficients.
//
// What bounds it on this card: bytes. One thread per gaussian reads its
// means, two scales, quaternion, opacity, mask and 16 x 4 SH coefficients
// (about 300 B at SH degree 3) and writes T, xy, depth, normal, colour,
// radius, the two int rects, the tile count, valid and the clamp mask
// (about 105 B): at 1M gaussians ~0.41 GB, ~0.12 ms at 3.35 TB/s. The
// backward reads the cotangents and the inputs again and writes the four
// gradients, ~650 B a gaussian, ~0.2 ms at 1M. The arithmetic (a few
// hundred float32 operations and ~50 MUFU operations a gaussian, most
// of them the 12 samples' atan2f and sqrtf) takes a tenth of that
// (gslidar_tpu_torch/microbench/bounds.py).
//
// What the design does about it: one pass that reads each input once and
// writes each output once, with no [P, 12, 3] or [P, 16] intermediates in
// device memory (the plain PyTorch version makes ~60 launches over such
// tensors). The SH rows, the one large per-gaussian array, go through
// shared memory: a block copies its 128 gaussians' contiguous K x C
// floats with consecutive threads on consecutive words, and each thread
// reads its own row from there (rows padded by one word, so the 32 rows
// of a warp fall in 32 banks). The backward writes its d SH rows the same
// way. It keeps nothing from the forward but the [P, C] clamp mask: it
// recomputes the rotation, the basis and the view direction.
//
// Bits: the plain version (raster/preprocess.py ``_preprocess_plain``)
// writes its small products out as sums in a fixed order and this kernel
// runs the same IEEE operations in the same order (the library is built
// with --fmad=false), so the integer rects, which floor pixel positions,
// agree with it. The 12 sample directions are the plain version's own
// sin and cos, read from device memory. Two things differ: atan2f, logf
// and sqrtf are the toolkit's here and torch's own build there (no FMA
// contraction here), and torch divides a tensor by a Python scalar as a
// product with the scalar's float32 reciprocal, which the wrapper hands
// over (``PrepParams``).

#include <cuda_runtime.h>
#include <stdint.h>

// field for field raster/preprocess.py's _KernelParams (outside the
// anonymous namespace: the exported launchers take it)
struct PrepParams {
  int P, K, C, n_sh, width, height, tile_w, tile_h, tiles_x, tiles_y;
  int wrap_x, tight, scale_stride, scale_cols;
  float scale_modifier, hmin, vmin, fW, fH, hrange, vrange, inv_hrange,
      inv_vrange, cv, ch, half_v, half_h, inv_half_v, inv_half_h, near,
      two_pi, inv_two_pi, fTW, fTH, inv_tw, inv_th;
};

namespace {

constexpr int THREADS = 128;
constexpr int SAMPLES = 12;
constexpr int MAX_COEFFS = 16;
constexpr int MAX_CHANNELS = 16;
constexpr float FRUSTUM_MARGIN = 1.3f;

// torch on the card divides a tensor by a Python scalar b as a product
// with a float32 reciprocal of b (the wrapper reads torch's own)
__device__ __forceinline__ float div_scalar(float a, float inv_b) {
  return a * inv_b;
}

// the SH constants as torch applies the plain version's Python floats:
// the double, rounded to float32
#define SHF(x) ((float)(x))
__device__ __constant__ float SH_C0 = SHF(0.28209479177387814);
__device__ __constant__ float SH_C1 = SHF(0.4886025119029199);
__device__ __constant__ float SH_C2[5] = {
    SHF(1.0925484305920792), SHF(-1.0925484305920792),
    SHF(0.31539156525252005), SHF(-1.0925484305920792),
    SHF(0.5462742152960396)};
__device__ __constant__ float SH_C3[7] = {
    SHF(-0.5900435899266435), SHF(2.890611442640554),
    SHF(-0.4570457994644658), SHF(0.3731763325901154),
    SHF(-0.4570457994644658), SHF(1.445305721320277),
    SHF(-0.5900435899266435)};

// torch.clamp_min / torch.maximum / torch.minimum on non-NaN floats
__device__ __forceinline__ float fmax_(float a, float b) {
  return a > b ? a : b;
}
__device__ __forceinline__ float fmin_(float a, float b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// quat_to_rotmat: the quaternion normalised by sqrt(|q|^2 + 1e-24), its
// norm, and R (R[i][j]: row i, column j; the columns are the splat axes)
__device__ __forceinline__ void rotation(const float* q4, float qn[4],
                                         float* norm, float R[3][3]) {
  const float n = sqrtf((((q4[0] * q4[0] + q4[1] * q4[1]) + q4[2] * q4[2])
                         + q4[3] * q4[3]) + 1e-24f);
  *norm = n;
  for (int i = 0; i < 4; ++i) qn[i] = q4[i] / n;
  const float w = qn[0], x = qn[1], y = qn[2], z = qn[3];
  R[0][0] = 1.f - 2.f * (y * y + z * z);
  R[0][1] = 2.f * (x * y - w * z);
  R[0][2] = 2.f * (x * z + w * y);
  R[1][0] = 2.f * (x * y + w * z);
  R[1][1] = 1.f - 2.f * (x * x + z * z);
  R[1][2] = 2.f * (y * z - w * x);
  R[2][0] = 2.f * (x * z - w * y);
  R[2][1] = 2.f * (y * z + w * x);
  R[2][2] = 1.f - 2.f * (x * x + y * y);
}

// out_i = (v_0 M_i0 + v_1 M_i1) + v_2 M_i2 (preprocess.py _rotate)
__device__ __forceinline__ void rotate(const float M[3][3], const float v[3],
                                       float out[3]) {
  for (int i = 0; i < 3; ++i)
    out[i] = (v[0] * M[i][0] + v[1] * M[i][1]) + v[2] * M[i][2];
}

// out_j = (v_0 M_0j + v_1 M_1j) + v_2 M_2j (preprocess.py _rotate_t)
__device__ __forceinline__ void rotate_t(const float M[3][3], const float v[3],
                                         float out[3]) {
  for (int j = 0; j < 3; ++j)
    out[j] = (v[0] * M[0][j] + v[1] * M[1][j]) + v[2] * M[2][j];
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// preprocess.py _view_dirs: the unit direction camera -> mean, and the
// length it was divided by
__device__ __forceinline__ float view_dir(const float m[3], const float* cam,
                                          float dir[3]) {
  float d[3];
  for (int j = 0; j < 3; ++j) d[j] = m[j] - cam[j];
  const float n = sqrtf(((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2])
                        + 1e-24f);
  for (int j = 0; j < 3; ++j) dir[j] = d[j] / n;
  return n;
}

// ops/sh.py _basis_terms, operation for operation
__device__ __forceinline__ void sh_basis(const float dir[3], float b[16]) {
  const float x = dir[0], y = dir[1], z = dir[2];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  b[0] = SH_C0 * 1.f;
  b[1] = -SH_C1 * y;
  b[2] = SH_C1 * z;
  b[3] = -SH_C1 * x;
  b[4] = SH_C2[0] * xy;
  b[5] = SH_C2[1] * yz;
  b[6] = SH_C2[2] * ((2.f * zz - xx) - yy);
  b[7] = SH_C2[3] * xz;
  b[8] = SH_C2[4] * (xx - yy);
  b[9] = (SH_C3[0] * y) * (3.f * xx - yy);
  b[10] = (SH_C3[1] * xy) * z;
  b[11] = (SH_C3[2] * y) * ((4.f * zz - xx) - yy);
  b[12] = (SH_C3[3] * z) * ((2.f * zz - 3.f * xx) - 3.f * yy);
  b[13] = (SH_C3[4] * x) * ((4.f * zz - xx) - yy);
  b[14] = (SH_C3[5] * z) * (xx - yy);
  b[15] = (SH_C3[6] * x) * (xx - 3.f * yy);
}

// d basis_k / d dir for k = 1..15 (ops/sh.py _basis_jacobian), into
// J[k][0..2]; J[0] is 0
__device__ __forceinline__ void sh_jacobian(const float dir[3],
                                            float J[16][3]) {
  const float x = dir[0], y = dir[1], z = dir[2];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  const float c1 = SH_C1;
  const float rows[16][3] = {
      {0.f, 0.f, 0.f},
      {0.f, -c1, 0.f},
      {0.f, 0.f, c1},
      {-c1, 0.f, 0.f},
      {SH_C2[0] * y, SH_C2[0] * x, 0.f},
      {0.f, SH_C2[1] * z, SH_C2[1] * y},
      {-2.f * SH_C2[2] * x, -2.f * SH_C2[2] * y, 4.f * SH_C2[2] * z},
      {SH_C2[3] * z, 0.f, SH_C2[3] * x},
      {2.f * SH_C2[4] * x, -2.f * SH_C2[4] * y, 0.f},
      {6.f * SH_C3[0] * xy, SH_C3[0] * (3.f * xx - 3.f * yy), 0.f},
      {SH_C3[1] * yz, SH_C3[1] * xz, SH_C3[1] * xy},
      {-2.f * SH_C3[2] * xy, SH_C3[2] * ((4.f * zz - xx) - 3.f * yy),
       8.f * SH_C3[2] * yz},
      {-6.f * SH_C3[3] * xz, -6.f * SH_C3[3] * yz,
       SH_C3[3] * ((6.f * zz - 3.f * xx) - 3.f * yy)},
      {SH_C3[4] * ((4.f * zz - 3.f * xx) - yy), -2.f * SH_C3[4] * xy,
       8.f * SH_C3[4] * xz},
      {2.f * SH_C3[5] * xz, -2.f * SH_C3[5] * yz, SH_C3[5] * (xx - yy)},
      {SH_C3[6] * (3.f * xx - 3.f * yy), -6.f * SH_C3[6] * xy, 0.f}};
  for (int k = 0; k < 16; ++k)
    for (int j = 0; j < 3; ++j) J[k][j] = rows[k][j];
}

// the block's rows [first, first + n) of a [P, row] float array between
// device and shared memory, consecutive threads on consecutive words;
// shared rows are row + 1 words apart
__device__ __forceinline__ void rows_to_shared(const float* __restrict__ g,
                                               int first, int n, int row,
                                               float* s) {
  const long long base = (long long)first * row;
  for (int i = threadIdx.x; i < n * row; i += blockDim.x)
    s[(i / row) * (row + 1) + i % row] = __ldg(g + base + i);
}

__device__ __forceinline__ void rows_from_shared(const float* s, int first,
                                                 int n, int row,
                                                 float* __restrict__ g) {
  const long long base = (long long)first * row;
  for (int i = threadIdx.x; i < n * row; i += blockDim.x)
    g[base + i] = s[(i / row) * (row + 1) + i % row];
}

// the view matrix's rotation rows and translation
__device__ __forceinline__ void load_view(const float* __restrict__ viewmat,
                                          float M[3][3], float t[3]) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) M[i][j] = __ldg(viewmat + 4 * i + j);
    t[i] = __ldg(viewmat + 4 * i + 3);
  }
}

__global__ void __launch_bounds__(THREADS)
preprocess_fwd_kernel(PrepParams p, const float* __restrict__ means,
                      const float* __restrict__ scales,
                      const float* __restrict__ quats,
                      const float* __restrict__ opacity,
                      const unsigned char* __restrict__ mask,
                      const float* __restrict__ shs,
                      const float* __restrict__ viewmat,
                      const float* __restrict__ campos,
                      const float* __restrict__ sin_a,
                      const float* __restrict__ cos_a, float* __restrict__ T,
                      float* __restrict__ xy, float* __restrict__ depth,
                      float* __restrict__ normal, float* __restrict__ color,
                      float* __restrict__ radius_out,
                      int* __restrict__ rect_min, int* __restrict__ rect_max,
                      int* __restrict__ tiles,
                      unsigned char* __restrict__ valid_out,
                      unsigned char* __restrict__ clamped) {
  extern __shared__ float sh_rows[];
  const int first = blockIdx.x * THREADS;
  const int n_rows = min(THREADS, p.P - first);
  const int KC = p.K * p.C;
  if (p.n_sh > 0) {
    rows_to_shared(shs, first, n_rows, KC, sh_rows);
    __syncthreads();
  }
  const int g = first + threadIdx.x;
  if (g >= p.P) return;

  float M[3][3], t[3];
  load_view(viewmat, M, t);
  float m[3], q4[4];
  for (int j = 0; j < 3; ++j) m[j] = __ldg(means + 3 * g + j);
  for (int j = 0; j < 4; ++j) q4[j] = __ldg(quats + 4 * g + j);
  const float s0 = __ldg(scales + (long long)g * p.scale_stride);
  const float s1 = __ldg(scales + (long long)g * p.scale_stride + 1);
  const float op = __ldg(opacity + g);

  // the splat frame (preprocess.py build_transmat)
  float qn[4], qnorm, R[3][3];
  rotation(q4, qn, &qnorm, R);
  const float s0m = s0 * p.scale_modifier, s1m = s1 * p.scale_modifier;
  const float uw[3] = {R[0][0] * s0m, R[1][0] * s0m, R[2][0] * s0m};
  const float vw[3] = {R[0][1] * s1m, R[1][1] * s1m, R[2][1] * s1m};
  const float nw[3] = {R[0][2], R[1][2], R[2][2]};
  float u[3], v[3], pc[3], nc[3];
  rotate(M, uw, u);
  rotate(M, vw, v);
  rotate(M, m, pc);
  for (int i = 0; i < 3; ++i) pc[i] = pc[i] + t[i];
  rotate(M, nw, nc);
  const float flip = dot3(nc, pc) < 0.f ? 1.f : -1.f;
  for (int j = 0; j < 3; ++j) {
    T[9 * g + j] = u[j];
    T[9 * g + 3 + j] = v[j];
    T[9 * g + 6 + j] = pc[j];
    normal[3 * g + j] = nc[j] * flip;
  }

  // the centre (preprocess.py _pano_angles) and the cull
  const float x = pc[0], y = pc[1], z = pc[2];
  const bool degen = (x * x + z * z) < 1e-20f;
  const float xs = degen ? 0.f : x, zs = degen ? 1.f : z;
  const float phi = atan2f(xs, zs);
  const float theta = atan2f(sqrtf(xs * xs + zs * zs), -y);
  const float r = sqrtf(((x * x + y * y) + z * z) + 1e-24f);
  bool valid = mask[g] && r > p.near &&
               fabsf(div_scalar(theta - p.cv, p.inv_half_v)) <=
                   FRUSTUM_MARGIN &&
               fabsf(div_scalar(phi - p.ch, p.inv_half_h)) <= FRUSTUM_MARGIN;

  // the AABB of the cutoff ellipse by 12 samples (forward.cu:129-171)
  const float cutoff =
      sqrtf(fmax_(9.f + 2.f * logf(fmax_(op, 1e-30f)), 1e-6f));
  float sx_max = -INFINITY, sx_min = INFINITY;
  float sy_max = -INFINITY, sy_min = INFINITY;
#pragma unroll 4
  for (int k = 0; k < SAMPLES; ++k) {
    const float sa = __ldg(sin_a + k), ca = __ldg(cos_a + k);
    float smp[3];
    for (int j = 0; j < 3; ++j)
      smp[j] = cutoff * (sa * u[j] + ca * v[j]) + pc[j];
    const bool sdeg = (smp[0] * smp[0] + smp[2] * smp[2]) < 1e-20f;
    const float sxs = sdeg ? 0.f : smp[0], szs = sdeg ? 1.f : smp[2];
    float sphi = atan2f(sxs, szs);
    if (p.wrap_x) {
      // unwrap around the centre's phi (rintf: torch.round's half-even)
      float dphi = sphi - phi;
      dphi = dphi - p.two_pi * rintf(div_scalar(dphi, p.inv_two_pi));
      sphi = phi + dphi;
    }
    const float stheta = atan2f(sqrtf(sxs * sxs + szs * szs), -smp[1]);
    const float sxp = div_scalar((sphi - p.hmin) * p.fW, p.inv_hrange);
    const float syp = div_scalar((stheta - p.vmin) * p.fH, p.inv_vrange);
    sx_max = fmax_(sx_max, sxp);
    sx_min = fmin_(sx_min, sxp);
    sy_max = fmax_(sy_max, syp);
    sy_min = fmin_(sy_min, syp);
  }
  const float cx = div_scalar((phi - p.hmin) * p.fW, p.inv_hrange);
  const float cy = div_scalar((theta - p.vmin) * p.fH, p.inv_vrange);
  const float ex_hi = sx_max - cx, ex_lo = cx - sx_min;
  const float ey_hi = sy_max - cy, ey_lo = cy - sy_min;
  const float radius = fmax_(fmax_(ex_hi, ex_lo), fmax_(ey_hi, ey_lo));
  valid = valid && radius >= 0.3f;
  const float rad_i = ceilf(radius);

  float rx_lo = rad_i, rx_hi = rad_i, ry_lo = rad_i, ry_hi = rad_i;
  if (p.tight) {
    const float rho_eps =
        fmax_(2.f * logf(255.f * fmax_(op, 1e-30f)), 1e-6f);
    const float ratio = sqrtf(rho_eps) / cutoff * 1.10f;
    const float disk = sqrtf(div_scalar(rho_eps, 0.5f)) + 1.f;
    if (radius <= 48.f) {
      rx_lo = fmin_(rad_i, ceilf(fmax_(ratio * ex_lo, disk) + 1.f));
      rx_hi = fmin_(rad_i, ceilf(fmax_(ratio * ex_hi, disk) + 1.f));
      ry_lo = fmin_(rad_i, ceilf(fmax_(ratio * ey_lo, disk) + 1.f));
      ry_hi = fmin_(rad_i, ceilf(fmax_(ratio * ey_hi, disk) + 1.f));
    }
  }

  const int gx = p.tiles_x, gy = p.tiles_y;
  const int ry0 = clampi((int)div_scalar(cy - ry_lo, p.inv_th), 0, gy);
  const int ry1 =
      clampi((int)div_scalar(((cy + ry_hi) + p.fTH) - 1.f, p.inv_th), 0, gy);
  int rx0, rx1;
  if (p.wrap_x) {
    // preprocess.py wrap_col_rect (torch.remainder: fmod, then + W where
    // the signs differ)
    const float span = rx_lo + rx_hi;
    float a = fmodf(cx - rx_lo, p.fW), b = fmodf(cx + rx_hi, p.fW);
    if (a != 0.f && (a < 0.f) != (p.fW < 0.f)) a += p.fW;
    if (b != 0.f && (b < 0.f) != (p.fW < 0.f)) b += p.fW;
    const int col_a = clampi((int)div_scalar(a, p.inv_tw), 0, gx - 1);
    const int col_b = clampi((int)div_scalar(b, p.inv_tw), 0, gx - 1);
    int wt = (a + span) >= p.fW ? min(gx - col_a + col_b + 1, gx)
                                : col_b - col_a + 1;
    if (span >= p.fW) wt = gx;
    rx0 = col_a;
    rx1 = col_a + wt;
  } else {
    rx0 = clampi((int)div_scalar(cx - rx_lo, p.inv_tw), 0, gx);
    rx1 = clampi((int)div_scalar(((cx + rx_hi) + p.fTW) - 1.f, p.inv_tw),
                 0, gx);
  }
  const int area = (rx1 - rx0) * (ry1 - ry0);
  valid = valid && area > 0;

  xy[2 * g] = cx;
  xy[2 * g + 1] = cy;
  depth[g] = r;
  radius_out[g] = valid ? rad_i : 0.f;
  rect_min[2 * g] = rx0;
  rect_min[2 * g + 1] = ry0;
  rect_max[2 * g] = rx1;
  rect_max[2 * g + 1] = ry1;
  tiles[g] = valid ? area : 0;
  valid_out[g] = valid;

  if (p.n_sh > 0) {
    // the colour (ops/sh.py eval_sh): ((b_0 c_0 + b_1 c_1) + ...) + 0.5
    float dir[3], b[16];
    view_dir(m, campos, dir);
    sh_basis(dir, b);
    const float* row = sh_rows + threadIdx.x * (KC + 1);
    for (int c = 0; c < p.C; ++c) {
      float val = b[0] * row[c];
#pragma unroll
      for (int k = 1; k < MAX_COEFFS; ++k)
        if (k < p.n_sh) val = val + b[k] * row[k * p.C + c];
      val = val + 0.5f;
      clamped[(long long)g * p.C + c] = val < 0.f;
      color[(long long)g * p.C + c] = fmax_(val, 0.f);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
preprocess_bwd_kernel(PrepParams p, const float* __restrict__ means,
                      const float* __restrict__ scales,
                      const float* __restrict__ quats,
                      const float* __restrict__ shs,
                      const float* __restrict__ viewmat,
                      const float* __restrict__ campos,
                      const unsigned char* __restrict__ clamped,
                      const float* __restrict__ dT,
                      const float* __restrict__ dcolor,
                      float* __restrict__ dmeans, float* __restrict__ dscales,
                      float* __restrict__ dquats, float* __restrict__ dshs) {
  extern __shared__ float sh_rows[];
  const int first = blockIdx.x * THREADS;
  const int n_rows = min(THREADS, p.P - first);
  const int KC = p.K * p.C;
  const bool has_sh = shs != nullptr;
  if (has_sh) {
    rows_to_shared(shs, first, n_rows, KC, sh_rows);
    __syncthreads();
  }
  const int g = first + threadIdx.x;
  if (g < p.P) {
    float M[3][3], t[3];
    load_view(viewmat, M, t);
    float m[3], q4[4], dTu[3], dTv[3], dTp[3];
    for (int j = 0; j < 3; ++j) {
      m[j] = __ldg(means + 3 * g + j);
      dTu[j] = __ldg(dT + 9 * g + j);
      dTv[j] = __ldg(dT + 9 * g + 3 + j);
      dTp[j] = __ldg(dT + 9 * g + 6 + j);
    }
    for (int j = 0; j < 4; ++j) q4[j] = __ldg(quats + 4 * g + j);
    const float s0m = __ldg(scales + (long long)g * p.scale_stride) *
                      p.scale_modifier;
    const float s1m = __ldg(scales + (long long)g * p.scale_stride + 1) *
                      p.scale_modifier;
    float qn[4], qnorm, R[3][3];
    rotation(q4, qn, &qnorm, R);

    // T's rows back to world space (preprocess_backward_reference)
    float du[3], dv[3], dm[3];
    rotate_t(M, dTu, du);
    rotate_t(M, dTv, dv);
    rotate_t(M, dTp, dm);
    const float c0[3] = {R[0][0], R[1][0], R[2][0]};
    const float c1[3] = {R[0][1], R[1][1], R[2][1]};
    float* ds = dscales + (long long)g * p.scale_cols;
    ds[0] = dot3(du, c0) * p.scale_modifier;
    ds[1] = dot3(dv, c1) * p.scale_modifier;
    for (int j = 2; j < p.scale_cols; ++j) ds[j] = 0.f;

    // the rotation's first two columns back to the normalised quaternion
    float g0[3], g1[3];
    for (int j = 0; j < 3; ++j) {
      g0[j] = du[j] * s0m;
      g1[j] = dv[j] * s1m;
    }
    const float w = qn[0], x = qn[1], y = qn[2], z = qn[3];
    const float dq[4] = {
        2.f * (z * g0[1] - y * g0[2] - z * g1[0] + x * g1[2]),
        2.f * (y * g0[1] + z * g0[2] + y * g1[0] - 2.f * x * g1[1] +
               w * g1[2]),
        2.f * (-2.f * y * g0[0] + x * g0[1] - w * g0[2] + x * g1[0] +
               z * g1[2]),
        2.f * (-2.f * z * g0[0] + w * g0[1] + x * g0[2] - w * g1[0] -
               2.f * z * g1[1] + y * g1[2])};
    // and through the normalisation q / sqrt(|q|^2 + 1e-24)
    const float qd = ((qn[0] * dq[0] + qn[1] * dq[1]) + qn[2] * dq[2]) +
                     qn[3] * dq[3];
    for (int j = 0; j < 4; ++j) dquats[4 * g + j] = (dq[j] - qn[j] * qd) /
                                                    qnorm;

    if (has_sh) {
      float dir[3], b[16], J[16][3];
      const float dn = view_dir(m, campos, dir);
      sh_basis(dir, b);
      sh_jacobian(dir, J);
      float* row = sh_rows + threadIdx.x * (KC + 1);
      float ddir[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < MAX_COEFFS; ++k) {
        if (k >= p.K) break;
        float gk = 0.f;
        for (int c = 0; c < p.C; ++c) {
          const long long i = (long long)g * p.C + c;
          const float dvc = clamped[i] ? 0.f : __ldg(dcolor + i);
          const float sv = row[k * p.C + c];
          gk = gk + sv * dvc;
          // d SH over the coefficient it read (same shared word)
          row[k * p.C + c] = k < p.n_sh ? b[k] * dvc : 0.f;
        }
        if (k < p.n_sh)
          for (int j = 0; j < 3; ++j) ddir[j] = ddir[j] + gk * J[k][j];
      }
      // through the view direction's normalisation
      const float dd = dot3(dir, ddir);
      for (int j = 0; j < 3; ++j) dm[j] = dm[j] + (ddir[j] - dir[j] * dd) /
                                                  dn;
    }
    for (int j = 0; j < 3; ++j) dmeans[3 * g + j] = dm[j];
  }
  if (has_sh) {
    __syncthreads();
    rows_from_shared(sh_rows, first, n_rows, KC, dshs);
  }
}

int blocks_of(int P) { return (P + THREADS - 1) / THREADS; }

cudaError_t shared_bytes(const void* kernel, const PrepParams& p,
                         size_t* bytes) {
  *bytes = p.K > 0 ? (size_t)THREADS * (p.K * p.C + 1) * sizeof(float) : 0;
  if (*bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*bytes);
  return cudaSuccess;
}

bool params_ok(const PrepParams& p) {
  return p.P > 0 && p.K >= 0 && p.K <= MAX_COEFFS && p.C >= 0 &&
         p.C <= MAX_CHANNELS && p.n_sh >= 0 && p.n_sh <= p.K &&
         p.scale_cols >= 2 && p.scale_stride >= 2 && p.tiles_x > 0 &&
         p.tiles_y > 0;
}

}  // namespace

// The forward on `stream`; returns cudaGetLastError() as an int (0 =
// cudaSuccess). All pointers are device pointers to contiguous rows:
// means [P, 3], scales [P, >= 2] with rows scale_stride floats apart,
// quats [P, 4], opacity [P], mask [P] bool, shs [P, K, C] (null with the
// colours given, n_sh = 0), viewmat [4, 4], campos [3], sin_a and cos_a
// [12]; outputs T [P, 3, 3], xy [P, 2], depth [P], normal [P, 3], color
// [P, C] (null without SH), radius [P], rect_min and rect_max [P, 2]
// int32, tiles [P] int32, valid [P] bool, clamped [P, C] bool (null
// without SH).
extern "C" int gslidar_preprocess_fwd(
    int device, const PrepParams* params, const float* means,
    const float* scales, const float* quats, const float* opacity,
    const unsigned char* mask, const float* shs, const float* viewmat,
    const float* campos, const float* sin_a, const float* cos_a, float* T,
    float* xy, float* depth, float* normal, float* color, float* radius,
    int* rect_min, int* rect_max, int* tiles, unsigned char* valid,
    unsigned char* clamped, void* stream) {
  PrepParams p = *params;
  if (!params_ok(p) || (p.n_sh > 0 && (!shs || !color || !clamped)))
    return (int)cudaErrorInvalidValue;
  if (!shs) p.n_sh = 0, p.K = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  size_t smem;
  err = shared_bytes((const void*)preprocess_fwd_kernel, p, &smem);
  if (err != cudaSuccess) return (int)err;
  preprocess_fwd_kernel<<<blocks_of(p.P), THREADS, smem,
                          (cudaStream_t)stream>>>(
      p, means, scales, quats, opacity, mask, shs, viewmat, campos, sin_a,
      cos_a, T, xy, depth, normal, color, radius, rect_min, rect_max, tiles,
      valid, clamped);
  return (int)cudaGetLastError();
}

// The backward on `stream`; returns cudaGetLastError() as an int. Inputs
// as the forward's, with clamped [P, C] (the forward's), dT [P, 3, 3] and
// dcolor [P, C] (both null-able with shs null); outputs dmeans [P, 3],
// dscales [P, scale_cols] (columns 2.. zero), dquats [P, 4] and dshs
// [P, K, C] (bands above n_sh zero; null without SH).
extern "C" int gslidar_preprocess_bwd(
    int device, const PrepParams* params, const float* means,
    const float* scales, const float* quats, const float* shs,
    const float* viewmat, const float* campos, const unsigned char* clamped,
    const float* dT, const float* dcolor, float* dmeans, float* dscales,
    float* dquats, float* dshs, void* stream) {
  PrepParams p = *params;
  if (!params_ok(p) || (shs && (!clamped || !dcolor || !dshs)))
    return (int)cudaErrorInvalidValue;
  if (!shs) p.n_sh = 0, p.K = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  size_t smem;
  err = shared_bytes((const void*)preprocess_bwd_kernel, p, &smem);
  if (err != cudaSuccess) return (int)err;
  preprocess_bwd_kernel<<<blocks_of(p.P), THREADS, smem,
                          (cudaStream_t)stream>>>(
      p, means, scales, quats, shs, viewmat, campos, clamped, dT, dcolor,
      dmeans, dscales, dquats, dshs);
  return (int)cudaGetLastError();
}
