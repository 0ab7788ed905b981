// Forward compositing kernel for Hopper (sm_90a).
//
// Replaces: gslidar_tpu/raster/pallas_fwd.py::_kernel (launched by
// run_forward), the Pallas TPU kernel that alpha-composites the
// (tile, depth)-sorted splat instances of a panorama front to back.
//
// What bounds it on this card: per-pixel FP32 and SFU work, not memory.
// Every (instance, pixel) pair costs ~40 FP32 operations, one IEEE
// reciprocal and one expf, and each pixel's transmittance is a sequential
// dependency through the tile's instance list. The bytes are small: one
// 72-byte payload row per instance (the 9 T columns, opacity, C colors,
// S features), read once per tile.
//
// What the design does about it: the shape of the CUDA original
// (forward.cu:292-505). One CTA per tile and one thread per pixel. The
// CTA stages its sorted instances through shared memory in batches of
// blockDim, and each loading thread derives that instance's per-instance
// terms once (the three cross products of the linear ray-splat form, the
// splat centre from the p_cam triple with atan2f and the seam wrap around
// the tile centre, the flip-signed normal), so the per-pixel loop reads
// broadcast shared memory and does only the per-pixel arithmetic. A
// __syncthreads_count vote ends the walk once no pixel of the tile has
// T >= 1e-4. None of the TPU layout is carried over (prefix products by
// sublane rolls, MXU channel sums, SMEM saturation flags, bf16 payload
// words, the polynomial atan2).
//
// Semantics kept from the Pallas kernel:
//   * T decays for every `ok` instance, including those the 1e-4 floor
//     rejects (pallas_fwd.py:441-449); contributions need
//     T_before * (1 - alpha) >= 1e-4. The walk stops at batch granularity
//     when the vote trips, so final T may differ from the Pallas kernel's
//     (which stops at chunk granularity) by up to 1e-4.
//   * the median is the last accepted instance with T_before > 0.5, with
//     its 1-based position within the tile list (pallas_fwd.py:505-516);
//   * n_contrib is the last accepted position (compute_contrib);
//   * the distortion running moments (compute_distortion,
//     pallas_fwd.py:477-497);
//   * misc slots as pallas_fwd.py:545-552, except slot 5, which holds the
//     number of instances this CTA walked (where the backward stops).
//
// The staging and the per-pixel intersection are in composite_common.cuh,
// which the backward kernel (composite_bwd.cu) shares, so that it walks
// every pixel exactly as this kernel did.
//
// Built without --use_fast_math and with --fmad=false: the per-instance
// and per-pixel arithmetic is then the same IEEE sequence, operation for
// operation, as the plain PyTorch version in raster/composite_fwd.py, so
// the threshold decisions (alpha >= 1/255, the depth window) agree bit for
// bit and only the transmittance products and the channel sums differ in
// rounding order.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace gslidar;

// MAX_THREADS bounds the tile's pixel count: 256 (16x16 tiles) lets the
// compiler keep every accumulator in registers; 1024 caps it at 64.
template <int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
composite_fwd_kernel(const float* __restrict__ rows, int D,
                     const int* __restrict__ tile_starts, int tiles_x,
                     int tile_h, int tile_w, int H, int W, int C, int S,
                     Params prm, int compute_distortion, int compute_contrib,
                     float* __restrict__ color, float* __restrict__ feat,
                     float* __restrict__ depth, float* __restrict__ misc) {
  extern __shared__ float smem[];
  const int B = blockDim.x;
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int px = tx * tile_w + tid % tile_w;
  const int py = ty * tile_h + tid / tile_w;
  const bool inside = px < W && py < H;
  const int NB = C + S;

  const float fW = (float)W;
  const float fH = (float)H;
  const Ray ray = pixel_ray(px, py, W, H, prm);
  const float tcx = (float)(tx * tile_w) + 0.5f * (float)(tile_w - 1);

  float T = inside ? 1.0f : 0.0f;
  float acc[MAX_BLEND];
#pragma unroll
  for (int c = 0; c < MAX_BLEND; ++c) acc[c] = 0.0f;
  float an1 = 0.f, an2 = 0.f, an3 = 0.f;
  float wsum = 0.f, dsum = 0.f, d2sum = 0.f;
  float dist = 0.f, M1 = 0.f, M2 = 0.f;
  float med_d = 0.f, med_pos = 0.f, n_contrib = 0.f;
  const float m_scale = prm.far / (prm.far - prm.near);

  const int start = tile_starts[tile];
  const int end = tile_starts[tile + 1];
  int walked = 0;

  for (int base = start; base < end; base += B) {
    // block-wide vote (also the barrier before the staging area is
    // overwritten): stop once no pixel of the tile can take a contribution
    if (__syncthreads_count(T >= T_STOP) == 0) break;

    const int k = base + tid;
    if (k < end) {
      stage_instance(rows + (size_t)k * D, smem + tid, B, NB, fW, fH, tcx,
                     prm);
    }
    __syncthreads();

    const int n = min(B, end - base);
    for (int j = 0; j < n; ++j) {
      const float* s = smem + j;
      const Hit h = intersect(s, B, ray, prm);
      if (!h.ok) continue;
      const float alpha = h.alpha;
      const float d = h.d;
      const float T_before = T;
      const float one_m = 1.0f - alpha;
      T = T_before * one_m;
      if (!(T >= T_STOP)) continue;      // floor: T decays, no contribution
      const float w = alpha * T_before;
      const float pos1 = (float)(base + j - start + 1);
#pragma unroll
      for (int c = 0; c < MAX_BLEND; ++c)
        if (c < NB) acc[c] += w * s[(F_BLEND + c) * B];
      an1 += w * s[F_N1 * B];
      an2 += w * s[F_N2 * B];
      an3 += w * s[F_N3 * B];
      wsum += w;
      const float dw = d * w;
      dsum += dw;
      d2sum += dw * d;
      if (compute_distortion) {
        const float m = m_scale * (1.0f - prm.near / d);
        const float mw = m * w;
        const float m2w = m * m * w;
        const float A_b = 1.0f - T_before;
        dist += (m * m * A_b + M2 - 2.0f * m * M1) * w;
        M1 += mw;
        M2 += m2w;
      }
      if (T_before > 0.5f) {
        med_d = d;
        med_pos = pos1;
      }
      if (compute_contrib) n_contrib = pos1;
    }
    walked += n;
  }

  if (!inside) return;
  const size_t HW = (size_t)H * W;
  const size_t o = (size_t)py * W + px;
  for (int c = 0; c < C; ++c) color[c * HW + o] = acc[c];
  for (int c = 0; c < S; ++c) feat[c * HW + o] = acc[C + c];
  feat[(S + 0) * HW + o] = an1;
  feat[(S + 1) * HW + o] = an2;
  feat[(S + 2) * HW + o] = an3;
  depth[0 * HW + o] = dsum;
  depth[1 * HW + o] = med_d;
  depth[2 * HW + o] = dist;
  depth[3 * HW + o] = d2sum;
  misc[0 * HW + o] = T;
  misc[1 * HW + o] = n_contrib;
  misc[2 * HW + o] = med_pos;
  misc[3 * HW + o] = M1;
  misc[4 * HW + o] = M2;
  misc[5 * HW + o] = (float)walked;
  misc[6 * HW + o] = wsum;
  misc[7 * HW + o] = 0.0f;
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an
// int (0 = cudaSuccess). All pointers are device pointers; outputs are
// [C,H,W], [S+3,H,W], [4,H,W] and [8,H,W] float32, rows is [N, D] float32
// row-major with D = 10 + C + S, tile_starts is [n_tiles + 1] int32.
extern "C" int gslidar_composite_fwd(
    int device, const float* rows, int D, const int* tile_starts,
    int n_tiles, int tiles_x, int tile_h, int tile_w, int H, int W, int C,
    int S, float near, float far, float vmin, float vmax, float hmin,
    float hmax, float wrap_w, float wrap_inv, int compute_distortion,
    int compute_contrib, float* color, float* feat, float* depth,
    float* misc, void* stream) {
  if (C < 0 || S < 0 || C + S > MAX_BLEND || D != 10 + C + S ||
      tile_h * tile_w > 1024 || n_tiles <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = tile_h * tile_w;
  const size_t smem = (size_t)(F_BLEND + C + S) * threads * sizeof(float);
  auto kernel = threads <= 256 ? composite_fwd_kernel<256>
                               : composite_fwd_kernel<1024>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const Params prm{near, far, vmin, vmax, hmin, hmax, wrap_w, wrap_inv};
  kernel<<<n_tiles, threads, smem, (cudaStream_t)stream>>>(
      rows, D, tile_starts, tiles_x, tile_h, tile_w, H, W, C, S, prm,
      compute_distortion, compute_contrib, color, feat, depth, misc);
  return (int)cudaGetLastError();
}
