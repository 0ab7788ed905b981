// Forward compositing kernels for Hopper (sm_90a).
//
// Replaces: gslidar_tpu/raster/pallas_fwd.py::_kernel (launched by
// run_forward), the Pallas TPU kernel that alpha-composites the
// (tile, depth)-sorted splat instances of a panorama front to back.
//
// What bounds it on this card: per-pixel FP32 and SFU work, not memory.
// Every (instance, pixel) pair costs ~40 FP32 operations, one IEEE
// reciprocal and one expf. The bytes are small: one 72-byte payload row
// per instance (the 9 T columns, opacity, C colors, S features). What
// held it back in practice was the serial walk of each tile's list on one
// CTA: the tiles' lists are very uneven (the heaviest tile of a 360-degree
// view of 1M gaussians walks 67,297 instances against a mean of 4,060),
// so one CTA per tile ran as long as the heaviest tile, on a few SMs.
//
// What the design does about it: no CTA walks more than one staging batch
// (tile pixels instances, 256 for 16x16 tiles), so the heaviest tile's
// batches spread over the whole card. It rests on one property: T decays
// for every `ok` instance whatever the 1e-4 floor decides, so a batch's
// product P_b = prod (1 - alpha) over its `ok` instances does not depend
// on the T it starts from, and T_start(b + 1) = T_start(b) * P_b. Four
// passes, each a kernel below, launched in order on one stream:
//
//   A. product: one CTA per (tile, batch) stages the batch (geometry only)
//      and each thread forms its pixel's P_b, serially from 1.0;
//   B. scan: one CTA per tile runs T_start(0) = 1 inside the image (0 in
//      the tile padding), T_start(b + 1) = T_start(b) * P_b in batch
//      order, and ends the walk at the first batch where no pixel has
//      T_start >= 1e-4 (the block vote of the serial walk); it writes
//      T_start of every batch it reaches, the tile's walked batch count,
//      final T and the instances walked;
//   C. blend: one CTA per walked (tile, batch) walks its batch from
//      T_start(b) with the serial walk's arithmetic (T = T_before * (1 -
//      alpha), the same floor test, w, median and contrib choices) and
//      writes the batch's local sums, started from zero: the C + S
//      channels, the three normals, sum w, sum w*d, sum w*d^2, the local
//      M1, M2 and distortion, and the batch's last median candidate and
//      last accepted position;
//   D. merge: one CTA per tile adds the local sums in batch order. The
//      running state before batch b is b's checkpoint; the distortion
//      merges in closed form, dist += dist_b + M2 * sum w_b - 2 M1 M1_b
//      (M1, M2 the running moments before b); the median is the last
//      batch's candidate and n_contrib the largest position.
//
// A and B run in rounds over windows of batches, [0, e_1), [e_1, e_2),
// ..., [e_k, end of list) (the caller's ends, raster/composite_fwd.py
// WINDOW_ENDS): a round's products are formed only for the tiles whose
// walk reached the window, so a tile's products stop at the end of the
// window where its walk ends, not at the end of its list. The grids are
// sized on the host with no sync: a window's product pass takes tiles x
// window length CTAs, the last window's and C's take N / tile pixels +
// tiles CTAs (a bound on the batches), each finding its tile by a binary
// search over chunk_off; CTAs past a tile's list or walk return at once.
// Scratch (P, T_start, the walked counts, the local sums) is allocated by
// the caller. No sum uses atomics and every order is fixed, so the outputs
// are bitwise repeatable.
//
// Inside the passes: A and C stage a batch instance-major, so that a
// pixel reads an instance's intersection fields as four 16-byte broadcast
// loads, not the 13 4-byte ones of the field-major layout the backward
// keeps. A unrolls its walk, since only P carries from one instance to
// the next. C writes each pixel's local sums as one row, which D copies
// into a ring in shared memory (cp.async) two batches ahead of the one it
// merges.
//
// Checkpoints (training): the backward kernel (composite_bwd.cu) starts
// each of its chunks from the state before the batch (composite_common.cuh):
// the merge stores it for every batch it reaches, and for the batch where
// the walk stopped (the totals), 9 + C coalesced floats per pixel and
// batch. T there is T_start(b), the T pass C starts the batch from, so the
// backward repeats every `ok`, `accept` and median decision bit for bit.
// The stores are a template parameter of the merge: with no buffer
// (serving) the launch takes an instance that has neither the stores nor
// their branch, and the outputs are the same bit for bit either way.
//
// Semantics kept from the Pallas kernel:
//   * T decays for every `ok` instance, including those the 1e-4 floor
//     rejects (pallas_fwd.py:441-449); contributions need
//     T_before * (1 - alpha) >= 1e-4. The walk stops at batch granularity
//     when the vote trips, so final T may differ from the Pallas kernel's
//     (which stops at chunk granularity) by up to 1e-4. T carries across
//     batches as T_carry * (the chunk's product) (pallas_fwd.py:445-449);
//   * the median is the last accepted instance with T_before > 0.5, with
//     its 1-based position within the tile list (pallas_fwd.py:505-516);
//   * n_contrib is the last accepted position (compute_contrib);
//   * the distortion running moments (compute_distortion,
//     pallas_fwd.py:477-497);
//   * misc slots as pallas_fwd.py:545-552, except slot 5, which holds the
//     number of instances the tile walked (where the backward stops).
//
// The staging and the per-pixel intersection are in composite_common.cuh,
// which the backward kernel shares, so that it walks every pixel exactly
// as pass C did and pass A's `ok` and alpha are pass C's.
//
// Built without --use_fast_math and with --fmad=false: the per-instance
// and per-pixel arithmetic is then the same IEEE sequence, operation for
// operation, as the plain PyTorch version in raster/composite_fwd.py, so
// the threshold decisions (alpha >= 1/255, the depth window) agree bit for
// bit, the batch products and the scan are the plain version's, and only
// the products inside a batch and the channel sums differ in rounding
// order.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace gslidar;

// A batch's local sums, pixel-major: [B][row_stride(PART_BASE + NB)]
// floats, each pixel's row these, then its NB = C + S channel sums from
// P_CHANNELS (and padding to a multiple of 4 floats, so that the merge
// copies and reads a row as 16-byte units, at constant offsets).
enum Part {
  P_N1, P_N2, P_N3,          // normal sums
  P_WSUM, P_DSUM, P_D2SUM,   // sum w, sum w*d, sum w*d^2
  P_M1, P_M2, P_DIST,        // local distortion moments and distortion
  P_MED_D, P_MED_POS,        // last median candidate (position 0: none)
  P_CONTRIB,                 // last accepted position (0: none)
  PART_BASE,
  P_CHANNELS = PART_BASE
};
// the longest row: PART_BASE + MAX_BLEND floats
constexpr int MAX_ROW = PART_BASE + MAX_BLEND;
static_assert(MAX_ROW % 4 == 0, "a row is whole 16-byte units");

// batches whose products the scan loads ahead of its vote
constexpr int SCAN_AHEAD = 8;

// The product and blend passes stage a batch instance-major, one row of
// `stride` floats per instance (a multiple of 4), so that each pixel reads
// an instance's first 16 fields, all that intersect() reads and the first
// two normal components, as four 16-byte broadcast loads instead of
// sixteen 4-byte ones (the backward keeps the field-major layout).
constexpr int HEAD = 16;
static_assert(F_OPA < HEAD && F_N2 < HEAD && F_N3 == HEAD,
              "the head of a staged row");

__host__ __device__ constexpr int row_stride(int fields) {
  return (fields + 3) & ~3;
}

struct Head {
  float f[HEAD];
};

__device__ __forceinline__ Head load_head(const float* row) {
  const float4* q = reinterpret_cast<const float4*>(row);
  const float4 a = q[0], b = q[1], c = q[2], d = q[3];
  return Head{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w,
               d.x, d.y, d.z, d.w}};
}

struct Tile {
  int tile, ty, tx, px, py;
  bool inside;
};

__device__ __forceinline__ Tile tile_pixel(int tile, int tiles_x, int tile_h,
                                           int tile_w, int H, int W) {
  Tile t;
  t.tile = tile;
  t.ty = tile / tiles_x;
  t.tx = tile - t.ty * tiles_x;
  t.px = t.tx * tile_w + threadIdx.x % tile_w;
  t.py = t.ty * tile_h + threadIdx.x / tile_w;
  t.inside = t.px < W && t.py < H;
  return t;
}

// the end of the last window of batches: the end of every list
constexpr int NO_END = 0x7fffffff;

// ------------------------------------------------------------ A. product
// One CTA per (tile, batch) of the window [lo, ...): over a grid of
// (tiles, window length) CTAs, or, for the last window (`last`), over one
// CTA per possible batch, each finding its tile by a binary search.
template <int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
fwd_product_kernel(const float* __restrict__ rows, int D,
                   const int* __restrict__ tile_starts,
                   const int* __restrict__ chunk_off,
                   const int* __restrict__ walked, int n_tiles, int lo,
                   int last, int tiles_x, int tile_h, int tile_w, int H,
                   int W, Params prm, float* __restrict__ prod) {
  extern __shared__ float4 stage4[];
  float* smem = reinterpret_cast<float*>(stage4);   // [B][HEAD]
  const int B = blockDim.x;
  const int tid = threadIdx.x;
  int tile, b, chunk;
  if (last) {
    chunk = blockIdx.x;
    if (chunk >= __ldg(chunk_off + n_tiles)) return;
    tile = chunk_tile(chunk_off, n_tiles, chunk);
    b = chunk - chunk_off[tile];
    if (b < lo) return;
  } else {
    tile = blockIdx.x;
    b = lo + blockIdx.y;
    chunk = chunk_off[tile] + b;
    if (chunk >= chunk_off[tile + 1]) return;   // past the tile's list
  }
  if (lo > 0 && walked[tile] < lo) return;      // its walk has ended
  const int start = tile_starts[tile];
  const int base = start + b * B;
  const int n = min(B, tile_starts[tile + 1] - base);
  const Tile t = tile_pixel(tile, tiles_x, tile_h, tile_w, H, W);
  const Ray ray = pixel_ray(t.px, t.py, W, H, prm);
  const float tcx = (float)(t.tx * tile_w) + 0.5f * (float)(tile_w - 1);

  if (tid < n)
    stage_instance<false>(rows + (size_t)(base + tid) * D,
                          smem + tid * HEAD, 1, 0, (float)W, (float)H, tcx,
                          prm);
  __syncthreads();
  // only P is carried from one instance to the next: unrolled, the
  // intersections of several instances are in flight at once
  float P = 1.0f;
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    const Head f = load_head(smem + j * HEAD);
    const Hit h = intersect(f.f, 1, ray, prm);
    if (h.ok) P = P * (1.0f - h.alpha);
  }
  prod[(size_t)chunk * B + tid] = P;
}

// --------------------------------------------------------------- B. scan
// One CTA per tile runs the scan over the window [lo, hi). It starts from
// T_start(lo), 1 or 0 when lo = 0, else left by the round before, and
// leaves walked[tile] = the batch where the vote stopped the walk, or the
// tile's batch count where its list ended (both end the walk: final T
// and the instances walked are written), or hi, with T_start(hi), where
// the walk goes on into the next window.
template <int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
fwd_scan_kernel(const int* __restrict__ tile_starts,
                const int* __restrict__ chunk_off,
                const float* __restrict__ prod, int lo, int hi, int tiles_x,
                int tile_h, int tile_w, int H, int W,
                float* __restrict__ T_start, int* __restrict__ walked,
                float* __restrict__ misc) {
  const int B = blockDim.x;
  const int tid = threadIdx.x;
  const Tile t = tile_pixel(blockIdx.x, tiles_x, tile_h, tile_w, H, W);
  const int count = tile_starts[t.tile + 1] - tile_starts[t.tile];
  const int n_b = (count + B - 1) / B;
  const size_t c0 = (size_t)chunk_off[t.tile];
  if (lo > 0 && (lo >= n_b || walked[t.tile] < lo)) return;

  float T = lo == 0 ? (t.inside ? 1.0f : 0.0f) : T_start[(c0 + lo) * B + tid];
  const int stop = min(hi, n_b);
  int nw = stop;                          // where this window leaves the walk
  for (int b0 = lo; b0 < stop && nw == stop; b0 += SCAN_AHEAD) {
    float p[SCAN_AHEAD];
#pragma unroll
    for (int i = 0; i < SCAN_AHEAD; ++i)
      p[i] = b0 + i < stop ? __ldg(prod + (c0 + b0 + i) * B + tid) : 1.0f;
#pragma unroll
    for (int i = 0; i < SCAN_AHEAD; ++i) {
      const int b = b0 + i;
      if (b >= stop) break;
      T_start[(c0 + b) * B + tid] = T;
      // the block vote: walk batch b while some pixel has T >= T_STOP
      if (__syncthreads_count(T >= T_STOP) == 0) {
        nw = b;
        break;
      }
      T = T * p[i];
    }
  }
  if (tid == 0) walked[t.tile] = nw;
  if (nw == hi && hi < n_b) {             // the walk goes on
    T_start[(c0 + hi) * B + tid] = T;
    return;
  }
  if (!t.inside) return;
  const size_t HW = (size_t)H * W;
  const size_t o = (size_t)t.py * W + t.px;
  misc[0 * HW + o] = T;
  misc[5 * HW + o] = (float)min(nw * B, count);
}

// -------------------------------------------------------------- C. blend
template <int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
fwd_blend_kernel(const float* __restrict__ rows, int D,
                 const int* __restrict__ tile_starts,
                 const int* __restrict__ chunk_off,
                 const int* __restrict__ walked,
                 const float* __restrict__ T_start, int n_tiles, int tiles_x,
                 int tile_h, int tile_w, int H, int W, int C, int S,
                 Params prm, int compute_distortion, int compute_contrib,
                 float* __restrict__ part) {
  extern __shared__ float4 stage4[];
  float* smem = reinterpret_cast<float*>(stage4);   // [B][stride]
  const int B = blockDim.x;
  const int tid = threadIdx.x;
  const int chunk = blockIdx.x;
  if (chunk >= __ldg(chunk_off + n_tiles)) return;
  const int tile = chunk_tile(chunk_off, n_tiles, chunk);
  const int b = chunk - chunk_off[tile];
  if (b >= walked[tile]) return;          // the scan stopped before it
  const int start = tile_starts[tile];
  const int base = start + b * B;
  const int n = min(B, tile_starts[tile + 1] - base);
  const int NB = C + S;
  const Tile t = tile_pixel(tile, tiles_x, tile_h, tile_w, H, W);
  const Ray ray = pixel_ray(t.px, t.py, W, H, prm);
  const float tcx = (float)(t.tx * tile_w) + 0.5f * (float)(tile_w - 1);
  const float m_scale = prm.far / (prm.far - prm.near);
  const int stride = row_stride(F_BLEND + NB);

  if (tid < n)
    stage_instance(rows + (size_t)(base + tid) * D, smem + tid * stride, 1,
                   NB, (float)W, (float)H, tcx, prm);
  __syncthreads();

  float T = T_start[(size_t)chunk * B + tid];
  float acc[MAX_BLEND];
#pragma unroll
  for (int c = 0; c < MAX_BLEND; ++c) acc[c] = 0.0f;
  float an1 = 0.f, an2 = 0.f, an3 = 0.f;
  float wsum = 0.f, dsum = 0.f, d2sum = 0.f;
  float dist = 0.f, M1 = 0.f, M2 = 0.f;
  float med_d = 0.f, med_pos = 0.f, n_contrib = 0.f;
  for (int j = 0; j < n; ++j) {
    const float* s = smem + j * stride;
    const Head f = load_head(s);
    const Hit h = intersect(f.f, 1, ray, prm);
    if (!h.ok) continue;
    const float alpha = h.alpha;
    const float d = h.d;
    const float T_before = T;
    const float one_m = 1.0f - alpha;
    T = T_before * one_m;
    if (!(T >= T_STOP)) continue;        // floor: T decays, no contribution
    const float w = alpha * T_before;
    const float pos1 = (float)(base + j - start + 1);
#pragma unroll
    for (int c = 0; c < MAX_BLEND; ++c)
      if (c < NB) acc[c] += w * s[F_BLEND + c];
    an1 += w * f.f[F_N1];
    an2 += w * f.f[F_N2];
    an3 += w * s[F_N3];
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

  // this pixel's row of the batch's sums
  float* o = part + ((size_t)chunk * B + tid) * row_stride(PART_BASE + NB);
#pragma unroll
  for (int c = 0; c < MAX_BLEND; ++c)
    if (c < NB) o[P_CHANNELS + c] = acc[c];
  o[P_N1] = an1;
  o[P_N2] = an2;
  o[P_N3] = an3;
  o[P_WSUM] = wsum;
  o[P_DSUM] = dsum;
  o[P_D2SUM] = d2sum;
  o[P_M1] = M1;
  o[P_M2] = M2;
  o[P_DIST] = dist;
  o[P_MED_D] = med_d;
  o[P_MED_POS] = med_pos;
  o[P_CONTRIB] = n_contrib;
}

// -------------------------------------------------------------- D. merge
// One pixel's running state over the batches merged so far.
struct Running {
  float acc[MAX_BLEND];
  float an1, an2, an3, wsum, dsum, d2sum, M1, M2, dist, med_d, med_pos,
      n_contrib;
};

// Stores the checkpoint of batch `chunk` (the state before it) for this
// pixel: T, the C color sums, the normal and depth sums, sum w, M1, M2.
__device__ __forceinline__ void store_checkpoint(float* __restrict__ ckpt,
                                                 size_t chunk, int B, int C,
                                                 float T, const Running& r) {
  float* ck = ckpt + chunk * (CKPT_BASE + C) * B + threadIdx.x;
  ck[CK_T * B] = T;
#pragma unroll
  for (int c = 0; c < MAX_BLEND; ++c)
    if (c < C) ck[(CK_COLOR + c) * B] = r.acc[c];
  float* cn = ck + C * B;                // the fields after the C colors
  cn[CK_N1 * B] = r.an1;
  cn[CK_N2 * B] = r.an2;
  cn[CK_N3 * B] = r.an3;
  cn[CK_DSUM * B] = r.dsum;
  cn[CK_D2SUM * B] = r.d2sum;
  cn[CK_WSUM * B] = r.wsum;
  cn[CK_M1 * B] = r.M1;
  cn[CK_M2 * B] = r.M2;
}

// Adds one batch's sums (a pixel's row, read from shared memory as
// 16-byte units; npp floats) to the state.
__device__ __forceinline__ void merge(Running& r, const float* row, int npp,
                                      int NB) {
  float x[MAX_ROW];
  const float4* q = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i = 0; i < MAX_ROW / 4; ++i) {
    const float4 v = 4 * i < npp ? q[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    x[4 * i] = v.x;
    x[4 * i + 1] = v.y;
    x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
#pragma unroll
  for (int c = 0; c < MAX_BLEND; ++c)
    if (c < NB) r.acc[c] += x[P_CHANNELS + c];
  r.an1 += x[P_N1];
  r.an2 += x[P_N2];
  r.an3 += x[P_N3];
  const float wl = x[P_WSUM];
  const float m1l = x[P_M1];
  r.dist += x[P_DIST] + r.M2 * wl - 2.0f * r.M1 * m1l;
  r.wsum += wl;
  r.dsum += x[P_DSUM];
  r.d2sum += x[P_D2SUM];
  r.M1 += m1l;
  r.M2 += x[P_M2];
  const float mp = x[P_MED_POS];
  if (mp > 0.0f) {
    r.med_d = x[P_MED_D];
    r.med_pos = mp;
  }
  r.n_contrib = fmaxf(r.n_contrib, x[P_CONTRIB]);
}

// Asynchronous copies from device to shared memory (cp.async), in groups
// that complete in order: wait_groups<N>() waits until at most N of this
// thread's groups are in flight.
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One CTA per tile. Each thread copies its pixel's rows of sums of the
// next AHEAD - 1 batches (16-byte units) and their T_start into its own
// slots of a ring in shared memory with cp.async, so the serial merge
// waits for a load once per AHEAD batches, not once per batch; no thread
// reads another's slots, so the ring needs no barrier.
template <int MAX_THREADS, bool CKPT, int AHEAD>
__global__ void __launch_bounds__(MAX_THREADS)
fwd_merge_kernel(const int* __restrict__ tile_starts,
                 const int* __restrict__ chunk_off,
                 const int* __restrict__ walked,
                 const float* __restrict__ T_start,
                 const float* __restrict__ part, int tiles_x, int tile_h,
                 int tile_w, int H, int W, int C, int S,
                 float* __restrict__ ckpt, float* __restrict__ color,
                 float* __restrict__ feat, float* __restrict__ depth,
                 float* __restrict__ misc) {
  extern __shared__ float4 ring4[];      // [AHEAD][B][npp], [AHEAD][B]
  const int B = blockDim.x;
  const int tid = threadIdx.x;
  const int NB = C + S;
  const int npp = row_stride(PART_BASE + NB);
  float* ring = reinterpret_cast<float*>(ring4);
  float* ring_T = ring + (size_t)AHEAD * B * npp;
  const Tile t = tile_pixel(blockIdx.x, tiles_x, tile_h, tile_w, H, W);
  const int count = tile_starts[t.tile + 1] - tile_starts[t.tile];
  const int n_b = (count + B - 1) / B;
  const int nw = walked[t.tile];
  const size_t c0 = (size_t)chunk_off[t.tile];

  // batch b's row of sums and its T_start into slot b % AHEAD
  auto fetch = [&](int b) {
    const int k = b % AHEAD;
    float* dst = ring + ((size_t)k * B + tid) * npp;
    const float* src = part + ((c0 + b) * B + tid) * npp;
    for (int q = 0; q < npp; q += 4) copy_async16(dst + q, src + q);
    copy_async4(ring_T + k * B + tid, T_start + (c0 + b) * B + tid);
  };

  Running r;
#pragma unroll
  for (int c = 0; c < MAX_BLEND; ++c) r.acc[c] = 0.0f;
  r.an1 = r.an2 = r.an3 = r.wsum = r.dsum = r.d2sum = 0.0f;
  r.M1 = r.M2 = r.dist = r.med_d = r.med_pos = r.n_contrib = 0.0f;

  for (int b = 0; b < AHEAD - 1; ++b) {
    if (b < nw) fetch(b);
    commit_group();
  }
  for (int b = 0; b < nw; ++b) {
    if (b + AHEAD - 1 < nw) fetch(b + AHEAD - 1);
    commit_group();
    wait_groups<AHEAD - 1>();            // batch b's copies have landed
    const int k = b % AHEAD;
    if (CKPT) store_checkpoint(ckpt, c0 + b, B, C, ring_T[k * B + tid], r);
    merge(r, ring + ((size_t)k * B + tid) * npp, npp, NB);
  }
  // the batch where the vote stopped the walk: its checkpoint holds the
  // totals
  if (CKPT && nw < n_b)
    store_checkpoint(ckpt, c0 + nw, B, C, T_start[(c0 + nw) * B + tid], r);

  if (!t.inside) return;
  const size_t HW = (size_t)H * W;
  const size_t o = (size_t)t.py * W + t.px;
  // unrolled, so that r.acc is indexed by constants and stays in registers
#pragma unroll
  for (int c = 0; c < MAX_BLEND; ++c) {
    if (c < C) color[c * HW + o] = r.acc[c];
    else if (c < NB) feat[(c - C) * HW + o] = r.acc[c];
  }
  feat[(S + 0) * HW + o] = r.an1;
  feat[(S + 1) * HW + o] = r.an2;
  feat[(S + 2) * HW + o] = r.an3;
  depth[0 * HW + o] = r.dsum;
  depth[1 * HW + o] = r.med_d;
  depth[2 * HW + o] = r.dist;
  depth[3 * HW + o] = r.d2sum;
  misc[1 * HW + o] = r.n_contrib;
  misc[2 * HW + o] = r.med_pos;
  misc[3 * HW + o] = r.M1;
  misc[4 * HW + o] = r.M2;
  misc[6 * HW + o] = r.wsum;
  misc[7 * HW + o] = 0.0f;
}

// ------------------------------------------------------------- launching
enum Pass { PASS_PRODUCT = 0, PASS_SCAN, PASS_BLEND, PASS_MERGE, N_PASSES };

// slots of the merge's ring (batches in flight: one fewer): three for
// tiles of up to 256 pixels (21 KB each at C + S = 8; more did not
// shorten the merge), one (no prefetch) for larger tiles
template <int T>
constexpr int merge_ahead() { return T <= 256 ? 3 : 1; }

// A pass's kernel instance for tiles of `threads` <= T pixels (the merge
// with or without the checkpoint stores) and its dynamic shared memory.
struct Launch {
  const void* kernel;
  size_t smem;
};

template <int T>
Launch instance(int pass, int threads, int C, int S, bool ckpt) {
  constexpr int AHEAD = merge_ahead<T>();
  const size_t col = (size_t)threads * sizeof(float);
  switch (pass) {
    case PASS_PRODUCT:
      return {(const void*)fwd_product_kernel<T>, HEAD * col};
    case PASS_SCAN:
      return {(const void*)fwd_scan_kernel<T>, 0};
    case PASS_BLEND:
      return {(const void*)fwd_blend_kernel<T>,
              row_stride(F_BLEND + C + S) * col};
    default:
      return {ckpt ? (const void*)fwd_merge_kernel<T, true, AHEAD>
                   : (const void*)fwd_merge_kernel<T, false, AHEAD>,
              AHEAD * (row_stride(PART_BASE + C + S) + 1) * col};
  }
}

// The instance and its shared memory, with the attribute that lets it take
// more than 48 KB.
cudaError_t prepare(int pass, int threads, int C, int S, bool ckpt,
                    Launch& l) {
  l = threads <= 256 ? instance<256>(pass, threads, C, S, ckpt)
                     : instance<1024>(pass, threads, C, S, ckpt);
  if (l.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(l.kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)l.smem);
}

bool valid(int threads, int C, int S) {
  return C >= 0 && S >= 0 && C + S <= MAX_BLEND && threads > 0 &&
         threads <= 1024;
}

template <int T>
cudaError_t launch_all(const float* rows, int D, const int* tile_starts,
                       const int* chunk_off, int grid, int n_tiles,
                       int tiles_x, int tile_h, int tile_w, int H, int W,
                       int C, int S, const Params& prm,
                       int compute_distortion, int compute_contrib,
                       int n_ends, const int* window_ends,
                       float* prod, float* T_start,
                       int* walked, float* part, float* ckpt, float* color,
                       float* feat, float* depth, float* misc,
                       cudaStream_t st) {
  const int threads = tile_h * tile_w;
  const bool ck = ckpt != nullptr;
  Launch l[N_PASSES];
  cudaError_t err;
  for (int p = 0; p < N_PASSES; ++p)
    if ((err = prepare(p, threads, C, S, ck, l[p])) != cudaSuccess)
      return err;
  // A and B, window by window
  int lo = 0;
  for (int w = 0; w <= n_ends; ++w) {
    const bool last = w == n_ends;
    const int hi = last ? NO_END : window_ends[w];
    const dim3 g = last ? dim3(grid) : dim3(n_tiles, hi - lo);
    fwd_product_kernel<T><<<g, threads, l[PASS_PRODUCT].smem, st>>>(
        rows, D, tile_starts, chunk_off, walked, n_tiles, lo, (int)last,
        tiles_x, tile_h, tile_w, H, W, prm, prod);
    fwd_scan_kernel<T><<<n_tiles, threads, 0, st>>>(
        tile_starts, chunk_off, prod, lo, hi, tiles_x, tile_h, tile_w, H, W,
        T_start, walked, misc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    lo = hi;
  }
  fwd_blend_kernel<T><<<grid, threads, l[PASS_BLEND].smem, st>>>(
      rows, D, tile_starts, chunk_off, walked, T_start, n_tiles, tiles_x,
      tile_h, tile_w, H, W, C, S, prm, compute_distortion, compute_contrib,
      part);
  constexpr int AHEAD = merge_ahead<T>();
  (ck ? fwd_merge_kernel<T, true, AHEAD> : fwd_merge_kernel<T, false, AHEAD>)
      <<<n_tiles, threads, l[PASS_MERGE].smem, st>>>(
          tile_starts, chunk_off, walked, T_start, part, tiles_x, tile_h,
          tile_w, H, W, C, S, ckpt, color, feat, depth, misc);
  return cudaGetLastError();
}

}  // namespace

// The resources of pass `pass` (0 product, 1 scan, 2 blend, 3 merge) at a
// launch for tiles of tile_h x tile_w pixels, the merge with checkpoints
// when `ckpt` is non-zero (launch_resources, composite_common.cuh).
// Returns a cudaError_t as an int.
extern "C" int gslidar_composite_fwd_info(int device, int pass, int tile_h,
                                          int tile_w, int C, int S, int ckpt,
                                          int* out) {
  const int threads = tile_h * tile_w;
  if (!valid(threads, C, S) || pass < 0 || pass >= N_PASSES)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Launch l;
  if ((err = prepare(pass, threads, C, S, ckpt != 0, l)) != cudaSuccess)
    return (int)err;
  return (int)launch_resources(l.kernel, threads, l.smem, out);
}

// Launches the forward's passes in order on `stream` (the product and
// scan passes once per window of batches, then the blend and the merge)
// and returns the first cudaGetLastError() that is not cudaSuccess as an
// int (0 = all launched). All pointers are device pointers. rows is
// [N, D] float32 row-major with D = 10 + C + S; tile_starts and chunk_off
// are [n_tiles + 1] int32 (chunk_off: each tile's first staging batch);
// `grid` >= chunk_off[n_tiles] is the size of the per-batch scratch: prod
// and T_start [grid, tile pixels] float32, part [grid, tile pixels,
// C + S + 12 rounded up to a multiple of 4] float32, 16-byte aligned;
// walked is [n_tiles] int32. The outputs are [C,H,W],
// [S+3,H,W], [4,H,W] and [8,H,W] float32. window_ends (host memory) holds
// the n_ends increasing ends of the windows of batches the product and
// scan passes take in rounds; the last window runs from the last end to
// the end of every list. ckpt, when not null, receives
// the checkpoint of every staging batch the walk reaches
// (composite_common.cuh); a null ckpt launches the merge without the
// stores.
extern "C" int gslidar_composite_fwd(
    int device, const float* rows, int D, const int* tile_starts,
    const int* chunk_off, int grid, int n_tiles, int tiles_x, int tile_h,
    int tile_w, int H, int W, int C, int S, float near, float far,
    float vmin, float vmax, float hmin, float hmax, float wrap_w,
    float wrap_inv, int compute_distortion, int compute_contrib,
    int n_ends, const int* window_ends, float* prod,
    float* T_start, int* walked, float* part, float* ckpt, float* color,
    float* feat, float* depth, float* misc, void* stream) {
  const int threads = tile_h * tile_w;
  if (!valid(threads, C, S) || D != 10 + C + S || n_tiles <= 0 ||
      grid <= 0 || n_ends < 0 || (n_ends > 0 && window_ends == nullptr))
    return (int)cudaErrorInvalidValue;
  for (int w = 0; w < n_ends; ++w)     // increasing, within a grid of y
    if (window_ends[w] <= (w ? window_ends[w - 1] : 0) ||
        window_ends[w] - (w ? window_ends[w - 1] : 0) > 65535)
      return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Params prm{near, far, vmin, vmax, hmin, hmax, wrap_w, wrap_inv};
  auto go = threads <= 256 ? launch_all<256> : launch_all<1024>;
  return (int)go(rows, D, tile_starts, chunk_off, grid, n_tiles, tiles_x,
                 tile_h, tile_w, H, W, C, S, prm, compute_distortion,
                 compute_contrib, n_ends, window_ends, prod,
                 T_start, walked, part, ckpt, color, feat, depth, misc,
                 (cudaStream_t)stream);
}
