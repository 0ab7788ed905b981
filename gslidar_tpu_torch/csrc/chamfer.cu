// The chamfer term's nearest neighbours, forward and backward, for
// Hopper (sm_90a).
//
// Replaces: no TPU kernel. The JAX package computes the chamfer in XLA
// (gslidar_tpu/ops/chamfer.py, chunked |a|^2 + |b|^2 - 2 a.b blocks and an
// argmin), and so does the port's plain version (ops/chamfer.py
// ``chamfer_reference``); the reference's own chamfer3D.cu is a
// brute-force CUDA kernel of this kind. For each valid point of one cloud
// the forward finds the nearest valid point of the other, in both
// directions in one launch, and writes its squared distance and index;
// the backward takes the gradients of those distances to the two clouds
// (chamfer3D.cu:167-196).
//
// What bounds it on this card: float32 issue. A (query, reference) pair
// needs at least 3 subtractions, a multiplication and 2 FMAs, besides a
// compare and a select; a training step's two 66x515 panoramas are ~34k
// points each, 2 x 34k x 34k = 2.3e9 pairs, ~0.41 ms of those alone at 128
// a clock on 132 SMs. The library is built with --fmad=false, so this
// kernel issues 3 multiplications and 2 additions in place of the FMAs,
// ~0.55 ms: the price of the distance's fixed bits (below). Its inputs and
// outputs are under a megabyte (gslidar_tpu_torch/microbench/bounds.py
// ``chamfer_bound``).
//
// What the design does about it: nothing but the pair scan touches
// memory. ~34k queries a direction are too few threads to fill 132 SMs, so
// the reference cloud is cut into slices across blocks as well: a block
// holds TILE queries (QPT in each thread's registers) and stages its
// slice of the other cloud in shared memory, BATCH points at a time as
// float4 (one broadcast load a point feeds QPT pairs). Invalid reference
// points are staged at +inf, so they never win a strict compare and cost
// no test of their own. The slices' minima merge with a 64-bit atomicMin
// on (float bits of d^2, index): non-negative floats order as their bits
// do, so the merge is exact and keeps the lowest index on a tie, as a
// thread's own scan in index order with a strict < does. The last block of
// a tile to merge (a counter per tile) writes the tile's distances and
// indices. The backward runs one thread per query and adds its pair's
// gradient to both points with float atomics.
//
// Bits: a distance is (ax-bx)^2 + (ay-by)^2 + (az-bz)^2, summed left to
// right, as the plain version recomputes it from the neighbour it picked;
// where the two pick the same neighbour the distances are equal bit for
// bit. The plain version picks by the expansion form, whose rounding can
// prefer another point of a near-tie; this kernel picks the least of the
// distances it returns. The backward's g * (2 (a - b)) is the plain
// autograd's product; the atomics sum in no fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int QPT = 4;                  // queries a thread holds
constexpr int TILE = THREADS * QPT;     // queries a block holds
constexpr int BATCH = 1024;             // reference points staged at once
constexpr int UNROLL = 8;               // reference points a scan step
constexpr int WAVES = 4;                // resident grids the forward fills
constexpr int MIN_SLICE = 256;          // fewest reference points a slice
constexpr int BWD_THREADS = 256;
constexpr unsigned long long NO_KEY = ~0ull;
constexpr int MAX_DEVICES = 64;

// one direction: queries q [nq] against references r [nr]; points are
// rows of 3 floats at element strides (row, col)
struct Side {
  const float* q;
  const unsigned char* qmask;   // null: all valid
  const float* r;
  const unsigned char* rmask;
  int nq, nr, q_row, q_col, r_row, r_col;
  int tile0;                    // this side's first tile in blockIdx.x
  int slice;                    // reference points a slice
  unsigned long long* key;      // [nq] (d^2 bits << 32 | index), NO_KEY
  unsigned int* merged;         // [tiles] slices merged so far
  float* dist;                  // [nq]
  int* idx;                     // [nq]
};

__global__ void __launch_bounds__(THREADS)
chamfer_fwd_kernel(Side s0, Side s1) {
  __shared__ float4 ref[BATCH];
  __shared__ bool last;
  const Side s = (int)blockIdx.x >= s1.tile0 ? s1 : s0;
  const int q0 = (blockIdx.x - s.tile0) * TILE;
  const float inf = __int_as_float(0x7f800000);

  float qx[QPT], qy[QPT], qz[QPT], best[QPT];
  int bi[QPT];
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int i = q0 + threadIdx.x + k * THREADS;
    const bool in = i < s.nq;
    const long long o = (long long)(in ? i : 0) * s.q_row;
    qx[k] = in ? s.q[o] : 0.f;
    qy[k] = in ? s.q[o + s.q_col] : 0.f;
    qz[k] = in ? s.q[o + 2 * s.q_col] : 0.f;
    best[k] = inf;
    bi[k] = -1;
  }

  const int r_begin = blockIdx.y * s.slice;
  const int r_end = min(s.nr, r_begin + s.slice);
  for (int b0 = r_begin; b0 < r_end; b0 += BATCH) {
    const int nb = min(BATCH, r_end - b0);
    const int padded = (nb + UNROLL - 1) / UNROLL * UNROLL;
    __syncthreads();
    for (int t = threadIdx.x; t < padded; t += THREADS) {
      const int j = b0 + t;
      float4 v = make_float4(inf, inf, inf, 0.f);
      if (t < nb && (!s.rmask || s.rmask[j])) {
        const long long o = (long long)j * s.r_row;
        v = make_float4(s.r[o], s.r[o + s.r_col], s.r[o + 2 * s.r_col], 0.f);
      }
      ref[t] = v;
    }
    __syncthreads();
    for (int t = 0; t < padded; t += UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float4 v = ref[t + u];
        const int j = b0 + t + u;
#pragma unroll
        for (int k = 0; k < QPT; ++k) {
          const float dx = qx[k] - v.x;
          const float dy = qy[k] - v.y;
          const float dz = qz[k] - v.z;
          const float d = (dx * dx + dy * dy) + dz * dz;
          if (d < best[k]) {
            best[k] = d;
            bi[k] = j;
          }
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int i = q0 + threadIdx.x + k * THREADS;
    if (i < s.nq && bi[k] >= 0 && (!s.qmask || s.qmask[i]))
      atomicMin(&s.key[i],
                ((unsigned long long)__float_as_uint(best[k]) << 32) |
                    (unsigned int)bi[k]);
  }
  // the last block of the tile to merge writes its outputs (the
  // threadfence pattern: each block's atomics are ordered before its count)
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&s.merged[blockIdx.x - s.tile0], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int t = threadIdx.x; t < TILE; t += THREADS) {
    const int i = q0 + t;
    if (i >= s.nq) break;
    const unsigned long long key = __ldcg(&s.key[i]);
    const bool ok = key != NO_KEY && (!s.qmask || s.qmask[i]);
    s.dist[i] = ok ? __uint_as_float((unsigned int)(key >> 32)) : 0.f;
    s.idx[i] = ok ? (int)(key & 0xffffffffu) : -1;
  }
}

// one thread per query of either direction: its pair's gradient
// g * (2 (a - b)) to the query and its negation to the neighbour
__global__ void __launch_bounds__(BWD_THREADS)
chamfer_bwd_kernel(const float* x1, const float* x2, int n1, int n2,
                   int row1, int col1, int row2, int col2, const int* idx1,
                   const int* idx2, const float* g1, const float* g2,
                   float* dx1, float* dx2) {
  const long long t = (long long)blockIdx.x * BWD_THREADS + threadIdx.x;
  if (t >= (long long)n1 + n2) return;
  const bool second = t >= n1;
  const int i = second ? (int)(t - n1) : (int)t;
  const int j = second ? idx2[i] : idx1[i];
  if (j < 0) return;
  const float* a = second ? x2 : x1;
  const float* b = second ? x1 : x2;
  const int a_row = second ? row2 : row1, a_col = second ? col2 : col1;
  const int b_row = second ? row1 : row2, b_col = second ? col1 : col2;
  float* da = second ? dx2 : dx1;
  float* db = second ? dx1 : dx2;
  const float g = second ? g2[i] : g1[i];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float diff = a[(long long)i * a_row + c * a_col] -
                       b[(long long)j * b_row + c * b_col];
    const float v = g * (2.0f * diff);
    if (da) atomicAdd(&da[3 * (long long)i + c], v);
    if (db) atomicAdd(&db[3 * (long long)j + c], -v);
  }
}

int tiles_of(int n) { return (n + TILE - 1) / TILE; }

// the forward's resident blocks on the whole card, once per device
cudaError_t capacity(int device, int* out) {
  static int cached[MAX_DEVICES] = {0};
  if (device >= 0 && device < MAX_DEVICES && cached[device] > 0) {
    *out = cached[device];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, chamfer_fwd_kernel, THREADS, 0);
  if (err != cudaSuccess) return err;
  *out = sms * (per_sm > 0 ? per_sm : 1);
  if (device >= 0 && device < MAX_DEVICES) cached[device] = *out;
  return cudaSuccess;
}

}  // namespace

// The forward on `stream`; returns cudaGetLastError() as an int. x1 [n1]
// and x2 [n2] points of 3 floats at element strides (row, col); masks
// [n] bytes or null (all valid); keys [n1 + n2] and merged [n1 + n2], the
// merge's scratch (merged takes a count per tile, fewer than n1 + n2);
// writes dist1 [n1], idx1 [n1], dist2 [n2], idx2 [n2]: each valid
// query's squared distance to its nearest valid point of the other cloud
// and that point's index, 0 and -1 where the query is invalid or the other
// cloud has no valid point.
extern "C" int gslidar_chamfer_fwd(
    int device, const float* x1, int n1, int row1, int col1,
    const unsigned char* mask1, const float* x2, int n2, int row2, int col2,
    const unsigned char* mask2, unsigned long long* keys,
    unsigned int* merged, float* dist1, int* idx1, float* dist2, int* idx2,
    void* stream) {
  if (n1 < 0 || n2 < 0) return (int)cudaErrorInvalidValue;
  const int t1 = tiles_of(n1), t2 = tiles_of(n2);
  if (t1 + t2 == 0) return (int)cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int cap = 0;
  err = capacity(device, &cap);
  if (err != cudaSuccess) return (int)err;
  // slices: as many as fill WAVES resident grids without starting a
  // partial one, and no slice under MIN_SLICE points
  const int most = std::max(n1, n2);
  int slices = std::max(1, WAVES * cap / (t1 + t2));
  slices = std::min(slices, std::max(1, most / MIN_SLICE));
  slices = std::min(slices, 65535);
  cudaStream_t st = (cudaStream_t)stream;
  err = cudaMemsetAsync(keys, 0xff, sizeof(unsigned long long) * (n1 + n2),
                        st);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(merged, 0, sizeof(unsigned int) * (t1 + t2), st);
  if (err != cudaSuccess) return (int)err;
  Side s0{x1, mask1, x2, mask2, n1, n2, row1, col1, row2, col2, 0,
          (n2 + slices - 1) / slices, keys, merged, dist1, idx1};
  Side s1{x2, mask2, x1, mask1, n2, n1, row2, col2, row1, col1, t1,
          (n1 + slices - 1) / slices, keys + n1, merged + t1, dist2, idx2};
  chamfer_fwd_kernel<<<dim3(t1 + t2, slices), THREADS, 0, st>>>(s0, s1);
  return (int)cudaGetLastError();
}

// The backward on `stream`; returns cudaGetLastError() as an int. The
// forward's points, strides and indices, the gradients g1 [n1] and g2
// [n2] of dist1 and dist2; writes dx1 [n1, 3] and dx2 [n2, 3] (rows of 3,
// contiguous; either may be null where no gradient is wanted).
extern "C" int gslidar_chamfer_bwd(
    int device, const float* x1, int n1, int row1, int col1, const float* x2,
    int n2, int row2, int col2, const int* idx1, const int* idx2,
    const float* g1, const float* g2, float* dx1, float* dx2, void* stream) {
  if (n1 < 0 || n2 < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dx1) {
    err = cudaMemsetAsync(dx1, 0, sizeof(float) * 3 * (size_t)n1, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (dx2) {
    err = cudaMemsetAsync(dx2, 0, sizeof(float) * 3 * (size_t)n2, st);
    if (err != cudaSuccess) return (int)err;
  }
  const long long n = (long long)n1 + n2;
  if (n == 0 || (!dx1 && !dx2)) return (int)cudaSuccess;
  chamfer_bwd_kernel<<<(unsigned)((n + BWD_THREADS - 1) / BWD_THREADS),
                       BWD_THREADS, 0, st>>>(x1, x2, n1, n2, row1, col1, row2,
                                             col2, idx1, idx2, g1, g2, dx1,
                                             dx2);
  return (int)cudaGetLastError();
}
