// Train-mode BatchNorm, then an optional ReLU, then an optional dropout,
// of the ray-drop refinement U-Net (models/unet.py), forward and backward,
// for Hopper (sm_90a).
//
// Replaces: no TPU kernel. The JAX package leaves flax's BatchNorm, ReLU
// and dropout to XLA (gslidar_tpu/models/unet.py), and the port's eager
// module (models/unet.py ``BatchNorm``, ``F.relu``, ``_dropout``) runs
// them as some twenty elementwise passes and reductions forward and as
// many backward, each reading and writing whole activations: about 75
// bytes an element forward and 105 backward.
//
// What bounds it on this card: bytes. Forward, the statistics pass reads
// x (4 bytes an element) and the apply pass reads x and the dropout's
// uniform and writes y and a keep byte (13); backward, the reduction
// reads dy, x and the keep byte (9) and the apply pass reads them again
// and writes dx (13): 17 and 22 bytes an element
// (gslidar_tpu_torch/microbench/bounds.py ``bn_act_bound``). A float32
// add or multiply or two an element is far below the memory's rate.
//
// What the design does about it: two passes each way, each operand read
// once a pass. Channel c's elements are the B planes of H*W floats it has
// in NCHW; a block takes one contiguous chunk of them (``walk``, plane by
// plane), in packs of 4 floats that load and store as 16 bytes, with 4
// packs in flight a thread in the statistics pass and 2 of each operand
// in the others (``Body::U``): a pass that reads one operand needs the
// deeper queue to keep the memory busy. The grid is (parts, C): ``plan``
// gives each channel as many chunks as make about two waves of the pair's
// resident blocks over all channels, fewer where a channel is small (at
// least MIN_BLOCK elements a chunk) and at most the caller's ``parts``,
// so the planes of 67,980 pixels at 32-64 channels and of 256 pixels at
// 256-512 channels take one algorithm on different grids. The first pass
// of each pair writes a partial sum pair per block, in float64 and with
// no atomics; the second pass sums its channel's pairs in a fixed order
// (``channel_sum2``), the same in every block, so the statistics are the
// same bits in every block and in every run. No pass reads anything to
// the host.
//
// Arithmetic (the library is built with --fmad=false: each float32
// operation rounds alone). Forward: s1 = sum x and s2 = sum x*x in
// float64, mean = s1/n, raw = s2/n - mean^2, var = max(raw, 0) (flax's
// biased E[x^2] - E[x]^2, clipped), all in float64, then rounded: mean_f,
// rstd = 1/sqrt(var + eps) and var_f. mul = rstd * w; t = (x - mean_f) *
// mul + b; ReLU passes t where t > 0 (or t is NaN); dropout keeps where
// u >= p, writes keep, and scales by s = 1/(1-p) rounded to float32. The
// block of chunk 0 of a channel moves its running statistics,
// r = r * (1 - m) + m * batch (the variance biased, as flax's), and saves
// mean_f, rstd and whether raw >= 0 for the backward. Backward: g = dy,
// times s where kept and 0 where dropped, 0 where ReLU's gate (t
// recomputed by the forward's operations, so the same bits) is shut;
// xhat = (x - mean_f) * rstd; sg = sum g and sgx = sum g*xhat in float64
// (the bias's and the weight's gradients); dx = mul * ((g - sg/n) -
// xhat * (sgx/n)), the last term dropped where raw < 0, since the clip
// passes no gradient through the variance there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr long long MIN_BLOCK = (long long)THREADS * 8;
constexpr unsigned FULL = 0xffffffffu;

struct Shape {
  long long HW;       // a plane's elements
  long long plane;    // C * HW: one image's
  long long n;        // B * HW: a channel's
  long long chunk;    // a block's elements of its channel
  int C, parts;       // channels, chunks a channel
};

// Calls body.step<W>(idx, ok) for the block's chunk of channel c, Body::U
// packs of W consecutive elements a thread at a time: idx[q] is the flat
// NCHW index of pack q's first element and ok[q] says whether the pack is
// one. Within a plane's run the packs are of 4 from a multiple of 4 on,
// so they load and store as 16 bytes (4 for the keep bytes); the run's
// head before it and its tail after the last whole pack, under 4 elements
// each, go one element a thread.
template <class Body>
__device__ __forceinline__ void walk(Body& body, const Shape& S, int c,
                                     int k) {
  constexpr int U = Body::U;
  const long long j1 = min(S.n, (k + 1) * S.chunk);
  for (long long j = k * S.chunk; j < j1;) {
    const long long b = j / S.HW, p0 = j - b * S.HW;
    const long long len = min(j1 - j, S.HW - p0);
    const long long base = b * S.plane + c * S.HW + p0;
    const long long head = min(len, (4 - (base & 3)) & 3);
    const long long packs = (len - head) >> 2;
    const long long tail = head + 4 * packs;
    long long idx[U];
    bool ok[U];
    const long long t = threadIdx.x;
#pragma unroll
    for (int q = 0; q < U; ++q) ok[q] = false;
    if (t < head || (t >= 4 && t - 4 < len - tail)) {
      idx[0] = t < head ? base + t : base + tail + (t - 4);
      ok[0] = true;
      body.template step<1>(idx, ok);
    }
    for (long long i = t; i < packs; i += (long long)U * THREADS) {
#pragma unroll
      for (int q = 0; q < U; ++q) {
        const long long e = i + (long long)q * THREADS;
        ok[q] = e < packs;
        idx[q] = base + head + 4 * e;
      }
      body.template step<4>(idx, ok);
    }
    j += len;
  }
}

// W consecutive values at p (16- or 4-byte aligned where W is 4)
template <int W>
__device__ __forceinline__ void load(const float* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int W>
__device__ __forceinline__ void load(const uint8_t* p, uint8_t (&v)[W]) {
  if constexpr (W == 4) {
    const uchar4 t = __ldg(reinterpret_cast<const uchar4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

// streaming stores: nothing stored is read again by the pass
template <int W>
__device__ __forceinline__ void store(float* p, const float (&v)[W]) {
  if constexpr (W == 4)
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  else
    __stcs(p, v[0]);
}

template <int W>
__device__ __forceinline__ void store(uint8_t* p, const uint8_t (&v)[W]) {
  if constexpr (W == 4)
    *reinterpret_cast<uchar4*>(p) = make_uchar4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

// The block's sums of a and of b, written to out[0] and out[1].
__device__ __forceinline__ void block_sum2(double a, double b, double* out) {
  __shared__ double sh[2][WARPS];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(FULL, a, o);
    b += __shfl_down_sync(FULL, b, o);
  }
  const int w = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    sh[0][w] = a;
    sh[1][w] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0, t = 0.0;
    for (int i = 0; i < WARPS; ++i) {
      s += sh[0][i];
      t += sh[1][i];
    }
    out[0] = s;
    out[1] = t;
  }
}

// The channel's two sums from its parts' pairs, in one fixed order, into
// tot[0] and tot[1] for the whole block.
__device__ __forceinline__ void channel_sum2(const double* part, int parts,
                                             double* tot) {
  if (threadIdx.x < 32) {
    double s = 0.0, t = 0.0;
    for (int i = threadIdx.x; i < parts; i += 32) {
      s += part[2 * i];
      t += part[2 * i + 1];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_down_sync(FULL, s, o);
      t += __shfl_down_sync(FULL, t, o);
    }
    if (threadIdx.x == 0) {
      tot[0] = s;
      tot[1] = t;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ bool relu_passes(float t) {
  return t > 0.f || t != t;
}

// ------------------------------------------------------------- forward
struct Fwd {
  const float* x;
  const float* u;           // the dropout's uniforms (DROP)
  const float* w;
  const float* b;
  float* running_mean;
  float* running_var;
  float* saved;             // [3, C]: mean, rstd, raw >= 0
  double* part;             // [C, parts, 2]
  float* y;
  uint8_t* keep;            // (DROP)
  Shape S;
  float p, scale, momentum, one_minus_momentum;
  double eps;
};

struct StatsBody {
  static constexpr int U = 4;
  const float* __restrict__ x;
  double s1, s2;
  template <int W>
  __device__ __forceinline__ void step(const long long (&idx)[U],
                                       const bool (&ok)[U]) {
    float v[U][W];
#pragma unroll
    for (int q = 0; q < U; ++q)
      if (ok[q]) load<W>(x + idx[q], v[q]);
#pragma unroll
    for (int q = 0; q < U; ++q) {
      if (!ok[q]) continue;
#pragma unroll
      for (int r = 0; r < W; ++r) {
        const double d = v[q][r];
        s1 += d;
        s2 += d * d;
      }
    }
  }
};

__global__ void __launch_bounds__(THREADS)
    fwd_stats_kernel(const __grid_constant__ Fwd F) {
  const int k = blockIdx.x, c = blockIdx.y;
  StatsBody body{F.x, 0.0, 0.0};
  walk(body, F.S, c, k);
  block_sum2(body.s1, body.s2, F.part + 2 * ((long long)c * F.S.parts + k));
}

template <bool RELU, bool DROP>
struct ApplyBody {
  static constexpr int U = 2;
  const Fwd& F;
  float mean, mul, bias;
  template <int W>
  __device__ __forceinline__ void step(const long long (&idx)[U],
                                       const bool (&ok)[U]) {
    float v[U][W], u[U][W];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      if (!ok[q]) continue;
      load<W>(F.x + idx[q], v[q]);
      if (DROP) load<W>(F.u + idx[q], u[q]);
    }
#pragma unroll
    for (int q = 0; q < U; ++q) {
      if (!ok[q]) continue;
      float y[W];
      uint8_t kept[W];
#pragma unroll
      for (int r = 0; r < W; ++r) {
        float t = (v[q][r] - mean) * mul + bias;
        if (RELU) t = relu_passes(t) ? t : 0.f;
        if (DROP) {
          kept[r] = u[q][r] >= F.p ? 1 : 0;
          t = kept[r] ? t * F.scale : 0.f;
        }
        y[r] = t;
      }
      if (DROP) store<W>(F.keep + idx[q], kept);
      store<W>(F.y + idx[q], y);
    }
  }
};

template <bool RELU, bool DROP>
__global__ void __launch_bounds__(THREADS)
    fwd_apply_kernel(const __grid_constant__ Fwd F) {
  __shared__ double tot[2];
  const int k = blockIdx.x, c = blockIdx.y;
  channel_sum2(F.part + 2ll * c * F.S.parts, F.S.parts, tot);
  const double n = (double)F.S.n;
  const double mean_d = tot[0] / n;
  const double raw = tot[1] / n - mean_d * mean_d;
  const double var_d = raw < 0.0 ? 0.0 : raw;
  const float mean = (float)mean_d;
  const float rstd = (float)(1.0 / sqrt(var_d + F.eps));
  if (k == 0 && threadIdx.x == 0) {
    const float var = (float)var_d;
    F.running_mean[c] = F.running_mean[c] * F.one_minus_momentum
                        + F.momentum * mean;
    F.running_var[c] = F.running_var[c] * F.one_minus_momentum
                       + F.momentum * var;
    F.saved[c] = mean;
    F.saved[F.S.C + c] = rstd;
    F.saved[2 * F.S.C + c] = raw < 0.0 ? 0.f : 1.f;
  }
  ApplyBody<RELU, DROP> body{F, mean, rstd * F.w[c], F.b[c]};
  walk(body, F.S, c, k);
}

// ------------------------------------------------------------ backward
struct Bwd {
  const float* dy;
  const float* x;
  const uint8_t* keep;      // (DROP)
  const float* w;
  const float* b;
  const float* saved;       // [3, C] of the forward
  double* part;             // [C, parts, 2]
  float* dx;
  float* dw;
  float* db;
  Shape S;
  float scale;
};

// g and xhat of element idx: dy through dropout and ReLU's gate
template <bool RELU, bool DROP>
struct Grad {
  float mean, rstd, mul, bias;
  __device__ __forceinline__ void operator()(float dy, float v, uint8_t kept,
                                             float scale, float& g,
                                             float& xhat) const {
    g = dy;
    if (DROP) g = kept ? g * scale : 0.f;
    const float xm = v - mean;
    if (RELU && !relu_passes(xm * mul + bias)) g = 0.f;
    xhat = xm * rstd;
  }
};

constexpr int BWD_U = 2;

// dy, x and the keep bytes of U packs of W
template <bool DROP, int W>
struct LoadBwd {
  float dy[BWD_U][W], v[BWD_U][W];
  uint8_t kept[BWD_U][W];
  __device__ __forceinline__ void operator()(const Bwd& B,
                                             const long long (&idx)[BWD_U],
                                             const bool (&ok)[BWD_U]) {
#pragma unroll
    for (int q = 0; q < BWD_U; ++q) {
      if (!ok[q]) continue;
      load<W>(B.dy + idx[q], dy[q]);
      load<W>(B.x + idx[q], v[q]);
      if (DROP) load<W>(B.keep + idx[q], kept[q]);
    }
  }
};

template <bool RELU, bool DROP>
struct ReduceBody {
  static constexpr int U = BWD_U;
  const Bwd& B;
  Grad<RELU, DROP> gr;
  double sg, sgx;
  template <int W>
  __device__ __forceinline__ void step(const long long (&idx)[U],
                                       const bool (&ok)[U]) {
    LoadBwd<DROP, W> L;
    L(B, idx, ok);
#pragma unroll
    for (int q = 0; q < U; ++q) {
      if (!ok[q]) continue;
#pragma unroll
      for (int r = 0; r < W; ++r) {
        float g, xhat;
        gr(L.dy[q][r], L.v[q][r], DROP ? L.kept[q][r] : 0, B.scale, g,
           xhat);
        sg += (double)g;
        sgx += (double)g * (double)xhat;
      }
    }
  }
};

template <bool RELU, bool DROP>
__device__ __forceinline__ Grad<RELU, DROP> channel_grad(const Bwd& B,
                                                         int c) {
  const float rstd = B.saved[B.S.C + c];
  return Grad<RELU, DROP>{B.saved[c], rstd, rstd * B.w[c], B.b[c]};
}

template <bool RELU, bool DROP>
__global__ void __launch_bounds__(THREADS)
    bwd_reduce_kernel(const __grid_constant__ Bwd B) {
  const int k = blockIdx.x, c = blockIdx.y;
  ReduceBody<RELU, DROP> body{B, channel_grad<RELU, DROP>(B, c), 0.0, 0.0};
  walk(body, B.S, c, k);
  block_sum2(body.sg, body.sgx, B.part + 2 * ((long long)c * B.S.parts + k));
}

template <bool RELU, bool DROP>
struct DxBody {
  static constexpr int U = BWD_U;
  const Bwd& B;
  Grad<RELU, DROP> gr;
  float a, bcoef;
  template <int W>
  __device__ __forceinline__ void step(const long long (&idx)[U],
                                       const bool (&ok)[U]) {
    LoadBwd<DROP, W> L;
    L(B, idx, ok);
#pragma unroll
    for (int q = 0; q < U; ++q) {
      if (!ok[q]) continue;
      float dx[W];
#pragma unroll
      for (int r = 0; r < W; ++r) {
        float g, xhat;
        gr(L.dy[q][r], L.v[q][r], DROP ? L.kept[q][r] : 0, B.scale, g,
           xhat);
        dx[r] = gr.mul * ((g - a) - xhat * bcoef);
      }
      store<W>(B.dx + idx[q], dx);
    }
  }
};

template <bool RELU, bool DROP>
__global__ void __launch_bounds__(THREADS)
    bwd_apply_kernel(const __grid_constant__ Bwd B) {
  __shared__ double tot[2];
  const int k = blockIdx.x, c = blockIdx.y;
  channel_sum2(B.part + 2ll * c * B.S.parts, B.S.parts, tot);
  const double n = (double)B.S.n;
  if (k == 0 && threadIdx.x == 0) {
    B.db[c] = (float)tot[0];
    B.dw[c] = (float)tot[1];
  }
  DxBody<RELU, DROP> body{B, channel_grad<RELU, DROP>(B, c),
                          (float)(tot[0] / n),
                          (float)(tot[1] / n) * B.saved[2 * B.S.C + c]};
  walk(body, B.S, c, k);
}

// ---------------------------------------------------------------- host
bool aligned(const void* p, uintptr_t bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

int sm_count(int device) {
  static int sms[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (sms[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device)
            != cudaSuccess || n <= 0)
      n = 132;
    sms[device] = n;
  }
  return sms[device];
}

// The blocks of THREADS that both kernels of a pair keep resident on an SM
// at once.
template <class K1, class K2>
int resident(K1 k1, K2 k2) {
  int a = 0, b = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a, k1, THREADS, 0)
          != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, k2, THREADS, 0)
          != cudaSuccess)
    return 1;
  return a < b ? (a > 0 ? a : 1) : (b > 0 ? b : 1);
}

// The grid of a (B, C, HW) tensor: about two waves of the pair's resident
// blocks over all channels, each chunk at least MIN_BLOCK elements, at
// most max_parts chunks a channel. Returns false on a shape it does not
// take.
bool plan(int device, int per_sm, long long B, int C, long long HW,
          int max_parts, Shape& S) {
  if (B <= 0 || C <= 0 || C > 65535 || HW <= 0 || max_parts <= 0)
    return false;
  S.HW = HW;
  S.plane = (long long)C * HW;
  S.n = B * HW;
  S.C = C;
  const long long waves = 2ll * sm_count(device) * per_sm;
  long long parts = (waves + C - 1) / C;
  const long long by_size = (S.n + MIN_BLOCK - 1) / MIN_BLOCK;
  if (parts > by_size) parts = by_size;
  if (parts > max_parts) parts = max_parts;
  if (parts < 1) parts = 1;
  S.chunk = (S.n + parts - 1) / parts;
  S.parts = (int)((S.n + S.chunk - 1) / S.chunk);
  return true;
}

template <bool RELU, bool DROP>
int launch_fwd(int device, Fwd& F, long long B, int C, long long HW,
               int max_parts, cudaStream_t st) {
  static const int per_sm = resident(fwd_stats_kernel,
                                     fwd_apply_kernel<RELU, DROP>);
  if (!plan(device, per_sm, B, C, HW, max_parts, F.S))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)F.S.parts, (unsigned)C);
  fwd_stats_kernel<<<grid, THREADS, 0, st>>>(F);
  fwd_apply_kernel<RELU, DROP><<<grid, THREADS, 0, st>>>(F);
  return (int)cudaGetLastError();
}

template <bool RELU, bool DROP>
int launch_bwd(int device, Bwd& G, long long B, int C, long long HW,
               int max_parts, cudaStream_t st) {
  static const int per_sm = resident(bwd_reduce_kernel<RELU, DROP>,
                                     bwd_apply_kernel<RELU, DROP>);
  if (!plan(device, per_sm, B, C, HW, max_parts, G.S))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)G.S.parts, (unsigned)C);
  bwd_reduce_kernel<RELU, DROP><<<grid, THREADS, 0, st>>>(G);
  bwd_apply_kernel<RELU, DROP><<<grid, THREADS, 0, st>>>(G);
  return (int)cudaGetLastError();
}

}  // namespace

// The forward on `stream`: x [B, C, HW] float32 contiguous (each tensor
// of elements 16-byte aligned, keep 4-byte aligned); u (the
// dropout's uniforms, x's shape; null when p == 0), w, b, running_mean and
// running_var [C]; writes y (x's shape), keep (uint8, x's shape; null
// when p == 0), saved [3, C] (mean, rstd, raw variance >= 0) and moves the
// running statistics. part is scratch of max_parts * C * 2 doubles. Scale
// is the float32 of 1 / (1 - p). Dropout comes only after ReLU, as in every
// layer of the U-Net: p > 0 without relu is refused. Returns
// cudaGetLastError() as an int.
extern "C" int gslidar_bn_act_fwd(int device, const float* x, const float* u,
                                  const float* w, const float* b,
                                  float* running_mean, float* running_var,
                                  float* saved, double* part, float* y,
                                  uint8_t* keep, long long B, int C,
                                  long long HW, int relu, float p,
                                  float scale, float momentum,
                                  float one_minus_momentum, double eps,
                                  int max_parts, void* stream) {
  Fwd F{x, u, w, b, running_mean, running_var, saved, part, y, keep};
  const bool drop = p > 0.f;
  if (drop && (!relu || u == nullptr || keep == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!aligned(x, 16) || !aligned(y, 16) ||
      (drop && (!aligned(u, 16) || !aligned(keep, 4))))
    return (int)cudaErrorMisalignedAddress;
  F.p = p;
  F.scale = scale;
  F.momentum = momentum;
  F.one_minus_momentum = one_minus_momentum;
  F.eps = eps;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (relu && drop)
    return launch_fwd<true, true>(device, F, B, C, HW, max_parts, st);
  if (relu) return launch_fwd<true, false>(device, F, B, C, HW, max_parts, st);
  return launch_fwd<false, false>(device, F, B, C, HW, max_parts, st);
}

// The backward on `stream`: dy, x [B, C, HW] float32 contiguous; keep the
// forward's (null when it had no dropout: drop 0); w, b [C]; saved the
// forward's [3, C]; writes dx (x's shape), dw and db [C]. part is scratch
// of max_parts * C * 2 doubles; scale as the forward's; drop without relu
// is refused, as the forward refuses it.
extern "C" int gslidar_bn_act_bwd(int device, const float* dy,
                                  const float* x, const uint8_t* keep,
                                  const float* w, const float* b,
                                  const float* saved, double* part,
                                  float* dx, float* dw, float* db,
                                  long long B, int C, long long HW, int relu,
                                  int drop, float scale, int max_parts,
                                  void* stream) {
  Bwd G{dy, x, keep, w, b, saved, part, dx, dw, db};
  if (drop && (!relu || keep == nullptr)) return (int)cudaErrorInvalidValue;
  if (!aligned(dy, 16) || !aligned(x, 16) || !aligned(dx, 16) ||
      (drop && !aligned(keep, 4)))
    return (int)cudaErrorMisalignedAddress;
  G.scale = scale;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (relu && drop)
    return launch_bwd<true, true>(device, G, B, C, HW, max_parts, st);
  if (relu) return launch_bwd<true, false>(device, G, B, C, HW, max_parts, st);
  return launch_bwd<false, false>(device, G, B, C, HW, max_parts, st);
}
