// Row gather out[i] = table[ids[i]] for Hopper (sm_90a).
//
// Replaces: scripts/microbench_dma_gather.py::_gather_kernel (built by
// make_dma_gather), the Pallas TPU kernel that copies [P, D] float32 table
// rows into [K/128, 128, D] by one DMA per row, 128 rows per grid step,
// with the next step's DMAs issued before waiting on this step's.
//
// What bounds it on this card: bytes. It does no arithmetic: each
// distinct table row is read at least once, each id once and each output
// row written once, so the least time is those bytes over the card's
// memory rate (gslidar_tpu_torch/microbench/bounds.py).
//
// What the design does about it: a flat map of threads over the output's
// units, where a unit is the widest of float4, float2 and float that
// divides D and the alignment of both pointers. Consecutive threads take
// consecutive units of the output, so every lane works and every warp's
// store is one contiguous run, whatever the row width: a [K, 18] output
// goes out in float2 units, 32 lanes covering 256 contiguous bytes, where
// one warp per 72-byte row left 14 lanes idle and stored 72 bytes per
// instruction. At D = 128 a warp of float4 units is still exactly one
// row. Each thread takes UNROLL units a block-width apart and issues all
// their loads before its stores, so more random row reads are in flight
// per SM. Each unit reads its row's id through the read-only cache (the
// units of a row share it), the table through the read-only path (__ldg),
// and writes with streaming stores (__stcs), since nothing here reads the
// output again. Unit indices are 32-bit when the table and the output
// each have fewer than 2^32 units, else 64-bit. Many loads in flight on
// every SM hide the latency of the random row reads, which is what the
// Pallas lookahead did with its double buffer. An id outside [0, P) traps,
// as index_select's device-side assert does, rather than reading outside
// the table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;     // units per thread, all loads before the stores

template <typename Unit, typename Index>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const Unit* __restrict__ table, long long P,
                   Index row_units, const int* __restrict__ ids,
                   Index n_units, Unit* __restrict__ out) {
  const Index first = (Index)blockIdx.x * (THREADS * UNROLL) + threadIdx.x;
  Index src[UNROLL];
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const Index u = first + (Index)k * THREADS;
    const Index row = u / row_units;
    const int id = u < n_units ? __ldg(ids + row) : 0;
    src[k] = (Index)id * row_units + (u - row * row_units);
    if (id < 0 || id >= P) __trap();
  }
  Unit v[UNROLL];
#pragma unroll
  for (int k = 0; k < UNROLL; ++k)
    if (first + (Index)k * THREADS < n_units) v[k] = __ldg(table + src[k]);
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const Index u = first + (Index)k * THREADS;
    if (u < n_units) __stcs(out + u, v[k]);
  }
}

template <typename Unit>
cudaError_t launch(const float* table, long long P, int D, const int* ids,
                   long long K, float* out, cudaStream_t stream) {
  constexpr int V = sizeof(Unit) / sizeof(float);
  constexpr long long PER_BLOCK = THREADS * UNROLL;
  const long long row_units = D / V;
  const long long n_units = K * row_units;
  const long long blocks = (n_units + PER_BLOCK - 1) / PER_BLOCK;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Unit* t = reinterpret_cast<const Unit*>(table);
  Unit* o = reinterpret_cast<Unit*>(out);
  if (n_units < (1LL << 32) - PER_BLOCK && P * row_units < (1LL << 32))
    gather_rows_kernel<Unit, uint32_t><<<(unsigned)blocks, THREADS, 0,
                                         stream>>>(
        t, P, (uint32_t)row_units, ids, (uint32_t)n_units, o);
  else
    gather_rows_kernel<Unit, unsigned long long><<<(unsigned)blocks, THREADS,
                                                   0, stream>>>(
        t, P, (unsigned long long)row_units, ids,
        (unsigned long long)n_units, o);
  return cudaGetLastError();
}

// The widest unit of V floats that divides D and both pointers' alignment.
int unit_floats(const float* table, int D, const float* out) {
  for (int v = 4; v > 1; v >>= 1)
    if (D % v == 0 && (uintptr_t)table % (4 * v) == 0 &&
        (uintptr_t)out % (4 * v) == 0)
      return v;
  return 1;
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an
// int (0 = cudaSuccess). table is [P, D] and out [K, D] float32 row-major,
// ids [K] int32, all device pointers.
extern "C" int gslidar_gather_rows(int device, const float* table,
                                   long long P, int D, const int* ids,
                                   long long K, float* out, void* stream) {
  if (P <= 0 || D <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (unit_floats(table, D, out)) {
    case 4: return (int)launch<float4>(table, P, D, ids, K, out, s);
    case 2: return (int)launch<float2>(table, P, D, ids, K, out, s);
    default: return (int)launch<float>(table, P, D, ids, K, out, s);
  }
}
