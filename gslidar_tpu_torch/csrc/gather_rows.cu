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
// What the design does about it: one warp per output row. The warp reads
// its id once, then the row through the read-only path (__ldg) as 16-byte
// vectors when D % 4 == 0 and both pointers are 16-byte aligned (one
// float4 per lane for D = 128), else as one float per lane; the output is
// written with streaming stores (__stcs), since nothing here reads it
// again. Offsets are 64-bit. Many warps in flight on every SM hide the
// latency of the random row reads, which is what the Pallas lookahead did
// with its double buffer. An id outside [0, P) traps, as index_select's
// device-side assert does, rather than reading outside the table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;

template <bool VEC4>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
gather_rows_kernel(const float* __restrict__ table, long long P, int D,
                   const int* __restrict__ ids, long long K,
                   float* __restrict__ out) {
  const long long row =
      (long long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= K) return;
  const int id = __ldg(ids + row);
  if (id < 0 || id >= P) __trap();
  const long long src = (long long)id * D;
  const long long dst = row * D;
  if (VEC4) {
    const float4* s = reinterpret_cast<const float4*>(table + src);
    float4* d = reinterpret_cast<float4*>(out + dst);
    for (int c = lane; c < D / 4; c += 32) __stcs(d + c, __ldg(s + c));
  } else {
    for (int c = lane; c < D; c += 32)
      __stcs(out + dst + c, __ldg(table + src + c));
  }
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
  const long long blocks = (K + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec4 = D % 4 == 0 && ((uintptr_t)table % 16) == 0 &&
                    ((uintptr_t)out % 16) == 0;
  const dim3 grid((unsigned)blocks), block(WARPS_PER_BLOCK * 32);
  if (vec4)
    gather_rows_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
        table, P, D, ids, K, out);
  else
    gather_rows_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        table, P, D, ids, K, out);
  return (int)cudaGetLastError();
}
