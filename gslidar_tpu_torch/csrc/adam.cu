// The step's Adam update of every parameter group in one launch, for
// Hopper (sm_90a).
//
// Replaces: no TPU kernel. The JAX package leaves Adam to XLA
// (gslidar_tpu/models/optim.py ``adam_step``), and so does the port's
// plain version (models/optim.py ``adam_step_reference``): about a dozen
// torch elementwise ops a group, each reading and writing the whole group
// and allocating a temporary, ten groups one after another.
//
// What bounds it on this card: bytes. An element needs its parameter,
// gradient and two moments read once and the new parameter and moments
// written once, 28 bytes, for 12 float32 adds and multiplies, a square
// root and a division; 81 floats a gaussian, so 22.7 GB at 10M gaussians,
// 6.8 ms at 3.35 TB/s (gslidar_tpu_torch/microbench/bounds.py
// ``adam_bound``).
//
// What the design does about it: each element is read once and written
// once, in one launch over all groups. A small table passed by value gives
// each group's pointers, element count, learning rate and the block it
// starts at; block b updates one chunk of CHUNK elements of one group,
// each thread VEC float4s of each of the four inputs, all loads issued
// before any arithmetic, the stores with the streaming hint (no output is
// read again in the step). A group whose pointers are not all 16-byte aligned, or whose
// input rows do not keep float4s whole, takes a scalar loop instead;
// the float4 path leaves a tail of under 4 elements to the same loop.
//
// An input may be rows of a wider tensor: f_dc's and f_rest's gradients
// are the two column ranges of the SH coefficients' gradient [P, 16, C]
// that the cat in the model's features hands back, and a model made by
// create_from_pcd holds f_dc and f_rest as such ranges of one tensor. So
// each input is read as rows of ``row`` elements ``stride`` elements apart
// (equal where it is contiguous); the outputs are contiguous.
//
// Bits: each element runs the plain version's torch ops in their order,
// each rounded to float32 (the library is built with --fmad=false):
//   mu' = b1 mu + (1 - b1) g,  nu' = b2 nu + ((1 - b2) g) g,
//   p'  = p - lr ((mu' * inv_c1) / (sqrt(nu' * inv_c2) + eps)),
// with each scalar the float32 torch makes of it. Torch multiplies a CUDA
// tensor divided by a host scalar c by 1 / c taken in double and rounded
// to float32, not by the float32 reciprocal of the float32 c (which
// differs in its last bit for c2 at steps 1, 2, 4, 5, ...), so the wrapper
// passes inv_c1 and inv_c2 so computed. The result equals the plain
// version's on the card bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_GROUPS = 16;
constexpr int THREADS = 256;
constexpr int VEC = 4;                                // float4s a thread
constexpr long long CHUNK = (long long)THREADS * VEC * 4;  // elements a block

// the inputs, in this order
enum { P_IN, G_IN, MU_IN, NU_IN, INPUTS };

struct Group {
  const float* in[INPUTS];
  float* p_out;
  float* mu_out;
  float* nu_out;
  long long n;                // elements
  long long row[INPUTS];      // each input's row length, elements
  long long stride[INPUTS];   // and its row stride (== row: contiguous)
  float lr;
  int vec;                    // 1: the float4 path
};

struct Groups {
  Group grp[MAX_GROUPS];
  long long block0[MAX_GROUPS + 1];   // each group's first block
  int count;
  float b1, omb1, b2, omb2, inv_c1, inv_c2, eps;
};

// where element e of input i lies
__device__ __forceinline__ const float* at(const Group& gr, int i,
                                           long long e) {
  const long long r = gr.row[i], s = gr.stride[i];
  return gr.in[i] + (r == s ? e : (e / r) * s + e % r);
}

__device__ __forceinline__ void update(const Groups& G, float lr, float p,
                                       float g, float mu, float nu, float& po,
                                       float& mo, float& vo) {
  const float m1 = G.b1 * mu + G.omb1 * g;
  const float v1 = G.b2 * nu + (G.omb2 * g) * g;
  const float step = (m1 * G.inv_c1) / (sqrtf(v1 * G.inv_c2) + G.eps);
  po = p - lr * step;
  mo = m1;
  vo = v1;
}

__device__ __forceinline__ void update_one(const Groups& G, const Group& gr,
                                           long long e) {
  float po, mo, vo;
  update(G, gr.lr, *at(gr, P_IN, e), *at(gr, G_IN, e),
         *at(gr, MU_IN, e), *at(gr, NU_IN, e), po, mo, vo);
  __stcs(gr.p_out + e, po);
  __stcs(gr.mu_out + e, mo);
  __stcs(gr.nu_out + e, vo);
}

__global__ void __launch_bounds__(THREADS)
    adam_kernel(const __grid_constant__ Groups G) {
  const long long b = blockIdx.x;
  int k = 0;
  while (k + 1 < G.count && b >= G.block0[k + 1]) ++k;
  const Group& gr = G.grp[k];
  const long long start = (b - G.block0[k]) * CHUNK;
  const long long len = gr.n - start < CHUNK ? gr.n - start : CHUNK;
  long long tail = 0;
  if (gr.vec) {
    const int nv = (int)(len >> 2);
    float4 p[VEC], g[VEC], m[VEC], v[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int j = threadIdx.x + i * THREADS;
      if (j < nv) {
        const long long e = start + 4ll * j;
        p[i] = *reinterpret_cast<const float4*>(at(gr, P_IN, e));
        g[i] = *reinterpret_cast<const float4*>(at(gr, G_IN, e));
        m[i] = *reinterpret_cast<const float4*>(at(gr, MU_IN, e));
        v[i] = *reinterpret_cast<const float4*>(at(gr, NU_IN, e));
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int j = threadIdx.x + i * THREADS;
      if (j < nv) {
        const long long e = start + 4ll * j;
        float4 po, mo, vo;
        update(G, gr.lr, p[i].x, g[i].x, m[i].x, v[i].x, po.x, mo.x, vo.x);
        update(G, gr.lr, p[i].y, g[i].y, m[i].y, v[i].y, po.y, mo.y, vo.y);
        update(G, gr.lr, p[i].z, g[i].z, m[i].z, v[i].z, po.z, mo.z, vo.z);
        update(G, gr.lr, p[i].w, g[i].w, m[i].w, v[i].w, po.w, mo.w, vo.w);
        __stcs(reinterpret_cast<float4*>(gr.p_out + e), po);
        __stcs(reinterpret_cast<float4*>(gr.mu_out + e), mo);
        __stcs(reinterpret_cast<float4*>(gr.nu_out + e), vo);
      }
    }
    tail = (long long)nv * 4;
  }
  for (long long e = start + tail + threadIdx.x; e < start + len;
       e += THREADS)
    update_one(G, gr, e);
}

bool aligned(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

}  // namespace

// Adam on `stream` over n_groups (<= 16) groups; returns
// cudaGetLastError() as an int. ptrs holds 7 host pointers a group: p, g,
// mu, nu (read) and p_out, mu_out, nu_out (written, each [n]
// contiguous); sizes holds 9 a group: the element count n, then the row
// length and row stride in elements of p, g, mu and nu in turn (equal
// where the input is contiguous; a row length divides n); lrs one
// learning rate a group. The scalars are the plain version's float32
// constants: b1, 1 - b1, b2, 1 - b2, 1 / c1, 1 / c2 and eps.
extern "C" int gslidar_adam(int device, int n_groups, void* const* ptrs,
                            const long long* sizes, const float* lrs,
                            float b1, float omb1, float b2, float omb2,
                            float inv_c1, float inv_c2, float eps,
                            void* stream) {
  if (n_groups < 0 || n_groups > MAX_GROUPS)
    return (int)cudaErrorInvalidValue;
  Groups G{};
  G.count = n_groups;
  G.b1 = b1;
  G.omb1 = omb1;
  G.b2 = b2;
  G.omb2 = omb2;
  G.inv_c1 = inv_c1;
  G.inv_c2 = inv_c2;
  G.eps = eps;
  long long blocks = 0;
  for (int k = 0; k < n_groups; ++k) {
    Group& gr = G.grp[k];
    void* const* q = ptrs + 7 * k;
    const long long* z = sizes + (1 + 2 * INPUTS) * k;
    gr.n = z[0];
    if (gr.n < 0) return (int)cudaErrorInvalidValue;
    bool vec = true;
    for (int i = 0; i < INPUTS; ++i) {
      gr.in[i] = (const float*)q[i];
      gr.row[i] = z[1 + 2 * i];
      gr.stride[i] = z[2 + 2 * i];
      if (gr.row[i] <= 0 || gr.stride[i] < gr.row[i])
        return (int)cudaErrorInvalidValue;
      vec = vec && (gr.row[i] == gr.stride[i] ||
                    (gr.row[i] % 4 == 0 && gr.stride[i] % 4 == 0));
    }
    gr.p_out = (float*)q[4];
    gr.mu_out = (float*)q[5];
    gr.nu_out = (float*)q[6];
    gr.lr = lrs[k];
    for (int i = 0; i < 7; ++i) vec = vec && aligned(q[i]);
    gr.vec = vec ? 1 : 0;
    G.block0[k] = blocks;
    blocks += (gr.n + CHUNK - 1) / CHUNK;
  }
  for (int k = n_groups; k <= MAX_GROUPS; ++k) G.block0[k] = blocks;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  adam_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(G);
  return (int)cudaGetLastError();
}
