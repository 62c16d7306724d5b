// v1 survivor tail: the value of EVERY node of the cascade for every
// compacted front survivor, [B, cap, n_clf * T] float32.
//
// Replaces the TPU kernel clfacedetection_tpu/ops/haar_tail.py
// build_tail_kernel (pallas_call at haar_tail.py:310).  As there, votes,
// CART walks, stage sums and stage-tree path masks run outside the kernel
// on its output (clfacedetection_torch/detect/pyramid.py).  Node (c, t) is
// column c * T + t; nodes a classifier does not have are 0; slots padded
// with an index outside [0, Hv*Wv) are 0 in every column.
//
// What bounds it on the H100: the output.  Every slot writes all n_clf * T
// values (168 MB for frontalface_alt2 at 20,480 slots); the inputs it
// needs are a small patch per survivor.  The TPU kernel banded the canvas
// into VMEM, packed 32/64-lane patches and ran a HIGHEST-precision MXU
// product with a stencil matrix.  Here a block takes kSlots survivor slots,
// stages each survivor's (h0+1) x (w0+1) sum patch (and tilted patch) in
// shared memory, and its threads stride over the nodes: each thread loads
// its node's descriptor from the table once into registers and evaluates
// it for every slot of the block, so the writes along the node axis are
// coalesced and the table is read once per block.  No bands, no lane
// packing, no matrix product.
//
// Numerics: a rect is the int32 difference of its four corners in the raw
// plane patch (exact for upright and tilted corners; the TPU kernel's
// patch corrections exist only to keep f32 matrix products exact), cast to
// f32, times its weight, summed in rect order, every operation separately
// rounded (-fmad=false).  This is the front's node value (cascade.cuh), so
// the kernel is bit-equal to tail_values_plain.
#include <cuda_runtime.h>

#include "cascade.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 8;  // survivor slots per block

__global__ void __launch_bounds__(kThreads)
tail_kernel(const int* __restrict__ sum, const int* __restrict__ tilted,
            const int* __restrict__ surv, const int* __restrict__ table,
            float* __restrict__ out, int hv, int wv, int hp, int wp, int cap,
            int n_table_stages, int n_clf, int T, int ph, int pw) {
  extern __shared__ int patch[];  // [kSlots][n_planes][ph * pw]
  __shared__ int s_valid[kSlots];
  const int b = blockIdx.y;
  const int slot0 = blockIdx.x * kSlots;
  const int n = hv * wv;
  const int P = ph * pw;
  const int n_planes = tilted ? 2 : 1;
  const size_t plane0 = (size_t)b * hp * wp;

  for (int s = 0; s < kSlots; ++s) {
    const int slot = slot0 + s;
    const int idx = slot < cap ? surv[(size_t)b * cap + slot] : -1;
    const bool ok = idx >= 0 && idx < n;
    if (threadIdx.x == 0) s_valid[s] = ok;
    if (!ok) continue;               // idx is the same for every thread
    const int y = idx / wv;
    const int x = idx - y * wv;
    const size_t base = plane0 + (size_t)y * wp + x;
    int* dst = patch + s * n_planes * P;
    for (int i = threadIdx.x; i < P; i += kThreads) {
      const int dy = i / pw;
      const int dx = i - dy * pw;
      dst[i] = __ldg(sum + base + (size_t)dy * wp + dx);
      if (tilted) dst[P + i] = __ldg(tilted + base + (size_t)dy * wp + dx);
    }
  }
  __syncthreads();

  const int nn = n_clf * T;
  const int* clfs = table + n_table_stages * CLFD_STAGE_WORDS;
  const int clf_words = __ldg(table + 3);  // every stage record holds it
  for (int col = threadIdx.x; col < nn; col += kThreads) {
    const int c = col / T;
    const int t = col - c * T;
    const int* nd = clfs + c * clf_words + CLFD_CLF_HEAD
                  + t * CLFD_NODE_WORDS;
    // the node's descriptor, once, in registers: corner offsets into the
    // patch (the tilted patch follows the sum patch) and weights
    const int nr = __ldg(nd + 0);
    const int poff = __ldg(nd + 1) ? P : 0;
    int off[3][4];
    float w[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      w[k] = __int_as_float(__ldg(nd + 5 + k));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        off[k][j] = poff + __ldg(nd + 8 + 8 * k + 2 * j) * pw
                  + __ldg(nd + 9 + 8 * k + 2 * j);
      }
    }
    for (int s = 0; s < kSlots; ++s) {
      const int slot = slot0 + s;
      if (slot >= cap) break;
      float nv = 0.0f;
      if (s_valid[s]) {
        const int* p = patch + s * n_planes * P;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          if (k < nr) {
            const int rs = p[off[k][0]] - p[off[k][1]] - p[off[k][2]]
                         + p[off[k][3]];
            const float term = __fmul_rn((float)rs, w[k]);
            nv = (k == 0) ? term : __fadd_rn(nv, term);
          }
        }
      }
      out[((size_t)b * cap + slot) * nn + col] = nv;
    }
  }
}

}  // namespace

extern "C" int clfd_haar_tail(const int* sum, const int* tilted,
                              const int* surv, const int* table, float* out,
                              int batch, int hv, int wv, int hp, int wp,
                              int cap, int n_table_stages, int n_clf, int T,
                              int ph, int pw, void* stream) {
  const size_t smem = (size_t)kSlots * (tilted ? 2 : 1) * ph * pw
                    * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((cap + kSlots - 1) / kSlots, batch);
  tail_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      sum, tilted, surv, table, out, hv, wv, hp, wp, cap, n_table_stages,
      n_clf, T, ph, pw);
  return (int)cudaGetLastError();
}
