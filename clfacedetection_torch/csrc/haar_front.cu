// Dense front-stage Haar evaluation over the packed pyramid canvas.
//
// Replaces the TPU kernel clfacedetection_tpu/ops/haar_front.py
// build_front_kernel (pallas_call at haar_front.py:252).  For every canvas
// position it writes the variance factor vnf and whether the window
// passes the visit lattice and stages [0, front_k).
//
// What bounds it on the H100: integer loads.  Each node reads 8 or 12
// plane entries; a position alive through all 10 front stages of
// frontalface_alt reads ~4,000.  Most positions die in the first three
// stages, so the work is dominated by the ~20 stumps those stages hold.
// Design: one thread per position, 32 consecutive columns per warp, so
// every corner load of a warp is one coalesced 128-byte row segment
// (neighbouring windows share corners, so L1/L2 serve most of them); the
// cascade table is read warp-uniformly.  A thread stops at its first
// failing stage, which gives the same mask as ANDing every stage (the
// TPU kernel's tile gating, haar_front.py:222-228, is the same idea per
// tile).  No shared memory yet: staging tiles there is left for later.
//
// CART cascades: each thread walks its classifier's tree from node 0 and
// evaluates only the nodes on its path (JAX evaluates every node and
// selects; the vote is the same).  Tilted nodes read the optional fourth
// plane, the RSAT integral, with the same generic four-corner int32 form.
//
// Numerics (bit-equal to the JAX f32 XLA front): int32 rect sums, cast to
// f32 after the differences; mean = win_sum*inv; the variance is ONE
// fused multiply-add, var = fma(win_sq, inv, -(mean*mean)), because that
// is what XLA:CPU emits for `win_sq*inv - mean*mean`; every other
// operation is separately rounded (__fmul_rn/__fadd_rn, -fmad=false).
#include <cuda_runtime.h>

#include "cascade.cuh"

namespace {

constexpr int kTW = 32;  // threads along x (one warp)
constexpr int kTH = 8;   // threads along y

__global__ void __launch_bounds__(kTW * kTH)
front_kernel(const int* __restrict__ sum, const int* __restrict__ sqhi,
             const int* __restrict__ sqlo, const int* __restrict__ tilted,
             const unsigned char* __restrict__ visit,
             const int* __restrict__ table, unsigned char* __restrict__ front,
             float* __restrict__ vnf_out, int hv, int wv, int hp, int wp,
             int n_table_stages, int front_k, int eya, int exa, int eyb,
             int exb, float inv) {
  const int x = blockIdx.x * kTW + threadIdx.x;
  const int y = blockIdx.y * kTH + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= wv || y >= hv) return;
  const size_t plane = (size_t)b * hp * wp + (size_t)y * wp + x;
  const size_t out = (size_t)b * hv * wv + (size_t)y * wv + x;
  const int* ps = sum + plane;
  const int* pt = tilted ? tilted + plane : nullptr;

  const float win_sum = (float)clfd_rect(ps, wp, eya, exa, eyb, exb);
  const float hi = (float)clfd_rect(sqhi + plane, wp, eya, exa, eyb, exb);
  const float lo = (float)clfd_rect(sqlo + plane, wp, eya, exa, eyb, exb);
  const float win_sq = __fadd_rn(__fmul_rn(hi, 256.0f), lo);
  const float mean = __fmul_rn(win_sum, inv);
  const float var = __fmaf_rn(win_sq, inv, -__fmul_rn(mean, mean));
  const float vnf = var >= 0.0f ? __fsqrt_rn(var) : 1.0f;
  vnf_out[out] = vnf;

  bool alive = visit[(size_t)y * wv + x] != 0;
  for (int st = 0; st < front_k && alive; ++st) {
    const float ssum = clfd_stage_sum(table, n_table_stages, st, ps, pt, wp,
                                      vnf);
    alive = ssum >= clfd_stage_threshold(table, st);
  }
  front[out] = alive ? 1 : 0;
}

}  // namespace

extern "C" int clfd_haar_front(const int* sum, const int* sqhi,
                               const int* sqlo, const int* tilted,
                               const unsigned char* visit,
                               const int* table, unsigned char* front,
                               float* vnf, int batch, int hv, int wv, int hp,
                               int wp, int n_table_stages, int front_k,
                               int eya, int exa, int eyb, int exb, float inv,
                               void* stream) {
  const dim3 block(kTW, kTH);
  const dim3 grid((wv + kTW - 1) / kTW, (hv + kTH - 1) / kTH, batch);
  front_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      sum, sqhi, sqlo, tilted, visit, table, front, vnf, hv, wv, hp, wp,
      n_table_stages, front_k, eya, exa, eyb, exb, inv);
  return (int)cudaGetLastError();
}
