// Survivor tail: the cascade walk over stages [front_k, n_stages) for every
// compacted front survivor, with early exit.
//
// Replaces the TPU kernel clfacedetection_tpu/ops/haar_tail2.py
// build_tail2_kernel (pallas_call at haar_tail2.py:326).  Output per slot
// is the TPU kernel's lanes 0-3 (haar_tail2.py:254-291): vnf, alive, exit
// stage (n_stages when the window passes), and the stage sum of the last
// stage entered.  Slots padded with n = Hv*Wv write (0, 0, n_stages, 0).
//
// What bounds it on the H100: scattered integral loads.  Survivors are
// spread over the canvas, so each node's corner loads hit scattered cache
// lines; the tail of frontalface_alt holds 1,751 stumps.  Design: one
// thread per survivor slot, the table's compact stump view (cascade.cuh)
// read warp-uniformly, and early exit at the first failing stage (most
// survivors die within the first two tail stages).  The TPU kernel built
// a 21x21 integral patch per survivor and ran a HIGHEST-precision MXU
// stencil product for the node values; a GPU thread reads the four
// corners of each rect straight from the integral plane instead, so no
// patch and no matrix product exist.
//
// Node values.  The raw rect weights of the four cascades this path
// serves (eye, frontalface_alt, frontalface_default, profileface) are
// exactly {-1, 0, 2, 3} (np.unique(spec.rect_weight)), but the scale-1
// weights the detector uses carry the 1/area normalisation
// (compile.py at_scale), so node values are NOT integers and their
// summation order matters in the last bit.  This kernel uses the front's
// order (cascade.cuh clfd_stump_stage_sum), which the plain version
// repeats bit for bit; the JAX tails sum in a matrix-product order, so
// they agree with this kernel up to f32 rounding noise in the stage sums.
#include <cuda_runtime.h>

#include "cascade.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
tail2_kernel(const int* __restrict__ sum, const float* __restrict__ vnf,
             const int* __restrict__ surv, const int* __restrict__ stumps,
             float4* __restrict__ out, int hv, int wv, int hp, int wp,
             int cap, int n_table_stages, int front_k) {
  const int slot = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (slot >= cap) return;
  const int n = hv * wv;
  const size_t o = (size_t)b * cap + slot;
  const int idx = surv[o];
  if (idx < 0 || idx >= n) {
    out[o] = make_float4(0.0f, 0.0f, (float)n_table_stages, 0.0f);
    return;
  }
  const int y = idx / wv;
  const int x = idx - y * wv;
  const float v = vnf[(size_t)b * n + idx];
  const int* p = sum + (size_t)b * hp * wp + (size_t)y * wp + x;
  float alive = 1.0f;
  float level = (float)n_table_stages;
  float weight = 0.0f;
  for (int st = front_k; st < n_table_stages; ++st) {
    const float ssum = clfd_stump_stage_sum(stumps, n_table_stages, st, p,
                                            wp, v);
    weight = ssum;
    if (!(ssum >= clfd_stage_threshold(stumps, st))) {
      level = (float)st;
      alive = 0.0f;
      break;
    }
  }
  out[o] = make_float4(v, alive, level, weight);
}

}  // namespace

extern "C" int clfd_haar_tail2(const int* sum, const float* vnf,
                               const int* surv, const int* stumps, float* out,
                               int batch, int hv, int wv, int hp, int wp,
                               int cap, int n_table_stages, int front_k,
                               void* stream) {
  const dim3 grid((cap + kThreads - 1) / kThreads, batch);
  tail2_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      sum, vnf, surv, stumps, reinterpret_cast<float4*>(out), hv, wv, hp, wp,
      cap, n_table_stages, front_k);
  return (int)cudaGetLastError();
}
