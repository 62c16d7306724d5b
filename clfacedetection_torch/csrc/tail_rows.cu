// The v1 tail's decisions: classifier votes (CART walks), stage sums and
// the stage-tree path test, from the node values of haar_tail.cu (or of
// the "direct" strategy's stencil product), in tail2's row format:
// f32 [B, cap, 4] = (vnf, alive, exit stage, stage sum).
//
// No Pallas kernel of the JAX package computes this step: JAX runs it as
// XLA ops on the TPU tail kernel's output (_cart_votes and jnp.sum stage
// sums, clfacedetection_tpu/detect/pyramid.py:922-944, and the same in
// the XLA tail, pyramid.py:716-760).  Its plain PyTorch version is
// ops/tail_rows.py tail_rows_plain, and this kernel is bit-equal to it.
//
// Semantics, per slot (a slot index outside [0, Hv*Wv) is padding and
// writes (0, 0, n_stages, 0) without reading its values):
//   vote  = the CART walk from node 0:  go left iff node < thr * vnf
//           (the product rounded first), a link <= 0 is the leaf
//           alpha[-link];
//   ssum  = ((0 + vote_0) + vote_1) + ...  one __fadd_rn chain in
//           classifier order (the front's and tail2's order, so that the
//           front, the tails and the CPU agree bit for bit);
//   sequential cascades walk stages [s_lo, S): alive = every stage
//           passes, exit stage = the first failing one (S on a pass),
//           stage sum = that stage's (the last stage's on a pass);
//   stage trees evaluate every stage; a slot is accepted when some
//           root-to-leaf path passes all its stages: exit stage S, and
//           the stage sum of the first such path's leaf (path 0's when
//           none passes, with exit stage 0).
//
// What bounds it on the H100: the node values it reads.  A sequential
// cascade reads only the rows of the stages that its live survivors walk,
// so most survivors cost a few stages' values.  Design:
//   * a warp takes 32 slots; a warp of padding stores its rows and ends;
//   * per stage, the lanes split the stage's classifiers, 32 at a time: a
//     lane loads its classifier's record (thresholds, links, leaves; 64
//     bytes, the table's `rows` view) once and walks it for every live
//     slot of the warp, 8 (CART) or 16 (stumps) slots' node values in
//     flight at a time (the lanes read neighbouring columns of one row:
//     coalesced); the votes go to shared memory;
//   * then one lane a slot adds its 32 votes in classifier order into its
//     running stage sum: no tree reduction, no atomics;
//   * after each stage the slots that failed leave the warp's live list;
//     a warp ends when its last slot dies.  A stage tree keeps every
//     slot and, in shared memory, only the sums of its leaf stages.
// A warp keeps to itself (no block barrier), so its early end costs the
// block nothing; no scratch and no counter, so a CUDA graph replays it.
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// slots whose node values a lane has in flight at a time
template <int T>
constexpr int kUnroll = T == 1 ? 16 : 8;
constexpr int kVoteStride = 33; // a slot's row of 32 votes, made odd
constexpr int kRowWords = 16;   // a classifier's record in the rows view
constexpr int kMaxTreeStages = 64;
constexpr int kMaxLeaves = 32;

struct Rows {
  const float* values;   // [B, cap, nn]
  const float* svnf;     // [B, cap]
  const int* surv;       // [B, cap]
  const int* tab;        // rows view: S stage records, classifier records
  // stage trees: [n_paths] x (mask lo, mask hi, leaf index, 0), then
  // [n_stages] each stage's leaf index (-1 for no path's leaf)
  const int* paths;
  float4* out;           // [B, cap]
  int cap, nn, n, n_stages, s_lo, n_paths;
  int n_leaves;          // stage trees: distinct leaf stages
  int warp_words;        // a warp's shared memory, in 4-byte words
};

__device__ __forceinline__ float pick3(float a, float b, float c, int i) {
  return i == 0 ? a : (i == 1 ? b : c);
}

__device__ __forceinline__ int pick3(int a, int b, int c, int i) {
  return i == 0 ? a : (i == 1 ? b : c);
}

// One classifier's vote from its T node values `v` (its record unpacked
// into registers), exactly as tail_rows_plain's _cart_votes walks it.
template <int T>
__device__ __forceinline__ float vote(const float* v, float vnf,
                                      const float* thr, const int* left,
                                      const int* right, const float* alpha) {
  int node = 0;
#pragma unroll
  for (int step = 0; step < T; ++step) {
    float nv, th;
    int l, r;
    if constexpr (T == 1) {
      nv = v[0];
      th = thr[0];
      l = left[0];
      r = right[0];
    } else {
      nv = pick3(v[0], v[1], v[T - 1], node);
      th = pick3(thr[0], thr[1], thr[2], node);
      l = pick3(left[0], left[1], left[2], node);
      r = pick3(right[0], right[1], right[2], node);
    }
    const int next = nv < __fmul_rn(th, vnf) ? l : r;
    if (next <= 0) {
      const int leaf = min(-next, T);
      return leaf == 0 ? alpha[0]
             : leaf == 1 ? alpha[1]
             : leaf == 2 ? alpha[2] : alpha[3];
    }
    node = min(next, T - 1);
  }
  return 0.0f;  // not reached: links point forward (the host checks)
}

template <int T, bool kTree>
__global__ void __launch_bounds__(kThreads) rows_kernel(const Rows a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* s_votes = smem + warp * a.warp_words;
  float* s_vnf = s_votes + 32 * kVoteStride;
  int* s_list = reinterpret_cast<int*>(s_vnf + 32);
  float* s_sums = reinterpret_cast<float*>(s_list + 32);
  const unsigned lt = (1u << lane) - 1u;
  const int S = a.n_stages;
  const int b = blockIdx.y;
  const int slot0 = (blockIdx.x * kWarps + warp) * 32;
  const size_t o0 = (size_t)b * a.cap + slot0;
  const bool mine = slot0 + lane < a.cap;
  const int idx = mine ? __ldg(a.surv + o0 + lane) : -1;
  const bool ok = idx >= 0 && idx < a.n;
  if (mine && !ok)
    a.out[o0 + lane] = make_float4(0.0f, 0.0f, (float)S, 0.0f);
  unsigned live = __ballot_sync(0xffffffffu, ok);
  if (live == 0) return;
  const float vnf = ok ? __ldg(a.svnf + o0 + lane) : 0.0f;
  if (!kTree && a.s_lo >= S) {          // no stage left: every one passes
    if (ok) a.out[o0 + lane] = make_float4(vnf, 1.0f, (float)S, 0.0f);
    return;
  }
  s_vnf[lane] = vnf;
  const float* rows = a.values + o0 * a.nn;
  const int4* stages = reinterpret_cast<const int4*>(a.tab);
  const int* clfs = a.tab + 4 * S;
  unsigned long long passed = 0ull;

  for (int st = kTree ? 0 : a.s_lo; st < S; ++st) {
    const int4 sd = __ldg(stages + st);   // first classifier, count, thr
    const bool in = (live >> lane) & 1u;
    if (in) s_list[__popc(live & lt)] = lane;
    const int nl = __popc(live);
    __syncwarp();
    float ssum = 0.0f;
    for (int c0 = 0; c0 < sd.y; c0 += 32) {
      // this lane's classifier: thresholds, links and leaves in registers
      const int c = sd.x + min(c0 + lane, sd.y - 1);
      const int4* rec = reinterpret_cast<const int4*>(clfs + c * kRowWords);
      const int4 r0 = __ldg(rec), r1 = __ldg(rec + 1);
      const int4 r2 = __ldg(rec + 2), r3 = __ldg(rec + 3);
      // thr0 thr1 thr2 left0 | left1 left2 right0 right1 |
      // right2 alpha0 alpha1 alpha2 | alpha3 0 0 0
      const float thr[3] = {__int_as_float(r0.x), __int_as_float(r0.y),
                            __int_as_float(r0.z)};
      const int left[3] = {r0.w, r1.x, r1.y};
      const int right[3] = {r1.z, r1.w, r2.x};
      const float alpha[4] = {__int_as_float(r2.y), __int_as_float(r2.z),
                              __int_as_float(r2.w), __int_as_float(r3.x)};
      const float* col = rows + (size_t)c * T;
      for (int i = 0; i < nl; i += kUnroll<T>) {
        float v[kUnroll<T>][T];
        int k[kUnroll<T>];
#pragma unroll
        for (int q = 0; q < kUnroll<T>; ++q) {
          k[q] = s_list[min(i + q, nl - 1)];
          const float* p = col + (size_t)k[q] * a.nn;
#pragma unroll
          for (int t = 0; t < T; ++t) v[q][t] = __ldg(p + t);
        }
#pragma unroll
        for (int q = 0; q < kUnroll<T>; ++q) {
          const float x = vote<T>(v[q], s_vnf[k[q]], thr, left, right,
                                  alpha);
          if (i + q < nl) s_votes[k[q] * kVoteStride + lane] = x;
        }
      }
      __syncwarp();
      if (in) {
        const float* v = s_votes + lane * kVoteStride;
        const int m = min(32, sd.y - c0);
        for (int j = 0; j < m; ++j) ssum = __fadd_rn(ssum, v[j]);
      }
      __syncwarp();
    }
    const bool pass = ssum >= __int_as_float(sd.z);
    if (kTree) {
      const int li = __ldg(a.paths + 4 * a.n_paths + st);
      if (in) {
        if (li >= 0) s_sums[lane * a.n_leaves + li] = ssum;
        if (pass) passed |= 1ull << st;
      }
    } else {
      if (in && (!pass || st == S - 1))
        a.out[o0 + lane] = make_float4(vnf, pass ? 1.0f : 0.0f,
                                       pass ? (float)S : (float)st, ssum);
      live = __ballot_sync(0xffffffffu, in && pass);
      if (live == 0) return;
    }
  }
  if (kTree && ok) {
    int first = -1;
    for (int p = 0; p < a.n_paths && first < 0; ++p) {
      const int4 pr = __ldg(reinterpret_cast<const int4*>(a.paths) + p);
      const unsigned long long mask =
          (unsigned long long)(unsigned)pr.x
          | ((unsigned long long)(unsigned)pr.y << 32);
      if ((mask & ~passed) == 0ull) first = p;
    }
    const int li = __ldg(a.paths + 4 * max(first, 0) + 2);
    const bool acc = first >= 0;
    a.out[o0 + lane] = make_float4(vnf, acc ? 1.0f : 0.0f,
                                   acc ? (float)S : 0.0f,
                                   s_sums[lane * a.n_leaves + li]);
  }
}

template <int T, bool kTree>
int launch(const Rows& a, int batch, cudaStream_t stream) {
  static ClfdSmem smem_limits;
  ClfdSmemLimits limits;
  const cudaError_t e =
      smem_limits.ready((const void*)rows_kernel<T, kTree>, &limits);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)kWarps * a.warp_words * 4;
  if (smem > (size_t)limits.block) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.cap + kThreads - 1) / kThreads, batch);
  rows_kernel<T, kTree><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// A warp's shared memory is laid out here alone: 32 rows of votes, the
// slots' vnf and live list, and for stage trees each slot's sums of the
// leaf stages.  `paths` is null for sequential cascades.  Returns
// cudaErrorInvalidValue for T outside 1..3, a stage tree of more than 64
// stages or 32 leaf stages, or a block that does not fit.
extern "C" int clfd_tail_rows(const float* values, const float* svnf,
                              const int* surv, const int* tab,
                              const int* paths, float* out, int batch,
                              int cap, int nn, int n, int n_stages, int t,
                              int s_lo, int n_paths, int n_leaves,
                              void* stream) {
  const bool tree = paths != nullptr;
  if (t < 1 || t > 3 ||
      (tree && (n_stages > kMaxTreeStages || n_paths < 1 || n_leaves < 1 ||
                n_leaves > kMaxLeaves)))
    return (int)cudaErrorInvalidValue;
  if (cap == 0 || batch == 0) return 0;
  Rows a;
  a.values = values;
  a.svnf = svnf;
  a.surv = surv;
  a.tab = tab;
  a.paths = paths;
  a.out = reinterpret_cast<float4*>(out);
  a.cap = cap;
  a.nn = nn;
  a.n = n;
  a.n_stages = n_stages;
  a.s_lo = s_lo;
  a.n_paths = n_paths;
  a.n_leaves = n_leaves;
  a.warp_words = 32 * kVoteStride + 64 + (tree ? 32 * n_leaves : 0);
  const cudaStream_t s = (cudaStream_t)stream;
  if (tree) {
    return t == 1 ? launch<1, true>(a, batch, s)
         : t == 2 ? launch<2, true>(a, batch, s)
                  : launch<3, true>(a, batch, s);
  }
  return t == 1 ? launch<1, false>(a, batch, s)
       : t == 2 ? launch<2, false>(a, batch, s)
                : launch<3, false>(a, batch, s);
}
