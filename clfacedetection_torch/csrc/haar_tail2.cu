// Survivor tail: the cascade walk over stages [front_k, n_stages) for every
// compacted front survivor, with early exit.
//
// Replaces the TPU kernel clfacedetection_tpu/ops/haar_tail2.py
// build_tail2_kernel (pallas_call at haar_tail2.py:326).  Output per slot
// is the TPU kernel's lanes 0-3 (haar_tail2.py:254-291): vnf, alive, exit
// stage (n_stages when the window passes), and the stage sum of the last
// stage entered.  Slots padded with an index outside [0, Hv*Wv) (the
// compaction pads with Hv*Wv) write (0, 0, n_stages, 0).
//
// What bounds it on the H100: latency, not work.  The walk's operations
// take under 0.002 ms of the card; the first design (one thread a survivor
// slot, walking its stages stump after stump) took 0.67 ms at 1080p: 640
// warps on 132 SMs, each waiting on a chain of table and corner loads, and
// a warp lived as long as its longest-lived lane.  Design:
//   * a block takes a chunk of kChunk slots.  Its first warp lists the
//     chunk's survivors (ballot); padding costs its index load and one
//     store a slot, and a chunk of padding stages nothing;
//   * the survivors' window patches (the `sum` entries their corners
//     read) and each stage's stumps (the 80-byte stump view) sit in shared
//     memory, copied with cp.async; the next stage's stumps are copied
//     while the current stage runs (double buffer);
//   * inside a stage the lanes split the (survivor, stump) pairs: a warp
//     takes 32 stumps of one survivor (two such units at a time, their
//     loads in flight together), and each lane writes its vote to shared
//     memory.  Then one lane a survivor sums that survivor's votes
//     in classifier order from 0, the same __fadd_rn sequence as the
//     front's walk (cascade.cuh), so the tail agrees bit for bit with the
//     front and with tail2_plain; no tree reduction, no atomics;
//   * the survivors that pass are listed again (ballot) for the next
//     stage, so lanes only ever run live survivors, and a block stops at
//     the stage where its last survivor dies.
// Small chunks give many blocks (485 at 1080p, batch 1, 7,759 survivors)
// and the hardware's block scheduler spreads them over the SMs, so the
// kernel keeps no counter and no scratch and replays from a CUDA graph.
// The TPU kernel built a 21x21 integral patch per survivor and ran a
// HIGHEST-precision MXU stencil product for the node values; here each
// rect is four corners of the patch, differenced in int32.
//
// Node values.  The scale-1 weights carry the 1/area normalisation
// (compile.py at_scale), so node values are NOT integers and the stage
// sum's order matters in the last bit: the JAX tails sum in a
// matrix-product order and agree with this kernel up to f32 rounding
// noise in the stage sums.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "cascade.cuh"
#include "launch.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 16;  // slots a block
constexpr int kUnits = 2;   // (survivor, 32 stumps) units a warp at a time
static_assert(kChunk <= 32, "the first warp lists the chunk, a lane a slot");

struct Tail2 {
  const int* sum;
  const float* vnf;
  const int* surv;
  const int* stumps;
  float4* out;
  int hv, wv, hp, wp, cap, n_table_stages, front_k;
  int ph, pw;         // a survivor's patch: rows and columns (its pitch)
  int max_cnt;        // the largest stage of [front_k, n_table_stages)
  int vstride;        // a survivor's row of votes: max_cnt, made odd
};

// cp.async copies of stage record `sd`'s stumps to `dst` (16-byte groups:
// every stump record starts on one)
__device__ __forceinline__ void copy_stage(int* dst, const Tail2& a,
                                           int4 sd) {
  const int* src = a.stumps + a.n_table_stages * CLFD_STAGE_WORDS
                 + sd.x * CLFD_STUMP_WORDS;
  for (int i = threadIdx.x; i < sd.y * (CLFD_STUMP_WORDS / 4);
       i += kThreads)
    __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
}

__global__ void __launch_bounds__(kThreads) tail2_kernel(const Tail2 a) {
  extern __shared__ int4 smem4[];
  int* s_tab = reinterpret_cast<int*>(smem4);          // 2 stages' stumps
  int* s_patch = s_tab + 2 * a.max_cnt * CLFD_STUMP_WORDS;
  float* s_votes = reinterpret_cast<float*>(s_patch
                                            + kChunk * a.ph * a.pw);
  __shared__ float s_vnf[kChunk];
  __shared__ int s_base[kChunk];
  __shared__ int s_list[2][kChunk];   // live survivors, by chunk slot
  __shared__ int s_n;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int b = blockIdx.y;
  const int slot0 = blockIdx.x * kChunk;
  const int S = a.n_table_stages;
  const int n = a.hv * a.wv;
  const size_t out0 = (size_t)b * a.cap + slot0;

  if (warp == 0) {
    const bool mine = lane < kChunk && slot0 + lane < a.cap;
    const int idx = mine ? __ldg(a.surv + out0 + lane) : -1;
    const bool ok = idx >= 0 && idx < n;
    if (mine && !ok)
      a.out[out0 + lane] = make_float4(0.0f, 0.0f, (float)S, 0.0f);
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    if (ok) {
      const int y = idx / a.wv;
      s_list[0][__popc(m & lt)] = lane;
      s_vnf[lane] = __ldg(a.vnf + (size_t)b * n + idx);
      s_base[lane] = y * a.wp + idx - y * a.wv;
    }
    if (lane == 0) s_n = __popc(m);
  }
  __syncthreads();
  int nl = s_n;
  if (nl == 0) return;
  if (a.front_k >= S) {                 // no stage left: every one passes
    if (threadIdx.x < nl) {
      const int s = s_list[0][threadIdx.x];
      a.out[out0 + s] = make_float4(s_vnf[s], 1.0f, (float)S, 0.0f);
    }
    return;
  }

  // the survivors' patches and the first stage's stumps
  {
    const int* frame = a.sum + (size_t)b * a.hp * a.wp;
    for (int r = warp; r < nl * a.ph; r += kWarps) {
      const int k = r / a.ph;
      const int row = r - k * a.ph;
      const int s = s_list[0][k];
      const int* src = frame + s_base[s] + row * a.wp;
      int* dst = s_patch + (s * a.ph + row) * a.pw;
      for (int c = lane; c < a.pw; c += 32)
        __pipeline_memcpy_async(dst + c, src + c, 4);
    }
  }
  copy_stage(s_tab, a, __ldg(reinterpret_cast<const int4*>(a.stumps)
                             + a.front_k));
  __pipeline_commit();

  const int tab_words = a.max_cnt * CLFD_STUMP_WORDS;
  int cur = 0;
  for (int st = a.front_k; st < S; ++st) {
    const int half = (st - a.front_k) & 1;
    const int4 sd = __ldg(reinterpret_cast<const int4*>(a.stumps) + st);
    if (st + 1 < S)
      copy_stage(s_tab + (half ^ 1) * tab_words, a,
                 __ldg(reinterpret_cast<const int4*>(a.stumps) + st + 1));
    __pipeline_commit();
    __pipeline_wait_prior(1);           // this stage's stumps, the patches
    __syncthreads();

    // votes: a warp takes 32 stumps of one survivor, a lane one stump,
    // and kUnits such units at a time (their loads in flight together;
    // a unit past the end repeats a valid pair and stores nothing)
    const int* tab = s_tab + half * tab_words;
    const int nb = (sd.y + 31) >> 5;
    for (int u0 = warp; u0 < nl * nb; u0 += kUnits * kWarps) {
      float vote[kUnits];
      int at[kUnits];
#pragma unroll
      for (int q = 0; q < kUnits; ++q) {
        const int u = min(u0 + q * kWarps, nl * nb - 1);
        const int k = u / nb;
        const int j = (u - k * nb) * 32 + lane;
        const int s = s_list[cur][k];
        const int* nd = tab + min(j, sd.y - 1) * CLFD_STUMP_WORDS;
        vote[q] = clfd_stump_vote<ClfdShared>(
            ClfdShared::ld4(nd), ClfdShared::ld4(nd + 4),
            ClfdShared::ld4(nd + 8), ClfdShared::ld4(nd + 12),
            ClfdShared::ld4(nd + 16), s_patch + s * a.ph * a.pw, a.pw,
            s_vnf[s]);
        at[q] = u0 + q * kWarps < nl * nb && j < sd.y ? s * a.vstride + j
                                                       : -1;
      }
#pragma unroll
      for (int q = 0; q < kUnits; ++q)
        if (at[q] >= 0) s_votes[at[q]] = vote[q];
    }
    __syncthreads();

    // stage sums in classifier order, a lane a survivor; the survivors
    // that pass are listed for the next stage
    if (warp == 0) {
      bool pass = false;
      int s = 0;
      if (lane < nl) {
        s = s_list[cur][lane];
        const float* v = s_votes + s * a.vstride;
        float ssum = 0.0f;
#pragma unroll 8
        for (int j = 0; j < sd.y; ++j) ssum = __fadd_rn(ssum, v[j]);
        pass = ssum >= __int_as_float(sd.z);
        if (!pass || st == S - 1)
          a.out[out0 + s] = make_float4(s_vnf[s], pass ? 1.0f : 0.0f,
                                        pass ? (float)S : (float)st, ssum);
      }
      const unsigned m = __ballot_sync(0xffffffffu, pass);
      if (pass) s_list[cur ^ 1][__popc(m & lt)] = s;
      if (lane == 0) s_n = __popc(m);
    }
    __syncthreads();
    nl = s_n;
    cur ^= 1;
    if (nl == 0) break;
  }
  __pipeline_wait_prior(0);
}

}  // namespace

// The block's shared memory is laid out here alone: two stages' stumps
// (`max_cnt`, the largest stage of [front_k, n_table_stages), each), the
// chunk's window patches of `ph` x `pw` entries and its rows of votes.
// Returns cudaErrorInvalidValue where that does not fit a block.
extern "C" int clfd_haar_tail2(const int* sum, const float* vnf,
                               const int* surv, const int* stumps,
                               float* out, int batch, int hv, int wv, int hp,
                               int wp, int cap, int n_table_stages,
                               int front_k, int ph, int pw, int max_cnt,
                               void* stream) {
  static ClfdSmem smem_limits;
  ClfdSmemLimits limits;
  const cudaError_t e =
      smem_limits.ready((const void*)tail2_kernel, &limits);
  if (e != cudaSuccess) return (int)e;
  Tail2 a;
  a.sum = sum;
  a.vnf = vnf;
  a.surv = surv;
  a.stumps = stumps;
  a.out = reinterpret_cast<float4*>(out);
  a.hv = hv;
  a.wv = wv;
  a.hp = hp;
  a.wp = wp;
  a.cap = cap;
  a.n_table_stages = n_table_stages;
  a.front_k = front_k;
  a.ph = ph;
  a.pw = pw;
  a.max_cnt = max_cnt;
  a.vstride = max_cnt | 1;   // odd: the lanes' rows fall on other banks
  const size_t smem = ((size_t)2 * max_cnt * CLFD_STUMP_WORDS
                       + (size_t)kChunk * ph * pw
                       + (size_t)kChunk * a.vstride) * 4;
  if (smem > (size_t)limits.block) return (int)cudaErrorInvalidValue;
  const dim3 grid((cap + kChunk - 1) / kChunk, batch);
  tail2_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
