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
// The load it is built for: 1080p frames at the default front_stages 4
// (frontalface_alt on photo frames) leave about 300,000 survivors a frame
// (a tenth of the 2,246 x 1,280 canvas) that walk 2.9 tail stages each,
// 42 M stump votes a frame; they need a cap of 1,048,576 slots a frame, so
// 72% of the slots are padding, and at batch 8 a launch has 8.4 M slots.
// Shallow stages hold hundreds of thousands of windows, the deepest a
// handful.  Blocks of 16 slots (65,536 a frame, most of them padding) that
// stage patches in 76 KB of shared memory (2 blocks an SM) and sum votes
// in one warp took 1.48 ms a frame on the H100; this design 0.34.
// Design:
//   * a block takes a chunk of slots: a power of two from 16 to 512, the
//     smallest that keeps a launch to about 4,096 blocks (512 at batch 8
//     and cap 1,048,576: 16,384 blocks, two thirds of them padding; 16 at
//     batch 1 and cap 20,480).  It reads the slot indices coalesced,
//     writes the padding rows as 16-byte stores, and lists its windows
//     (ballot); a chunk of padding stops there.  Padding may sit anywhere:
//     only the pad index marks it;
//   * each stage runs over the block's live list, dealt round the 8 warps
//     in chunks, as in the front (haar_front.cu); the windows that pass are
//     appended to the other list, and the block stops at the stage where
//     its last window dies;
//   * lanes work in teams of 2^lg, chosen a stage from the block's own
//     live count: the fewest lanes a window that give every lane of the
//     block an item.  With many windows (lg = 0) a lane walks two windows
//     through the stage's stumps, as the front does; with fewer, a team
//     splits the stumps (member r takes r, r + 2^lg, ...), and with a
//     handful a warp takes one window, 64 stumps a round.  Each member
//     adds its team's votes of a round in classifier order (shuffles), so
//     every stage sum is ((0 + v_0) + v_1) + ... in __fadd_rn, the front's
//     sequence: bit-equal to the front and to tail2_plain.  One algorithm;
//     the team width is its one parameter, and the block sees it;
//   * the stumps (80 bytes each, every lane of a team-round reading the
//     same record where lg = 0) and the window corners come through L1.
//     Staging a stage's stumps in shared memory (two buffers, 34 KB for
//     frontalface_alt) measured slower: it took L1 from the corners, whose
//     working set (a 21-row band of the canvas) is the kernel's limit.
//     Shared memory is the chunk's window bases, vnf and two lists: 12
//     bytes a slot, 6 KB at 512; the registers (at most 64) allow 4 blocks
//     of 256 threads an SM.
// No scratch and no counter: a CUDA graph replays it.  The TPU kernel
// built a 21x21 integral patch per survivor and ran a HIGHEST-precision
// MXU stencil product for the node values; here each rect is four
// corners of the plane, differenced in int32.
//
// Node values.  The scale-1 weights carry the 1/area normalisation
// (compile.py at_scale), so node values are NOT integers and the stage
// sum's order matters in the last bit: the JAX tails sum in a
// matrix-product order and agree with this kernel up to f32 rounding
// noise in the stage sums.
#include <cuda_runtime.h>

#include "cascade.cuh"
#include "launch.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kQ = 2;                // items (window, stump) a lane a round
constexpr int kMinChunk = 16;        // slots a block
constexpr int kMaxChunk = 512;
constexpr int kTargetBlocks = 4096;  // a launch's blocks, where chunks allow
constexpr int kWarpLg = 6;           // lg of a team that is the whole warp
constexpr int kBlocksPerSm = 4;      // the register budget: 64 a thread

struct Tail2 {
  const int* sum;
  const float* vnf;
  const int* surv;
  const int* stumps;
  float4* out;
  int hv, wv, hp, wp, cap, n_table_stages, front_k;
  int chunk;  // slots a block
};

__device__ __forceinline__ float stump_vote(const int* nd, const int* p,
                                            int wp, float vnf) {
  // nr ya xa yb | xb ya xa yb | xb ya xa yb | xb w0 w1 w2 | thr l r 0
  const int4* g = reinterpret_cast<const int4*>(nd);
  return clfd_stump_vote<ClfdGlobal>(__ldg(g), __ldg(g + 1), __ldg(g + 2),
                                     __ldg(g + 3), __ldg(g + 4), p, wp, vnf);
}

// The stage sums of a lane's team: with lg <= 5 a team of G = 2^lg lanes
// walks kQ windows (p, v), member r voting stumps r, r + G, ...; with
// lg = kWarpLg the warp walks window 0, item q of lane l voting stump
// 32 q + l of each round of 64.  Every member adds the round's votes in
// classifier order, so each ends with ss = ((0 + v_0) + v_1) + ....
__device__ __forceinline__ void team_sums(const int* tab, int cnt, int lg,
                                          int lane, const int* const* p,
                                          int wp, const float* v, float* ss) {
#pragma unroll
  for (int q = 0; q < kQ; ++q) ss[q] = 0.0f;
  if (lg == kWarpLg) {
#pragma unroll 2
    for (int j0 = 0; j0 < cnt; j0 += 32 * kQ) {
      float vote[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        vote[q] = stump_vote(
            tab + min(j0 + 32 * q + lane, cnt - 1) * CLFD_STUMP_WORDS, p[0],
            wp, v[0]);
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int m_end = min(32, cnt - j0 - 32 * q);
        for (int m = 0; m < m_end; ++m)
          ss[0] = __fadd_rn(ss[0], __shfl_sync(0xffffffffu, vote[q], m));
      }
    }
    return;
  }
  const int G = 1 << lg;
  const int r = lane & (G - 1);
#pragma unroll 2
  for (int j0 = 0; j0 < cnt; j0 += G) {
    // the team's windows share each record: loaded once for both
    const int4* g = reinterpret_cast<const int4*>(
        tab + min(j0 + r, cnt - 1) * CLFD_STUMP_WORDS);
    const int4 g0 = __ldg(g), g1 = __ldg(g + 1), g2 = __ldg(g + 2);
    const int4 g3 = __ldg(g + 3), g4 = __ldg(g + 4);
    float vote[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      vote[q] = clfd_stump_vote<ClfdGlobal>(g0, g1, g2, g3, g4, p[q], wp,
                                            v[q]);
    if (lg == 0) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) ss[q] = __fadd_rn(ss[q], vote[q]);
    } else {
      const int m_end = min(G, cnt - j0);
      for (int m = 0; m < m_end; ++m) {
#pragma unroll
        for (int q = 0; q < kQ; ++q)
          ss[q] = __fadd_rn(ss[q], __shfl_sync(0xffffffffu, vote[q], m, G));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
tail2_kernel(const Tail2 a) {
  extern __shared__ int4 smem4[];
  __shared__ int s_cnt[3];
  int* s_base = reinterpret_cast<int*>(smem4);
  float* s_vnf = reinterpret_cast<float*>(s_base + a.chunk);
  unsigned short* src = reinterpret_cast<unsigned short*>(s_vnf + a.chunk);
  unsigned short* dst = src + a.chunk;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int b = blockIdx.y;
  const int slot0 = blockIdx.x * a.chunk;
  const int nslot = min(a.chunk, a.cap - slot0);
  const int S = a.n_table_stages;
  const int n = a.hv * a.wv;
  const size_t out0 = (size_t)b * a.cap + slot0;
  const int4* stages = reinterpret_cast<const int4*>(a.stumps);
  const int* nodes = a.stumps + S * CLFD_STAGE_WORDS;

  // list counters: the chunk's in s_cnt[2], stage k's survivors in
  // s_cnt[k % 3], zeroed by stage k - 1 (it was last read two barriers
  // before)
  if (threadIdx.x == 0) {
    s_cnt[0] = 0;
    s_cnt[2] = 0;
  }
  __syncthreads();

  // the chunk's slots, coalesced: padding rows written, windows listed
  // (a warp's 32 slots in order, the warps' runs as they come)
  for (int i0 = 0; i0 < nslot; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    const int idx = i < nslot ? __ldg(a.surv + out0 + i) : -1;
    const bool ok = idx >= 0 && idx < n;
    if (i < nslot && !ok)
      a.out[out0 + i] = make_float4(0.0f, 0.0f, (float)S, 0.0f);
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    int at = 0;
    if (lane == 0 && m) at = atomicAdd(&s_cnt[2], __popc(m));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (ok) {
      const int y = idx / a.wv;
      s_base[i] = y * a.wp + idx - y * a.wv;
      s_vnf[i] = __ldg(a.vnf + (size_t)b * n + idx);
      src[at + __popc(m & lt)] = (unsigned short)i;
    }
  }
  __syncthreads();
  int nl = s_cnt[2];
  if (nl == 0) return;
  if (a.front_k >= S) {                 // no stage left: every one passes
    for (int e = threadIdx.x; e < nl; e += kThreads) {
      const int s = src[e];
      a.out[out0 + s] = make_float4(s_vnf[s], 1.0f, (float)S, 0.0f);
    }
    return;
  }

  const int* frame = a.sum + (size_t)b * a.hp * a.wp;
  for (int st = a.front_k, k = 0; st < S; ++st, ++k) {
    const int4 sd = __ldg(stages + st);
    const int* tab = nodes + sd.x * CLFD_STUMP_WORDS;
    if (threadIdx.x == 0) s_cnt[(k + 1) % 3] = 0;
    const bool last = st == S - 1;
    const float thr = __int_as_float(sd.z);
    // the team width: the fewest lanes a window that give every lane an
    // item, a warp at the most
    int lg = 0;
    while (lg < kWarpLg && (nl << lg) < kThreads) ++lg;
    const int lg_lanes = min(lg, 5);
    const int teams = lg == kWarpLg ? 1 : 32 >> lg;
    const int per = lg == kWarpLg ? 1 : kQ * teams;  // windows a warp chunk
    const int team = lane >> lg_lanes;
    const int r = lane & ((1 << lg_lanes) - 1);
    for (int e0 = warp * per; e0 < nl; e0 += kWarps * per) {
      int s[kQ];
      bool has[kQ];
      const int* p[kQ];
      float v[kQ], ss[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int e = e0 + q * teams + team;
        has[q] = e < nl && (lg < kWarpLg || q == 0);
        s[q] = src[has[q] ? e : e0];
        p[q] = frame + s_base[s[q]];
        v[q] = s_vnf[s[q]];
      }
      team_sums(tab, sd.y, lg, lane, p, a.wp, v, ss);
      // the team's first lane writes exits and lists the survivors
      unsigned m[kQ];
      bool app[kQ];
      int kept = 0;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const bool pass = ss[q] >= thr;
        if (r == 0 && has[q] && (!pass || last))
          a.out[out0 + s[q]] = make_float4(v[q], pass ? 1.0f : 0.0f,
                                           pass ? (float)S : (float)st,
                                           ss[q]);
        app[q] = r == 0 && has[q] && pass && !last;
        m[q] = __ballot_sync(0xffffffffu, app[q]);
        kept += __popc(m[q]);
      }
      int at = 0;
      if (lane == 0 && kept) at = atomicAdd(&s_cnt[k % 3], kept);
      at = __shfl_sync(0xffffffffu, at, 0);
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        if (app[q]) dst[at + __popc(m[q] & lt)] = (unsigned short)s[q];
        at += __popc(m[q]);
      }
    }
    __syncthreads();
    nl = s_cnt[k % 3];
    unsigned short* t = src;
    src = dst;
    dst = t;
    if (nl == 0) break;
  }
}

}  // namespace

// The block's shared memory is laid out here alone: the chunk's window
// bases and vnf and two lists of its live slots, 12 bytes a slot.  Returns
// cudaErrorInvalidValue where that does not fit a block.
extern "C" int clfd_haar_tail2(const int* sum, const float* vnf,
                               const int* surv, const int* stumps,
                               float* out, int batch, int hv, int wv, int hp,
                               int wp, int cap, int n_table_stages,
                               int front_k, void* stream) {
  if (batch == 0 || cap == 0) return 0;
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
  a.chunk = kMinChunk;
  while (a.chunk < kMaxChunk
         && (long long)batch * cap > (long long)a.chunk * kTargetBlocks)
    a.chunk *= 2;
  const size_t smem = (size_t)a.chunk * 12;
  if (smem > (size_t)limits.block) return (int)cudaErrorInvalidValue;
  const dim3 grid((cap + a.chunk - 1) / a.chunk, batch);
  tail2_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
