// The v1 route's tail in one kernel: each survivor's CART, tilted and
// stage-tree stages walked from the integral planes, in tail2's row format
// f32 [B, cap, 4] = (vnf, alive, exit stage, stage sum).
//
// Replaces, on the default strategy, the pair haar_tail.cu (every node's
// value, the port of clfacedetection_tpu/ops/haar_tail.py
// build_tail_kernel, pallas_call at haar_tail.py:310) then tail_rows.cu
// (votes, stage sums and paths, which JAX runs in XLA on that output,
// clfacedetection_tpu/detect/pyramid.py:915-944).  The TPU kernel computes
// every node as a stencil product on the MXU, so node values are an
// intermediate in HBM there; this kernel keeps the pair's contract, the
// rows, and never writes a node value.  Its plain version is
// ops/tail_walk.py tail_walk_plain, and it is bit-equal to it and to
// tail_rows_plain(tail_values_plain(...)).
//
// Semantics, per slot (a slot index outside [0, Hv*Wv) is padding and
// writes (0, 0, n_stages, 0)):
//   vote  = clfd_clf_vote (cascade.cuh): the CART walk from node 0, each
//           node's rects differenced in int32, cast, weighted and summed in
//           rect order; go left iff node < thr * vnf;
//   ssum  = ((0 + vote_0) + vote_1) + ...  one __fadd_rn chain in
//           classifier order, as tail_rows.cu and the front;
//   sequential cascades walk stages [s_lo, S) and drop a survivor at its
//           first failing stage: exit stage = that stage (S on a pass),
//           stage sum = the last stage entered;
//   stage trees walk stages [s_lo, S) in order (the host checks that a
//           stage's parent comes before it, and passes s_lo > 0 only where
//           stages 0..s_lo-1 lie on every path, as the front's prefix);
//           a survivor enters a stage when it is a root or its parent
//           passed (a stage whose parent failed lies on no path that can
//           pass), and always enters path 0's leaf, whose sum a survivor
//           that passes no path reports.  Accepted when some path passes
//           all its stages: exit stage S and the first such path's leaf
//           sum; else exit stage 0 and path 0's leaf sum.
//
// What bounds it on the H100: latency, as tail2 (haar_tail2.cu).  The
// stages a survivor enters take little work; the pair before it was bound
// by the node values it wrote and read back (11.1 GB a launch at
// frontalface_alt_tree's 327,680 slots).  Design, tail2's:
//   * a block takes a chunk of kChunk slots; its first warp lists the
//     valid slots (ballot), and padding costs an index load and a store;
//   * the valid slots' window patches (`sum`, then `tilted`) sit in shared
//     memory at an odd stride, copied with cp.async; where they do not fit
//     a block the walk reads its corners through the read-only path
//     (cascade.cuh's plane reader, the same arithmetic);
//   * a stage's classifier records (the packed table, at an odd number of
//     16-byte groups a record) go through shared memory `round` at a time,
//     the next round copied with cp.async while this one runs;
//   * a warp takes (survivor, 32 classifiers) units, a lane a classifier,
//     two units in flight; the votes go to shared memory and one lane a
//     survivor adds them in classifier order, round after round;
//   * after each stage the survivors that enter the next one are listed
//     again (ballot), so lanes only ever run live survivors; a sequential
//     chunk stops at the stage where its last survivor fails, and a
//     stage-tree chunk goes straight to the next stage that one of its
//     survivors enters (its first round copied then: the stages between
//     cost a ballot each, not a round of records and barriers; the first
//     design walked all 42 of frontalface_alt_tree's stages from front_k
//     in every chunk, 3.07 ms on the H100 at 327,680 slots).
// No scratch and no counter, so a CUDA graph replays it.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "cascade.cuh"
#include "launch.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 16;   // slots a block
constexpr int kUnits = 2;    // (survivor, 32 classifiers) units a warp
constexpr int kMaxRound = 64;
constexpr int kMaxTreeStages = 64;
constexpr int kMaxLeaves = 32;
static_assert(kChunk <= 32, "the first warp holds the chunk, a lane a slot");

struct Walk {
  const int* sum;
  const int* tilted;     // null unless the cascade has tilted nodes
  const float* svnf;     // [B, cap]
  const int* surv;       // [B, cap]
  const int* tab;        // the packed table
  // stage trees: tail_rows' path buffer ([n_paths] x (mask lo, mask hi,
  // leaf index, 0), then each stage's leaf index or -1) and each stage's
  // parent (-1 for a root); null for sequential cascades
  const int* paths;
  const int* parents;
  float4* out;           // [B, cap]
  int hv, wv, hp, wp, cap, n_stages, clf_words, s_lo;
  int n_paths, n_leaves, leaf0;  // stage trees: leaf0 = path 0's leaf stage
  int ph, pw;            // a plane's window patch: rows and columns
  int pstride;           // words of a slot's patches, odd
  int rstride;           // words of a staged record, an odd number of int4
  int round;             // classifiers staged a round, 32 or 64
};

// cp.async copies of the records of round [r0, r0 + round) of stage `st`
// to `dst` (every record starts on a 16-byte group)
__device__ __forceinline__ void copy_round(int* dst, const Walk& a, int st,
                                           int r0) {
  const int4 sd = __ldg(reinterpret_cast<const int4*>(a.tab) + st);
  const int rcnt = min(a.round, sd.y - r0);
  const int g = a.clf_words >> 2;
  const int* src = a.tab + a.n_stages * CLFD_STAGE_WORDS
                 + (sd.x + r0) * a.clf_words;
  for (int i = threadIdx.x; i < rcnt * g; i += kThreads) {
    const int c = i / g;
    __pipeline_memcpy_async(dst + c * a.rstride + 4 * (i - c * g),
                            src + 4 * i, 16);
  }
}

template <bool kTree, bool kPatch>
__global__ void __launch_bounds__(kThreads) walk_kernel(const Walk a) {
  extern __shared__ int4 smem4[];
  int* s_tab = reinterpret_cast<int*>(smem4);    // two rounds' records
  int* s_patch = s_tab + 2 * a.round * a.rstride;
  float* s_votes = reinterpret_cast<float*>(
      s_patch + (kPatch ? kChunk * a.pstride : 0));
  const int vstride = a.round + 1;               // odd
  float* s_sums = s_votes + kChunk * vstride;    // stage trees' leaf sums
  __shared__ float s_vnf[kChunk];
  __shared__ int s_base[kChunk];
  __shared__ int s_valid[kChunk];   // the valid slots, by chunk slot
  __shared__ int s_list[kChunk];    // the slots that enter this stage
  __shared__ int s_nvalid, s_n, s_st;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int b = blockIdx.y;
  const int slot0 = blockIdx.x * kChunk;
  const int S = a.n_stages;
  const int n = a.hv * a.wv;
  const size_t out0 = (size_t)b * a.cap + slot0;
  const size_t frame = (size_t)b * a.hp * a.wp;

  // the first warp's state, a lane a chunk slot
  bool ok = false, in = false;
  float vnf = 0.0f, ssum = 0.0f;
  unsigned long long passed = 0ull;     // stage trees
  if (kTree) passed = a.s_lo >= 64 ? ~0ull : (1ull << a.s_lo) - 1ull;

  // the first warp lists the slots that enter the first stage from `st`
  // on that any slot enters, and publishes it (S where none is left): a
  // sequential cascade's next stage, a stage tree's next stage whose
  // parent some slot passed (a stage skipped here has no slot whose
  // parent passed, so none of its descendants is entered either)
  auto list = [&](int st) {
    unsigned m = 0u;
    for (; st < S; ++st) {
      if (kTree) {
        const int par = __ldg(a.parents + st);
        in = ok && (par < 0 || ((passed >> par) & 1ull) || st == a.leaf0);
      }
      m = __ballot_sync(0xffffffffu, in);
      if (m != 0u || !kTree) break;
    }
    if (st >= S) in = false;
    if (in) s_list[__popc(m & lt)] = lane;
    if (lane == 0) {
      s_n = __popc(m);
      s_st = m != 0u ? st : S;
    }
  };

  if (warp == 0) {
    const bool mine = lane < kChunk && slot0 + lane < a.cap;
    const int idx = mine ? __ldg(a.surv + out0 + lane) : -1;
    ok = idx >= 0 && idx < n;
    if (mine && !ok)
      a.out[out0 + lane] = make_float4(0.0f, 0.0f, (float)S, 0.0f);
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    if (ok) {
      const int y = idx / a.wv;
      vnf = __ldg(a.svnf + out0 + lane);
      s_vnf[lane] = vnf;
      s_base[lane] = y * a.wp + idx - y * a.wv;
      s_valid[__popc(m & lt)] = lane;
    }
    if (lane == 0) s_nvalid = __popc(m);
    in = ok;
    if (a.s_lo < S) list(a.s_lo);
  }
  __syncthreads();
  const int nvalid = s_nvalid;
  if (nvalid == 0) return;
  if (a.s_lo >= S) {            // sequential, no stage left: every one passes
    if (ok) a.out[out0 + lane] = make_float4(vnf, 1.0f, (float)S, 0.0f);
    return;
  }

  if (kPatch) {                 // the valid slots' patches
    const int planes = a.tilted ? 2 : 1;
    const int rows = planes * a.ph;
    for (int r = warp; r < nvalid * rows; r += kWarps) {
      const int k = r / rows;
      const int pr = r - k * rows;        // plane * ph + row
      const int pl = pr >= a.ph;
      const int s = s_valid[k];
      const int* src = (pl ? a.tilted : a.sum) + frame + s_base[s]
                     + (pr - pl * a.ph) * a.wp;
      int* dst = s_patch + s * a.pstride + pr * a.pw;
      for (int c = lane; c < a.pw; c += 32)
        __pipeline_memcpy_async(dst + c, src + c, 4);
    }
  }
  int st = s_st;                // path 0's leaf at least, for a tree
  if (st < S) copy_round(s_tab, a, st, 0);
  __pipeline_commit();

  // At the head of each round its records are on their way into buffer
  // `half`.  The next round's are copied into the other buffer while this
  // one runs: the stage's next round, or a sequential cascade's next
  // stage; a stage tree's next stage is known only at this stage's end,
  // and its first round is copied then.
  const int tab_words = a.round * a.rstride;
  int r0 = 0, half = 0;
  while (st < S) {
    const int4 sd = __ldg(reinterpret_cast<const int4*>(a.tab) + st);
    const bool last = r0 + a.round >= sd.y;
    if (!last)
      copy_round(s_tab + (half ^ 1) * tab_words, a, st, r0 + a.round);
    else if (!kTree && st + 1 < S)
      copy_round(s_tab + (half ^ 1) * tab_words, a, st + 1, 0);
    __pipeline_commit();
    __pipeline_wait_prior(1);     // this round's records, the patches
    __syncthreads();              // and the first warp's list
    const int nl = s_n;
    if (!kTree && nl == 0) break; // every survivor of the chunk failed
    const int rcnt = min(a.round, sd.y - r0);

    // votes: a warp takes 32 classifiers of one survivor, a lane one, and
    // kUnits such units at a time (a unit past the end repeats a valid
    // pair and stores nothing)
    const int* tab = s_tab + half * tab_words;
    const int nb = (rcnt + 31) >> 5;
    const int total = nl * nb;
    for (int u0 = warp; u0 < total; u0 += kUnits * kWarps) {
      float vote[kUnits];
      int at[kUnits];
#pragma unroll
      for (int q = 0; q < kUnits; ++q) {
        const int u = min(u0 + q * kWarps, total - 1);
        const int k = u / nb;
        const int j = (u - k * nb) * 32 + lane;
        const int s = s_list[k];
        const int* cl = tab + min(j, rcnt - 1) * a.rstride;
        if (kPatch) {
          const int* ps = s_patch + s * a.pstride;
          vote[q] = clfd_clf_vote<ClfdShared, ClfdShared>(
              cl, ps, ps + a.ph * a.pw, a.pw, s_vnf[s]);
        } else {
          const int* ps = a.sum + frame + s_base[s];
          const int* pt = a.tilted ? a.tilted + frame + s_base[s] : ps;
          vote[q] = clfd_clf_vote<ClfdShared, ClfdGlobal>(cl, ps, pt, a.wp,
                                                          s_vnf[s]);
        }
        at[q] = u0 + q * kWarps < total && j < rcnt ? s * vstride + j : -1;
      }
#pragma unroll
      for (int q = 0; q < kUnits; ++q)
        if (at[q] >= 0) s_votes[at[q]] = vote[q];
    }
    __syncthreads();

    // a lane a survivor adds the round's votes in classifier order; at the
    // stage's end it decides, and the first warp lists the next stage
    if (warp == 0) {
      if (in) {
        const float* v = s_votes + lane * vstride;
#pragma unroll 8
        for (int j = 0; j < rcnt; ++j) ssum = __fadd_rn(ssum, v[j]);
      }
      if (last) {
        if (in) {
          const bool pass = ssum >= __int_as_float(sd.z);
          if (kTree) {
            if (pass) passed |= 1ull << st;
            const int li = __ldg(a.paths + 4 * a.n_paths + st);
            if (li >= 0) s_sums[lane * a.n_leaves + li] = ssum;
          } else {
            if (!pass || st == S - 1)
              a.out[out0 + lane] = make_float4(
                  vnf, pass ? 1.0f : 0.0f, pass ? (float)S : (float)st,
                  ssum);
            in = pass;
          }
        }
        ssum = 0.0f;
        list(st + 1);
      }
    }
    if (last) {
      if (kTree) {
        __syncthreads();          // the next stage that a slot enters
        st = s_st;
        if (st < S) copy_round(s_tab + (half ^ 1) * tab_words, a, st, 0);
        __pipeline_commit();
      } else {
        ++st;
      }
      r0 = 0;
    } else {
      r0 += a.round;
    }
    half ^= 1;
  }
  __pipeline_wait_prior(0);

  if (kTree && warp == 0 && ok) {
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
    a.out[out0 + lane] = make_float4(vnf, acc ? 1.0f : 0.0f,
                                     acc ? (float)S : 0.0f,
                                     s_sums[lane * a.n_leaves + li]);
  }
}

// The block's shared memory is laid out here alone: two rounds of
// records, the chunk's patches (where they fit a block), its rows of
// votes and, for stage trees, its leaf sums.
size_t smem_bytes(const Walk& a, int round, bool patches) {
  return ((size_t)2 * round * a.rstride
          + (patches ? (size_t)kChunk * a.pstride : 0)
          + (size_t)kChunk * (round + 1)
          + (a.paths ? (size_t)kChunk * a.n_leaves : 0)) * 4;
}

// One kernel's shared-memory limits (launch.cuh), set up once per device.
template <bool kTree, bool kPatch>
ClfdSmem& smem_limits() {
  static ClfdSmem limits;
  return limits;
}

template <bool kTree, bool kPatch>
int launch(Walk& a, int batch, cudaStream_t stream) {
  ClfdSmemLimits limits;
  const auto kernel = walk_kernel<kTree, kPatch>;
  const cudaError_t e =
      smem_limits<kTree, kPatch>().ready((const void*)kernel, &limits);
  if (e != cudaSuccess) return (int)e;
  // the larger round where two blocks share an SM, or where neither does
  auto blocks = [&](int round) {
    return (size_t)limits.sm
           / (smem_bytes(a, round, kPatch) + limits.fixed + limits.reserved);
  };
  a.round = blocks(kMaxRound) < 2 && blocks(32) >= 2 ? 32 : kMaxRound;
  const size_t smem = smem_bytes(a, a.round, kPatch);
  if (smem > (size_t)limits.block) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.cap + kChunk - 1) / kChunk, batch);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The patches go to shared memory where a block with them fits the card's
// limit at the smaller round; else the walk reads the planes.
template <bool kTree>
int launch_planes(Walk& a, int batch, cudaStream_t stream) {
  ClfdSmemLimits limits;
  const cudaError_t e = smem_limits<kTree, true>().ready(
      (const void*)walk_kernel<kTree, true>, &limits);
  if (e != cudaSuccess) return (int)e;
  return smem_bytes(a, 32, true) <= (size_t)limits.block
             ? launch<kTree, true>(a, batch, stream)
             : launch<kTree, false>(a, batch, stream);
}

}  // namespace

// `tab` is the packed table (ops/cascade_table.py) of `clf_words` words a
// classifier; `ph` x `pw` a plane's window patch.  `paths` and `parents`
// are null for sequential cascades.  Returns cudaErrorInvalidValue for a
// stage tree of more than 64 stages or 32 leaf stages, or a block that
// does not fit.
extern "C" int clfd_tail_walk(const int* sum, const int* tilted,
                              const float* svnf, const int* surv,
                              const int* tab, const int* paths,
                              const int* parents, float* out, int batch,
                              int hv, int wv, int hp, int wp, int cap,
                              int n_stages, int clf_words, int s_lo,
                              int n_paths, int n_leaves, int leaf0, int ph,
                              int pw, void* stream) {
  const bool tree = paths != nullptr;
  if (clf_words % 4 != 0 || clf_words <= 0 ||
      (tree && (parents == nullptr || n_stages > kMaxTreeStages ||
                n_paths < 1 || n_leaves < 1 || n_leaves > kMaxLeaves ||
                leaf0 < 0 || leaf0 >= n_stages)))
    return (int)cudaErrorInvalidValue;
  if (cap == 0 || batch == 0) return 0;
  Walk a;
  a.sum = sum;
  a.tilted = tilted;
  a.svnf = svnf;
  a.surv = surv;
  a.tab = tab;
  a.paths = paths;
  a.parents = parents;
  a.out = reinterpret_cast<float4*>(out);
  a.hv = hv;
  a.wv = wv;
  a.hp = hp;
  a.wp = wp;
  a.cap = cap;
  a.n_stages = n_stages;
  a.clf_words = clf_words;
  a.s_lo = s_lo;
  a.n_paths = n_paths;
  a.n_leaves = n_leaves;
  a.leaf0 = leaf0;
  a.ph = ph;
  a.pw = pw;
  a.pstride = ((tilted ? 2 : 1) * ph * pw) | 1;
  a.rstride = 4 * ((clf_words / 4) | 1);
  a.round = kMaxRound;
  const cudaStream_t s = (cudaStream_t)stream;
  return tree ? launch_planes<true>(a, batch, s)
              : launch_planes<false>(a, batch, s);
}
