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
// values (11.1 GB for frontalface_alt_tree at its 327,680 slots, 3.3 ms at
// 3.35 TB/s); the inputs it needs are a small patch per survivor.  The
// first design took 8 slots a block and its threads read every node's
// 112-byte record for each block: the table was read once per 8 slots (39
// GB of L1/L2 reads a launch for alt_tree), and a block of padding read it
// all to write zeros.  Design:
//   * a block of 8 warps takes `slots` slots (a multiple of 32, sized at
//     launch from the patch so that two blocks share an SM where they
//     fit) and stages every survivor's window patch (`sum`, and `tilted`
//     after it) in shared memory with cp.async, a slot's patches at an odd
//     stride;
//   * the node view's 64-byte records (corner offsets into the patch,
//     weights) go through shared memory in rounds of 128 nodes, copied
//     with cp.async two rounds ahead, so the table is read once per block
//     and no walk waits on device memory; one barrier a round;
//   * a warp takes 16 nodes for 32 slots, a lane a slot: every lane reads
//     the same record (a broadcast) and its own slot's corners, which the
//     odd stride puts on 32 banks.  The 16 values are kept in registers,
//     with no branch and no shared store between them, so their loads are
//     in flight together; then they go through a shared tile and leave
//     as rows along the node axis, 16-byte stores where n_clf * T is a
//     multiple of 4 (8-byte where it is even), coalesced;
//   * 32 slots of padding write their zeros with 16-byte stores and read
//     no patch and no table; the grid takes its chunks of slots from both
//     ends in turn, so the blocks that store zeros (the compaction's
//     padding comes last) run beside the blocks that compute.
// No bands, no lane packing, no matrix product.
//
// Numerics: a rect is the int32 difference of its four corners in the raw
// plane patch (exact for upright and tilted corners; the TPU kernel's
// patch corrections exist only to keep f32 matrix products exact), cast to
// f32, times its weight, summed in rect order, every operation separately
// rounded (-fmad=false).  This is the front's node value (cascade.cuh), so
// the kernel is bit-equal to tail_values_plain.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSlots = 128;   // slots a block at most
constexpr int kTile = 16;       // nodes of a warp's tile
// a tile row: 32 slots, and a pad that puts the rows a store reads on
// other banks
constexpr int kPitch = 32 + 32 / kTile;
constexpr int kRange = kWarps * kTile;  // nodes staged a round (= ops/
                                        // cascade_table.py NODE_VIEW_PAD)
constexpr int kStages = 3;       // rounds of node records in shared memory
constexpr int kNodeWords = 16;   // = ops/cascade_table.py NODE_VIEW_WORDS

struct Tail {
  const int* sum;
  const int* tilted;      // null unless the cascade has tilted nodes
  const int* surv;
  const int* nodes;       // the table's node view
  float* out;
  int hv, wv, hp, wp, cap, nn;
  int ph, pw;             // a window patch: rows and columns of a plane
  int slots;              // slots a block, a multiple of 32
  int stride;             // words of a slot's patches, odd
};

// zero `count` floats from `p` (4-byte aligned) with the block's threads:
// 16-byte stores between a 4-byte head and tail
__device__ __forceinline__ void zero_fill(float* p, size_t count) {
  const size_t mis = ((16 - ((uintptr_t)p & 15)) & 15) / 4;
  const size_t head = mis < count ? mis : count;
  const size_t quads = (count - head) / 4;
  for (size_t i = threadIdx.x; i < head; i += kThreads) p[i] = 0.0f;
  float4* q = reinterpret_cast<float4*>(p + head);
  for (size_t i = threadIdx.x; i < quads; i += kThreads)
    q[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (size_t i = head + quads * 4 + threadIdx.x; i < count; i += kThreads)
    p[i] = 0.0f;
}

// cp.async copies of the node view's records [n0, n0 + kRange) to `dst`
__device__ __forceinline__ void copy_nodes(int* dst, const int* nodes,
                                           int n0) {
  const int* src = nodes + (size_t)n0 * kNodeWords;
  for (int i = threadIdx.x; i < kRange * (kNodeWords / 4); i += kThreads)
    __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
}

template <int kV>
__global__ void __launch_bounds__(kThreads, 2) tail_kernel(const Tail a) {
  extern __shared__ int4 smem4[];
  float* s_tile = reinterpret_cast<float*>(smem4);   // kTile x kPitch a warp
  int* s_nodes = reinterpret_cast<int*>(s_tile + kWarps * kTile * kPitch);
  int* s_patch = s_nodes + kStages * kRange * kNodeWords;
  __shared__ int s_base[kMaxSlots];    // a slot's window in the plane, or -1
  __shared__ unsigned s_mask[kMaxSlots / 32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  // chunks from both ends in turn: the compaction puts its padding last,
  // so blocks that compute and blocks that only store zeros share the card
  const int chunks = gridDim.x;
  const int chunk = blockIdx.x & 1 ? chunks - 1 - (blockIdx.x >> 1)
                                   : blockIdx.x >> 1;
  const int slot0 = chunk * a.slots;
  const int groups = a.slots / 32;
  const int n = a.hv * a.wv;
  const size_t row0 = (size_t)b * a.cap + slot0;

  if (warp < groups) {
    const int s = warp * 32 + lane;
    const int idx = slot0 + s < a.cap ? __ldg(a.surv + row0 + s) : -1;
    const bool ok = idx >= 0 && idx < n;
    const int y = ok ? idx / a.wv : 0;
    s_base[s] = ok ? y * a.wp + idx - y * a.wv : -1;
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) s_mask[warp] = m;
  }
  __syncthreads();

  // groups of padding: zeros, 16 bytes a store
  int live = 0;
  for (int g = 0; g < groups; ++g) {
    const int r0 = slot0 + g * 32;
    if (r0 >= a.cap) break;
    if (s_mask[g] != 0u)
      ++live;
    else
      zero_fill(a.out + (row0 + g * 32) * a.nn,
                (size_t)min(32, a.cap - r0) * a.nn);
  }
  if (live == 0) return;

  // the live slots' patches
  {
    const int planes = a.tilted ? 2 : 1;
    const size_t frame = (size_t)b * a.hp * a.wp;
    const int rows = planes * a.ph;
    for (int r = warp; r < a.slots * rows; r += kWarps) {
      const int s = r / rows;
      const int base = s_base[s];
      if (base < 0) continue;
      const int pr = r - s * rows;        // plane * ph + row
      const int pl = pr >= a.ph;
      const int row = pr - pl * a.ph;
      const int* src = (pl ? a.tilted : a.sum) + frame + base + row * a.wp;
      int* dst = s_patch + s * a.stride + pr * a.pw;
      for (int c = lane; c < a.pw; c += 32)
        __pipeline_memcpy_async(dst + c, src + c, 4);
    }
  }
  // rounds of kRange nodes, their records copied kStages - 1 rounds ahead
  // (one barrier a round: the copy into a buffer is issued after the
  // barrier that every reader of its last round has passed); in a round
  // a warp takes units of (kTile nodes, 32 slots)
  const int rounds = (a.nn + kRange - 1) / kRange;
  for (int rd = 0; rd < kStages - 1; ++rd) {
    if (rd < rounds)
      copy_nodes(s_nodes + rd * kRange * kNodeWords, a.nodes, rd * kRange);
    __pipeline_commit();
  }
  float* tile = s_tile + warp * kTile * kPitch;
  for (int rd = 0; rd < rounds; ++rd) {
    __pipeline_wait_prior(kStages - 2);
    __syncthreads();
    const int ahead = rd + kStages - 1;
    if (ahead < rounds)
      copy_nodes(s_nodes + (ahead % kStages) * kRange * kNodeWords, a.nodes,
                 ahead * kRange);
    __pipeline_commit();
    const int n0 = rd * kRange;
    const int4* recs = reinterpret_cast<const int4*>(s_nodes)
                     + (rd % kStages) * kRange * (kNodeWords / 4);
    const int tiles = (min(kRange, a.nn - n0) + kTile - 1) / kTile;
    for (int u = warp; u < tiles * groups; u += kWarps) {
      const int t = u / groups;
      const int g = u - t * groups;
      const int r0 = slot0 + g * 32;
      if (r0 >= a.cap || s_mask[g] == 0u) continue;
      const int col0 = n0 + t * kTile;
      const int m = min(kTile, a.nn - col0);
      const int s = g * 32 + lane;
      const bool ok = s_base[s] >= 0;
      const int* p = s_patch + s * a.stride;
      const int4* nd = recs + t * kTile * (kNodeWords / 4);
      // the tile's nodes in registers first: no shared store between
      // them, so the loads of all kTile nodes can be in flight at once.
      // A record is nr o0 o1 o2 | o3 o4 o5 o6 | o7 o8 o9 o10 | o11 w0 w1
      // w2; a rect past the count has offsets 0 and weight 0, and the
      // view is padded with zero records to a whole round, so every load
      // lies in the patch and the walk has no branch: selects keep the
      // rect order's roundings
      float v[kTile];
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const int4 d0 = nd[4 * j], d1 = nd[4 * j + 1];
        const int4 d2 = nd[4 * j + 2], d3 = nd[4 * j + 3];
        const float f0 = (float)(p[d0.y] - p[d0.z] - p[d0.w] + p[d1.x]);
        const float f1 = (float)(p[d1.y] - p[d1.z] - p[d1.w] + p[d2.x]);
        const float f2 = (float)(p[d2.y] - p[d2.z] - p[d2.w] + p[d3.x]);
        float nv = __fmul_rn(f0, __int_as_float(d3.y));
        const float n1 = __fadd_rn(nv, __fmul_rn(f1, __int_as_float(d3.z)));
        nv = d0.x > 1 ? n1 : nv;
        const float n2 = __fadd_rn(nv, __fmul_rn(f2, __int_as_float(d3.w)));
        nv = d0.x > 2 ? n2 : nv;
        v[j] = ok && d0.x > 0 ? nv : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kTile; ++j) tile[j * kPitch + lane] = v[j];
      __syncwarp();
      // the tile leaves as rows along the node axis, kV nodes a lane
      // (16-byte stores where a row's nodes allow it)
      constexpr int kLanes = kTile / kV;        // lanes a row
      const int rows = min(32, a.cap - r0);
      const int cc = (lane % kLanes) * kV;
      float* dst = a.out + (row0 + g * 32) * a.nn + col0 + cc;
      for (int r = lane / kLanes; r < rows; r += 32 / kLanes) {
        if (cc < m) {
          const float* tv = tile + cc * kPitch + r;
          if constexpr (kV == 4)
            *reinterpret_cast<float4*>(dst + (size_t)r * a.nn) =
                make_float4(tv[0], tv[kPitch], tv[2 * kPitch],
                            tv[3 * kPitch]);
          else if constexpr (kV == 2)
            *reinterpret_cast<float2*>(dst + (size_t)r * a.nn) =
                make_float2(tv[0], tv[kPitch]);
          else
            dst[(size_t)r * a.nn] = tv[0];
        }
      }
      __syncwarp();
    }
  }
}

// The block's shared memory is laid out here alone: the warps' tiles,
// kStages rounds of node records, then `slots` slots' patches at an odd
// stride.  The most slots, a multiple of 32, with which two blocks fit on
// an SM, and 32 where none does; cudaErrorInvalidValue where 32 do not fit
// a block.
template <int kV>
int launch(Tail& a, int batch, cudaStream_t stream) {
  static ClfdSmem smem_limits;
  ClfdSmemLimits limits;
  auto kernel = tail_kernel<kV>;
  const cudaError_t e = smem_limits.ready((const void*)kernel, &limits);
  if (e != cudaSuccess) return (int)e;
  auto smem = [&](int slots) {
    return (size_t)kWarps * kTile * kPitch * 4
           + ((size_t)kStages * kRange * kNodeWords
              + (size_t)slots * a.stride) * 4;
  };
  a.slots = kMaxSlots;
  while (a.slots > 32
         && 2 * (smem(a.slots) + limits.fixed + limits.reserved)
                > (size_t)limits.sm)
    a.slots -= 32;
  if (smem(a.slots) > (size_t)limits.block) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.cap + a.slots - 1) / a.slots, batch);
  kernel<<<grid, kThreads, smem(a.slots), stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// `nodes` is the table's node view (ops/cascade_table.py); `ph` x `pw` is
// a plane's window patch.
extern "C" int clfd_haar_tail(const int* sum, const int* tilted,
                              const int* surv, const int* nodes, float* out,
                              int batch, int hv, int wv, int hp, int wp,
                              int cap, int nn, int ph, int pw, void* stream) {
  Tail a;
  a.sum = sum;
  a.tilted = tilted;
  a.surv = surv;
  a.nodes = nodes;
  a.out = out;
  a.hv = hv;
  a.wv = wv;
  a.hp = hp;
  a.wp = wp;
  a.cap = cap;
  a.nn = nn;
  a.ph = ph;
  a.pw = pw;
  a.stride = ((tilted ? 2 : 1) * ph * pw) | 1;
  const cudaStream_t s = (cudaStream_t)stream;
  return nn % 4 == 0 ? launch<4>(a, batch, s)
       : nn % 2 == 0 ? launch<2>(a, batch, s) : launch<1>(a, batch, s);
}
