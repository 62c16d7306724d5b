// Front-stage Haar evaluation over the packed pyramid canvas, live lanes
// only.
//
// Replaces the TPU kernel clfacedetection_tpu/ops/haar_front.py
// build_front_kernel (pallas_call at haar_front.py:252).  For every canvas
// position it writes the variance factor vnf and whether the window
// passes the visit lattice and stages [0, front_k).
//
// What bounds it on the H100: the latency of the cascade walk of the
// windows that are still alive.  A stump reads 8 or 12 plane entries and
// its table record; most positions die in the first three stages.  The
// first design ran one thread per position, 32 columns of a row a warp,
// and a warp walked a stage while any of its lanes was alive: on a 1080p
// frame 22.7% of the lanes that ran a stump had a live window.  Design:
//   * a block of 8 warps owns a 64x128 tile of positions, each warp a
//     32x32 part of it.  A warp computes vnf densely (a row of 32 columns
//     at a time, coalesced) and lists its part's visited positions in
//     raster order in shared memory (ballot + popc); the warps' lists are
//     joined into one list of the block;
//   * each stage runs over the block's list of live positions: chunks
//     dealt round the 8 warps, survivors appended to a second list for the
//     next stage.  Lanes run live windows except in a warp's last chunk,
//     and a part with many live windows does not hold one warp long after
//     the others (at batch 1 the time follows the heaviest tile's work);
//   * the block's `sum` (and `tilted`) tile with its window halo is staged
//     in shared memory by cp.async copies that overlap the vnf pass, so the
//     scattered corner reads of re-packed lanes come from shared memory
//     (row pitch odd, against bank conflicts);
//   * the front stages' part of the table is staged there too, in the
//     80-byte stump view for stump cascades, so the walk's dependent table
//     loads come from shared memory.  Where it does not fit beside the
//     planes (the wrapper passes table_words = 0), it is read through L1;
//   * with the stump view a lane takes two windows of a chunk: their walk
//     shares each table record and has two windows' loads in flight.
// Each position's arithmetic is the first design's: the mask and vnf are
// bit-equal to it and to front_plain.  A position stops at its first
// failing stage, which gives the same mask as ANDing every stage.
//
// CART cascades: each lane walks its classifier's tree from node 0 and
// evaluates only the nodes on its path (JAX evaluates every node and
// selects; the vote is the same).  Tilted nodes read the optional fourth
// plane, the RSAT integral, with the same generic four-corner int32 form.
//
// Numerics (bit-equal to the JAX f32 XLA front): int32 rect sums, cast to
// f32 after the differences; mean = win_sum*inv; the variance is ONE
// fused multiply-add, var = fma(win_sq, inv, -(mean*mean)), because that
// is what XLA:CPU emits for `win_sq*inv - mean*mean`; every other
// operation is separately rounded (__fmul_rn/__fadd_rn, -fmad=false).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "cascade.cuh"

namespace {

constexpr int kSide = 32;                  // a warp's part is kSide^2
constexpr int kWarpsX = 4;
constexpr int kWarpsY = 2;
constexpr int kWarps = kWarpsX * kWarpsY;
constexpr int kThreads = 32 * kWarps;
constexpr int kBX = kWarpsX * kSide;       // = ops/haar_front.py BLOCK_X
constexpr int kBY = kWarpsY * kSide;       // = ops/haar_front.py BLOCK_Y
constexpr int kBlock = kBX * kBY;
// row masks (kBY rows of kWarpsX words), then two lists of uint16 block
// positions (ly * kBX + lx), read and written in turn
// (= ops/haar_front.py LIST_SMEM)
constexpr int kListSmem = kBY * kWarpsX * 4 + 2 * kBlock * 2;

struct Front {
  const int* sum;
  const int* sqhi;
  const int* sqlo;
  const int* tilted;
  const unsigned char* visit;
  const int* table;
  unsigned char* front;
  float* vnf;
  int hv, wv, hp, wp;
  int n_table_stages, front_k, table_words;
  int eya, exa, eyb, exb;
  int rows, cols, pitch;   // the staged plane tile: kBY + max_dy rows ...
  float inv;
};

template <bool kShared>
struct Where {
  using type = ClfdGlobal;
};
template <>
struct Where<true> {
  using type = ClfdShared;
};

template <bool kTable, bool kStump>
__global__ void __launch_bounds__(kThreads)
front_kernel(const Front a) {
  using T = typename Where<kTable>::type;
  constexpr int kQ = kStump ? 2 : 1;         // windows a lane
  constexpr int kChunk = 32 * kQ;
  extern __shared__ int4 smem4[];
  __shared__ int s_seg[kWarps];
  __shared__ int s_cnt[3];
  unsigned* rowmask = reinterpret_cast<unsigned*>(smem4);
  unsigned short* lists =
      reinterpret_cast<unsigned short*>(rowmask + kBY * kWarpsX);
  int* s_tab = reinterpret_cast<int*>(reinterpret_cast<char*>(smem4)
                                      + kListSmem);
  int* s_sum = s_tab + (kTable ? a.table_words : 0);
  int* s_tilt = s_sum + a.rows * a.pitch;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.z;
  const int by0 = blockIdx.y * kBY;
  const int bx0 = blockIdx.x * kBX;
  const size_t frame = (size_t)b * a.hp * a.wp;
  const size_t out0 = (size_t)b * a.hv * a.wv;

  // staging copies, in flight during the vnf pass
  const int* tab = a.table;
  if constexpr (kTable) {
    for (int i = threadIdx.x * 4; i < a.table_words; i += kThreads * 4)
      __pipeline_memcpy_async(s_tab + i, a.table + i, 16);
    tab = s_tab;
  }
  {
    // rows by warp, columns by lane: coalesced, and no division
    const int rows = min(a.rows, a.hp - by0);
    const int cols = min(a.cols, a.wp - bx0);
    for (int r = warp; r < rows; r += kWarps) {
      const size_t g = frame + (size_t)(by0 + r) * a.wp + bx0;
      for (int c = lane; c < cols; c += 32) {
        __pipeline_memcpy_async(s_sum + r * a.pitch + c, a.sum + g + c, 4);
        if (a.tilted)
          __pipeline_memcpy_async(s_tilt + r * a.pitch + c,
                                  a.tilted + g + c, 4);
      }
    }
  }
  __pipeline_commit();

  const int wy = warp / kWarpsX;
  const int wx = warp - wy * kWarpsX;
  // do the windows at list entries e[q] pass stage st?  A lane with a
  // pair walks the stumps once for both; a missing second entry repeats
  // the first.
  auto passes = [&](int st, float thr, const int* e, const bool* has,
                    bool* pass) {
    const int *ps[kQ], *pt[kQ];
    float v[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int eq = has[q] ? e[q] : e[0];
      const int ly = eq / kBX;
      const int lx = eq - ly * kBX;
      v[q] = a.vnf[out0 + (size_t)(by0 + ly) * a.wv + bx0 + lx];
      ps[q] = s_sum + ly * a.pitch + lx;
      pt[q] = s_tilt + ly * a.pitch + lx;
    }
    float ss[kQ];
    if constexpr (kStump) {
      clfd_stump_stage_sums<2, T, ClfdShared>(tab, a.n_table_stages, st, ps,
                                              a.pitch, v, ss);
    } else {
      ss[0] = clfd_stage_sum<T, ClfdShared>(tab, a.n_table_stages, st, ps[0],
                                            pt[0], a.pitch, v[0]);
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) pass[q] = has[q] && ss[q] >= thr;
  };

  unsigned short* list = lists + warp * kSide * kSide;
  const unsigned lt = (1u << lane) - 1u;
  rowmask[(wy * kSide + lane) * kWarpsX + wx] = 0u;   // this warp's words

  // dense pass over the warp's part: vnf at every position, and the list
  // of the visited ones
  int cnt = 0;
  for (int r = 0; r < kSide; ++r) {
    const int y = by0 + wy * kSide + r;
    const int lx = wx * kSide + lane;
    const int x = bx0 + lx;
    bool alive = false;
    if (y < a.hv && x < a.wv) {
      const size_t g = frame + (size_t)y * a.wp + x;
      const float win_sum =
          (float)clfd_rect(a.sum + g, a.wp, a.eya, a.exa, a.eyb, a.exb);
      const float hi =
          (float)clfd_rect(a.sqhi + g, a.wp, a.eya, a.exa, a.eyb, a.exb);
      const float lo =
          (float)clfd_rect(a.sqlo + g, a.wp, a.eya, a.exa, a.eyb, a.exb);
      const float win_sq = __fadd_rn(__fmul_rn(hi, 256.0f), lo);
      const float mean = __fmul_rn(win_sum, a.inv);
      const float var = __fmaf_rn(win_sq, a.inv, -__fmul_rn(mean, mean));
      const float vnf = var >= 0.0f ? __fsqrt_rn(var) : 1.0f;
      a.vnf[out0 + (size_t)y * a.wv + x] = vnf;
      alive = a.visit[(size_t)y * a.wv + x] != 0;
    }
    const unsigned m = __ballot_sync(0xffffffffu, alive);
    if (alive)
      list[cnt + __popc(m & lt)] =
          (unsigned short)((wy * kSide + r) * kBX + lx);
    cnt += __popc(m);
  }
  __pipeline_wait_prior(0);
  __syncthreads();          // staging, the warps' lists, row masks

  // the block's list: the warps' lists joined, then each stage's chunks
  // dealt round the 8 warps, survivors appended to the other list (in
  // order within a chunk; chunks in the order the warps reach them)
  unsigned short* src = lists + kBlock;
  unsigned short* dst = lists;
  if (lane == 0) s_seg[warp] = cnt;
  if (threadIdx.x == 0) s_cnt[0] = 0;
  __syncthreads();
  int pre = 0;
  int n = 0;
  for (int w = 0; w < kWarps; ++w) {
    pre += w < warp ? s_seg[w] : 0;
    n += s_seg[w];
  }
  for (int i = lane; i < cnt; i += 32) src[pre + i] = list[i];
  __syncthreads();
  for (int st = 0; st < a.front_k && n > 0; ++st) {
    // s_cnt[(st + 1) % 3] was last read before the previous barrier
    if (threadIdx.x == 0) s_cnt[(st + 1) % 3] = 0;
    const float thr = clfd_stage_threshold<T>(tab, st);
    for (int base = warp * kChunk; base < n; base += kWarps * kChunk) {
      int e[kQ];
      bool has[kQ], pass[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int i = base + 32 * q + lane;
        has[q] = i < n;
        e[q] = has[q] ? src[i] : 0;
      }
      if (has[0]) passes(st, thr, e, has, pass);
      else pass[kQ - 1] = pass[0] = false;
      unsigned m[kQ];
      int kept = 0;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        m[q] = __ballot_sync(0xffffffffu, pass[q]);
        kept += __popc(m[q]);
      }
      int at = 0;
      if (lane == 0 && kept) at = atomicAdd(&s_cnt[st % 3], kept);
      at = __shfl_sync(0xffffffffu, at, 0);
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        if (pass[q]) dst[at + __popc(m[q] & lt)] = (unsigned short)e[q];
        at += __popc(m[q]);
      }
    }
    __syncthreads();
    n = s_cnt[st % 3];
    unsigned short* t = src;
    src = dst;
    dst = t;
  }

  // the mask: set the survivors' bits, then write the warp's rows
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int e = src[i];
    const int ly = e / kBX;
    const int lx = e - ly * kBX;
    atomicOr(&rowmask[ly * kWarpsX + lx / kSide], 1u << (lx % kSide));
  }
  __syncthreads();
  for (int r = 0; r < kSide; ++r) {
    const int y = by0 + wy * kSide + r;
    const int x = bx0 + wx * kSide + lane;
    if (y < a.hv && x < a.wv)
      a.front[out0 + (size_t)y * a.wv + x] = (unsigned char)(
          (rowmask[(wy * kSide + r) * kWarpsX + wx] >> lane) & 1u);
  }
}

template <bool kTable, bool kStump>
int launch(const Front& a, int batch, cudaStream_t stream) {
  const int smem = kListSmem + (kTable ? a.table_words * 4 : 0)
                 + (a.tilted ? 2 : 1) * a.rows * a.pitch * 4;
  auto kernel = front_kernel<kTable, kStump>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.wv + kBX - 1) / kBX, (a.hv + kBY - 1) / kBY, batch);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// `table` is the stump view when `stump` is set, else the packed table.
// `table_words` > 0 stages that prefix of it (its stage records and the
// classifiers of stages [0, front_k)) in shared memory; 0 reads it
// through L1.  `tilted` is null unless the cascade has tilted nodes.
extern "C" int clfd_haar_front(const int* sum, const int* sqhi,
                               const int* sqlo, const int* tilted,
                               const unsigned char* visit,
                               const int* table, unsigned char* front,
                               float* vnf, int batch, int hv, int wv, int hp,
                               int wp, int n_table_stages, int front_k,
                               int table_words, int max_dy, int max_dx,
                               int eya, int exa, int eyb, int exb, int stump,
                               float inv, void* stream) {
  Front a;
  a.sum = sum;
  a.sqhi = sqhi;
  a.sqlo = sqlo;
  a.tilted = tilted;
  a.visit = visit;
  a.table = table;
  a.front = front;
  a.vnf = vnf;
  a.hv = hv;
  a.wv = wv;
  a.hp = hp;
  a.wp = wp;
  a.n_table_stages = n_table_stages;
  a.front_k = front_k;
  a.table_words = table_words;
  a.eya = eya;
  a.exa = exa;
  a.eyb = eyb;
  a.exb = exb;
  a.rows = kBY + max_dy;
  a.cols = kBX + max_dx;
  a.pitch = a.cols | 1;     // odd: rows of the tile fall on shifted banks
  a.inv = inv;
  const cudaStream_t s = (cudaStream_t)stream;
  if (stump)
    return table_words > 0 ? launch<true, true>(a, batch, s)
                           : launch<false, true>(a, batch, s);
  return table_words > 0 ? launch<true, false>(a, batch, s)
                         : launch<false, false>(a, batch, s);
}
