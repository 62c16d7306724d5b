// Ordered stream compaction of a flag array, per frame, in one launch.
//
// Replaces the TPU kernel clfacedetection_tpu/ops/compact_kernel.py
// build_compact_kernel (pallas_call at compact_kernel.py:105) and takes
// the place of the XLA compactions _compact / _compact_hier
// (pyramid.py:119-183) on the port's path.  Contract of _compact: out[b]
// holds the flat indices of the first `cap` set flags of frame b in
// ascending order, padded with n; total[b] is the TRUE count of set flags,
// so total > cap is the overflow signal.
//
// What bounds it on the H100: the flags are 2.9 MB a 1080p frame, under a
// microsecond of HBM time, so a call is bound by fixed costs: the host
// code and launches around it, and on the device a chain of round trips
// (the tile id's atomic, the flag loads, the look-back, the finishing
// atomic).  On an H100 80GB HBM3 at 700 W a one-tile call takes about
// 5.5 us of device time and the 1080p call about 9 us (chip_smoke.py).
// The first design took three launches (count, a one-block scan,
// scatter) and read every flag byte twice.  This one is a single-pass
// scan with decoupled look-back (Merrill & Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", 2016):
//   * a tile is 16,384 flags: each of 256 threads loads 64 as four uint4;
//   * in-tile ranks are a warp shuffle scan of the threads' counts plus a
//     warp-count prefix in shared memory;
//   * a tile takes its id from a global atomicAdd, so it only ever waits
//     on tiles whose blocks are already running, and publishes its
//     aggregate, then its inclusive prefix, in one 64-bit status word
//     (epoch, flag, value); flag and value travel in one word, so relaxed
//     loads and stores suffice.  Warp 0 looks back over 128 predecessors
//     a round trip (four words a lane, all in flight at once): the tiles
//     of a frame all run at once, so a tile's look-back is a chain of
//     round trips to L2, and the large tile and the deep window keep it
//     at one or two;
//   * the last tile of a frame writes total[b] and pads [total, cap);
//   * the scratch cleans itself: the last block to finish resets the tile
//     and done counters and advances the epoch that tags the status words,
//     so a call needs no memset and a CUDA graph can replay it.
// In-tile order is thread order, so the output is in raster order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 64;                      // flags per thread (4 uint4)
constexpr int kTile = kThreads * kPer;        // = ops/compact_kernel.py TILE
constexpr int kWarps = kThreads / 32;
constexpr int kDepth = 4;                     // look-back words per lane
constexpr unsigned kEpochMask = (1u << 30) - 1u;

// status word: epoch (30 bits) | flag (2 bits) | value (32 bits)
constexpr unsigned kAggregate = 1u;
constexpr unsigned kInclusive = 2u;

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long pack(unsigned epoch,
                                                   unsigned flag, int value) {
  return ((unsigned long long)((epoch << 2) | flag) << 32) | (unsigned)value;
}

__device__ __forceinline__ bool valid(unsigned long long w, unsigned epoch) {
  return (unsigned)(w >> 34) == epoch && ((unsigned)(w >> 32) & 3u) != 0u;
}

// Bit j set iff byte j of the 16 flags is non-zero.
__device__ __forceinline__ unsigned flag_bits(uint4 v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned nz = __vcmpne4(w[k], 0u);        // 0xff per set byte
#pragma unroll
    for (int j = 0; j < 4; ++j) m |= ((nz >> (8 * j + 7)) & 1u) << (4 * k + j);
  }
  return m;
}

// ctr[0]: tile counter, ctr[1]: finished blocks, ctr[2]: epoch.
__global__ void __launch_bounds__(kThreads)
compact_kernel(const unsigned char* __restrict__ flags,
               unsigned long long* __restrict__ status,
               unsigned* __restrict__ ctr, int* __restrict__ out,
               int* __restrict__ total, int n, int n_tiles, int cap,
               int n_blocks, int vec) {
  __shared__ int s_tile;
  __shared__ int s_warp[kWarps];
  __shared__ int s_excl;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(&ctr[0], 1u);
  __syncthreads();
  const int t = s_tile;
  const int b = t / n_tiles;
  const int tile = t - b * n_tiles;
  const unsigned epoch = *reinterpret_cast<volatile unsigned*>(&ctr[2]);
  const unsigned char* f = flags + (size_t)b * n;
  int* o = out + (size_t)b * cap;
  unsigned long long* st = status + (size_t)b * n_tiles;

  // this thread's 64 flags, in four vector loads where aligned and in range
  const int i0 = tile * kTile + threadIdx.x * kPer;
  unsigned long long bits = 0;
  if (vec && i0 + kPer <= n) {
    const uint4* f4 = reinterpret_cast<const uint4*>(f + i0);
    const uint4 v0 = __ldg(f4), v1 = __ldg(f4 + 1);
    const uint4 v2 = __ldg(f4 + 2), v3 = __ldg(f4 + 3);
    bits = (unsigned long long)flag_bits(v0)
         | (unsigned long long)flag_bits(v1) << 16
         | (unsigned long long)flag_bits(v2) << 32
         | (unsigned long long)flag_bits(v3) << 48;
  } else {
    for (int j = 0; j < kPer && i0 + j < n; ++j)
      if (f[i0 + j] != 0) bits |= 1ull << j;
  }
  const int cnt = __popcll(bits);

  // in-tile exclusive rank: warp shuffle scan, then the warps' prefix
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_warp[w];
    before += w < warp ? c : 0;
    agg += c;
  }
  const int rank = before + incl - cnt;

  // the tile's exclusive offset: publish, look back, publish
  if (warp == 0) {
    int excl = 0;
    if (tile == 0) {
      if (lane == 0) st_relaxed(&st[0], pack(epoch, kInclusive, agg));
    } else {
      if (lane == 0) st_relaxed(&st[tile], pack(epoch, kAggregate, agg));
      // before the frame's first tile: an inclusive prefix of 0
      const unsigned long long start = pack(epoch, kInclusive, 0);
      for (int base = tile - 1;; base -= 32 * kDepth) {
        // predecessor base - (lane + 32 k), nearest first
        unsigned long long w[kDepth];
#pragma unroll
        for (int k = 0; k < kDepth; ++k) {
          const int j = base - lane - 32 * k;
          w[k] = j >= 0 ? ld_relaxed(&st[j]) : start;
        }
#pragma unroll
        for (int k = 0; k < kDepth; ++k) {
          const int j = base - lane - 32 * k;
          while (!valid(w[k], epoch)) w[k] = ld_relaxed(&st[j]);
        }
        // words up to the nearest inclusive prefix (all, if none)
        int stop = 32 * kDepth - 1;
        bool found = false;
#pragma unroll
        for (int k = 0; k < kDepth; ++k) {
          const unsigned inc = __ballot_sync(
              0xffffffffu, ((unsigned)(w[k] >> 32) & 3u) == kInclusive);
          if (!found && inc) {
            stop = 32 * k + __ffs(inc) - 1;
            found = true;
          }
        }
        int v = 0;
#pragma unroll
        for (int k = 0; k < kDepth; ++k)
          v += lane + 32 * k <= stop ? (int)(unsigned)w[k] : 0;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
        excl += v;
        if (found) break;
      }
      if (lane == 0) st_relaxed(&st[tile], pack(epoch, kInclusive, excl + agg));
    }
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();
  const int excl = s_excl;

  // scatter this thread's set flags in order
  int slot = excl + rank;
  while (bits) {
    const int j = __ffsll(bits) - 1;
    bits &= bits - 1;
    if (slot < cap) o[slot] = i0 + j;
    ++slot;
  }

  if (tile == n_tiles - 1) {
    const int tot = excl + agg;
    if (threadIdx.x == 0) total[b] = tot;
    for (int s = tot + threadIdx.x; s < cap; s += kThreads) o[s] = n;
  }

  // the last block to finish makes the scratch ready for the next call
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&ctr[1], 1u) == (unsigned)n_blocks - 1u) {
      ctr[0] = 0u;
      ctr[1] = 0u;
      ctr[2] = (epoch + 1u) & kEpochMask;
      __threadfence();
    }
  }
}

}  // namespace

// `scratch` holds batch * n_tiles status words and then three counters,
// all zero when first used; `vec` says whether 16-byte flag loads are
// aligned (flags pointer and n multiples of 16).
extern "C" int clfd_compact(const unsigned char* flags, void* scratch,
                            int* out, int* total, int n, int n_tiles,
                            int cap, int batch, int vec, void* stream) {
  unsigned long long* status = static_cast<unsigned long long*>(scratch);
  unsigned* ctr = reinterpret_cast<unsigned*>(status + (size_t)batch * n_tiles);
  const int n_blocks = batch * n_tiles;
  compact_kernel<<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      flags, status, ctr, out, total, n, n_tiles, cap, n_blocks, vec);
  return (int)cudaGetLastError();
}
