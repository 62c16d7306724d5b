// Op-chain microbenchmark: the measured rates of the front's op mixes.
//
// Replaces the TPU kernel scripts/mb_vpu3.py chain_call (pallas_call at
// mb_vpu3.py:47).  Contract of chain_call: x is f32 [gh, 384]; for every
// row r and every output column o of [gh, gw],
//   acc = x[r, c]  with c = o % 256,
//   for t in 0..trips-1: acc = body(row r from column c, acc, t),
//   out[r, o] = acc.
// The TPU grid (gh/32, gw/256) gives every 256-column output block the
// same values; this kernel computes each of the gh * gw outputs all the
// same, since the rates divide by gh * gw.  The bodies (mb_vpu3.py:83-114;
// ops/chain.py chain_plain repeats them bit for bit):
//   1 slices: 32 x (acc += x[c + (7i+3) % 100]), then acc *= 0.5;
//   2 arith:  x0 = x[c + 7]; 16 x (acc = max(acc * 0.9999, x0 * (t + i)));
//   3 cmpsel: x0 = x[c + 3]; 16 x (acc += acc < x0 * th_i ? 0.25 : -0.25),
//             th_i = float32(0.5 + 0.01 i);
//   4 rect:   16 x (acc += (x[c + (7i+3) % 50] - x[c + (11i+17) % 50])
//             * 0.01);
//   0 empty:  the identity (mb_vpu3.py:75-80 runs it at one trip).
//
// What bounds it on the H100: by design not memory (3.5 MB in, 11.6 MB
// out), but the issue of its instructions.  An SM issues four warp
// instructions a clock and serves 128 bytes of shared memory a clock; the
// JAX's op counts (33, 48, 64, 80 a trip) turn the times into rates.  A
// "slice" (a lane shift in VMEM on the TPU) reads shared memory, and one
// 4-byte shared load per slice and element would bound the slice chains
// at 32 words an element a trip.  So the slices of one trip, which read
// overlapping windows of one row, share their loads:
//   * a thread owns C (kC) contiguous columns of one row; each trip it
//     loads its row window [c + lo, c + C + hi] (lo and hi: the body's
//     least and largest offset, read_at) from shared memory with 16-byte
//     loads, each word once (slices 33 loads at C = 32; rect 17, arith
//     and cmpsel 5 at C = 16), and every slice's add reads its operand
//     from a register whose index is known at compile time;
//   * the loads are `ld.volatile.shared.v4` inside the trip loop, so that
//     nvcc can neither hoist the trip-invariant loads out of it nor merge
//     them; the x0 of arith and cmpsel is loaded anew every trip, as the
//     source does, so x0 * (t + i) and x0 * th_i are computed every trip;
//   * built with -fmad=false, so (a - b) * 0.01 + acc stays a subtract, a
//     multiply and an add, and every operation is rounded on its own;
//   * the C chains of a thread are independent and hide the add latency;
//   * a warp owns a tile of 8 rows x 4 column groups of C (lane = group *
//     8 + row).  It stages the tile's row windows in shared memory with
//     cp.async at a pitch that is an odd number of 16-byte groups, so the
//     8 lanes of a quarter-warp (one group, 8 rows) read 8 distinct bank
//     groups with each 16-byte load;
//   * the warps of an SM share its issue slots, so the work is balanced by
//     SM, not by warp: a block holds as many warps as the kernel's
//     registers let one SM run (one block an SM, each warp with its own
//     tile buffer), each block of a grid that fills the card once takes a
//     contiguous run of tiles, and its warps take every W-th tile of the
//     run (the TPU grid's 355 tiles of 32x256 would be 2.7 waves of 132
//     SMs; blocks of one warp each, which the hardware spreads over the
//     SMs, leave some SMs several tiles more than the mean).
// C is fixed by body (cols_of): 32 for slices, 16 for the rest, the fastest
// of 8, 16 and 32 at 16 trips on the H100 (PERF.md keeps the sweep).
// tools/mb_vpu3.py counts each instantiation's trip loop in the SASS (the
// width from its name): the shared words, float instructions and warp
// instructions of one trip.
#include <atomic>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kBW = 256;           // mb_vpu3.py BW: columns of a chain block
constexpr int kInW = kBW + 128;    // row width of x
constexpr int kRows = 8;           // rows of a warp's tile
constexpr int kGroups = 4;         // column groups of a warp's tile

// float32(0.5 + 0.01 i), as numpy rounds the double once
__constant__ float kThreshold[16] = {
    0x1.000000p-1f, 0x1.051eb8p-1f, 0x1.0a3d70p-1f, 0x1.0f5c28p-1f,
    0x1.147ae2p-1f, 0x1.19999ap-1f, 0x1.1eb852p-1f, 0x1.23d70ap-1f,
    0x1.28f5c2p-1f, 0x1.2e147ap-1f, 0x1.333334p-1f, 0x1.3851ecp-1f,
    0x1.3d70a4p-1f, 0x1.428f5cp-1f, 0x1.47ae14p-1f, 0x1.4cccccp-1f};

// The column offset of a body's k-th read in a trip, k < reads_of(body):
// slices (7k + 3) % 100; rect the pair (7i + 3) % 50, (11i + 17) % 50 of
// its step i at k = 2i, 2i + 1; arith's x0 at 7, cmpsel's at 3.
__host__ __device__ constexpr int reads_of(int body) {
  return body == 1 || body == 4 ? 32 : body == 0 ? 0 : 1;
}
__host__ __device__ constexpr int read_at(int body, int k) {
  return body == 1   ? (k * 7 + 3) % 100
         : body == 2 ? 7
         : body == 3 ? 3
         : k % 2     ? (k / 2 * 11 + 17) % 50
                     : (k / 2 * 7 + 3) % 50;
}
// The least and largest of them (0 for the empty body).
constexpr int lo_of(int body) {
  int m = reads_of(body) ? read_at(body, 0) : 0;
  for (int k = 1; k < reads_of(body); ++k)
    m = read_at(body, k) < m ? read_at(body, k) : m;
  return m;
}
constexpr int hi_of(int body) {
  int m = 0;
  for (int k = 0; k < reads_of(body); ++k)
    m = read_at(body, k) > m ? read_at(body, k) : m;
  return m;
}
// Columns a thread.
constexpr int cols_of(int body) { return body == 1 ? 32 : 16; }

// The layout of body kBody at C = kC columns a thread.
template <int kBody, int kC>
struct Tile {
  // a trip loads the thread's words [kLo, kHi) from its first column
  static constexpr int kLo = lo_of(kBody) / 4 * 4;
  static constexpr int kHi = (kC + hi_of(kBody) + 3) / 4 * 4;
  static constexpr int kVec = kBody == 0 ? 0 : (kHi - kLo) / 4;
  static constexpr int kCols = kGroups * kC;   // output columns of a tile
  // a staged row: every group's trip window and its first C words
  static constexpr int kWidth = (kGroups - 1) * kC + (kHi > kC ? kHi : kC);
  // an odd number of 16-byte groups: 8 rows on 8 bank groups
  static constexpr int kPitch = (kWidth / 4) % 2 ? kWidth : kWidth + 4;
  static_assert(kC % 4 == 0 && kBW % kCols == 0, "C: a multiple of 4");
  static_assert(kBW - kCols + kWidth <= kInW, "window past the row");
};

// Four words of shared memory at byte address `a`, a volatile load that
// the compiler keeps where it is, once each time it is reached.
__device__ __forceinline__ void lds4(unsigned a, float* w) {
  asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(w[0]), "=f"(w[1]), "=f"(w[2]), "=f"(w[3])
               : "r"(a)
               : "memory");
}

// One trip of a body over the kC chains of a thread; `s` is the byte
// address of the thread's first column in its staged row.
template <int kBody, int kC>
__device__ __forceinline__ void trip(unsigned s, float* acc, int t) {
  using T = Tile<kBody, kC>;
  if constexpr (kBody != 0) {
    float w[T::kVec * 4];   // w[j]: the word at offset T::kLo + j
#pragma unroll
    for (int v = 0; v < T::kVec; ++v)
      lds4(s + (T::kLo + 4 * v) * 4, w + 4 * v);
    if constexpr (kBody == 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = read_at(1, i);
#pragma unroll
        for (int e = 0; e < kC; ++e) acc[e] = acc[e] + w[e + c - T::kLo];
      }
#pragma unroll
      for (int e = 0; e < kC; ++e) acc[e] = acc[e] * 0.5f;
    } else if constexpr (kBody == 2) {
      const float tf = (float)t;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float si = tf + (float)i;
#pragma unroll
        for (int e = 0; e < kC; ++e)                     // 0.9999f
          acc[e] = fmaxf(acc[e] * 0x1.fff2e4p-1f,
                         w[e + read_at(2, 0) - T::kLo] * si);
      }
    } else if constexpr (kBody == 3) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int e = 0; e < kC; ++e)
          acc[e] = acc[e] + (acc[e] < w[e + read_at(3, 0) - T::kLo] *
                                          kThreshold[i]
                                 ? 0.25f : -0.25f);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = read_at(4, 2 * i), d = read_at(4, 2 * i + 1);
#pragma unroll
        for (int e = 0; e < kC; ++e)
          acc[e] = acc[e] + (w[e + c - T::kLo] - w[e + d - T::kLo]) * 0.01f;
      }
    }
  }
}

// Tiles [u0, u1) of block b of `grid`: tile u is row group u / n_seg
// (kRows rows) and output column segment u % n_seg (kCols columns).
__device__ __forceinline__ int tile_begin(int b, int grid, int n_tiles) {
  return (int)((long long)n_tiles * b / grid);
}

template <int kBody, int kC>
__global__ void chain_kernel(const float* __restrict__ x,
                             float* __restrict__ out, int gw, int trips,
                             int n_tiles, int n_seg) {
  using T = Tile<kBody, kC>;
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
  float* tile = reinterpret_cast<float*>(smem4) + warp * kRows * T::kPitch;
  const int u0 = tile_begin(blockIdx.x, gridDim.x, n_tiles);
  const int u1 = tile_begin(blockIdx.x + 1, gridDim.x, n_tiles);
  const int lane = threadIdx.x & 31;
  const int row = lane % kRows;
  const int col = lane / kRows * kC;        // the thread's first column
  const unsigned s = (unsigned)__cvta_generic_to_shared(tile)
                   + (row * T::kPitch + col) * 4;
  constexpr int kRowVec = T::kWidth / 4;
  for (int u = u0 + warp; u < u1; u += warps) {
    const int g = u / n_seg;
    const int o0 = (u - g * n_seg) * T::kCols;   // the tile's output column
    const float* src = x + (size_t)g * kRows * kInW + o0 % kBW;
    __syncwarp();                  // every lane is done with the last tile
    for (int q = lane; q < kRows * kRowVec; q += 32) {
      const int r = q / kRowVec, v = q - r * kRowVec;
      __pipeline_memcpy_async(tile + r * T::kPitch + 4 * v,
                              src + r * kInW + 4 * v, 16);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();

    float acc[kC];
#pragma unroll
    for (int v = 0; v < kC / 4; ++v) lds4(s + 16 * v, acc + 4 * v);
#pragma unroll 1
    for (int t = 0; t < trips; ++t) trip<kBody, kC>(s, acc, t);
    float4* dst = reinterpret_cast<float4*>(
        out + ((size_t)g * kRows + row) * gw + o0 + col);
#pragma unroll
    for (int v = 0; v < kC / 4; ++v)
      dst[v] = make_float4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2],
                           acc[4 * v + 3]);
  }
}

// Launch state of one instantiation, by device ordinal: ClfdSmem's limits
// (its setup is counted by clfd_smem_setups) and the launch, which depends
// on the kernel and the card, not on the shape: the grid and the threads
// of a block in one word (0: not set up), set on the first launch on a
// device.  Two host threads that set up one device at once store the same
// word.
struct ChainLaunch {
  ClfdSmem smem;
  std::atomic<long long> launch[ClfdSmem::kMaxDevices] = {};
};

// The most warps an SM runs of the kernel (its thread limit, which its
// registers set, and shared memory at `buf` bytes a warp), all in one
// block, and the blocks that fill every SM once: grid << 32 | threads.
cudaError_t plan(const void* kernel, const ClfdSmemLimits& limits,
                 size_t buf, int dev, long long* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  int warps = fa.maxThreadsPerBlock / 32;
  const int by_smem = (int)((size_t)limits.block / buf);
  warps = by_smem < warps ? by_smem : warps;
  if (warps < 1) return cudaErrorInvalidConfiguration;
  int sms = 0, occ = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, kernel, warps * 32, warps * buf)))
    return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  *out = (long long)(sms * occ) << 32 | (warps * 32);
  return cudaSuccess;
}

template <int kBody, int kC>
int launch(const float* x, float* out, int gh, int gw, int trips,
           cudaStream_t stream) {
  using T = Tile<kBody, kC>;
  constexpr size_t kBuf = (size_t)kRows * T::kPitch * 4;  // a warp's tile
  static ChainLaunch state;
  const void* kernel = (const void*)chain_kernel<kBody, kC>;
  ClfdSmemLimits limits;
  cudaError_t err = state.smem.ready(kernel, &limits);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  long long l = state.launch[dev].load(std::memory_order_relaxed);
  if (l == 0) {
    if ((err = plan(kernel, limits, kBuf, dev, &l)) != cudaSuccess)
      return (int)err;
    state.launch[dev].store(l, std::memory_order_relaxed);
  }
  const int grid = (int)(l >> 32), threads = (int)(l & 0xffffffff);
  const int n_seg = gw / T::kCols;
  chain_kernel<kBody, kC><<<grid, threads, threads / 32 * kBuf, stream>>>(
      x, out, gw, trips, gh / kRows * n_seg, n_seg);
  return (int)cudaGetLastError();
}

}  // namespace

// body: 0 empty, 1 slices, 2 arith, 3 cmpsel, 4 rect (ops/chain.py BODIES).
// gh a multiple of 8 (32 on the TPU grid), gw of 256; x f32 [gh, 384], out
// f32 [gh, gw], both 16-byte aligned.
extern "C" int clfd_chain(const float* x, float* out, int gh, int gw,
                          int body, int trips, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (body) {
    case 0: return launch<0, cols_of(0)>(x, out, gh, gw, trips, s);
    case 1: return launch<1, cols_of(1)>(x, out, gh, gw, trips, s);
    case 2: return launch<2, cols_of(2)>(x, out, gh, gw, trips, s);
    case 3: return launch<3, cols_of(3)>(x, out, gh, gw, trips, s);
    case 4: return launch<4, cols_of(4)>(x, out, gh, gw, trips, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
