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
// out), but the issue of its instructions.  Float adds and multiplies issue
// at 128 lanes a clock on each SM; shared-memory loads at 32 words a clock
// on each SM, which bounds the slice chains; the JAX's op counts (33, 48,
// 64, 80 a trip) turn the times into rates.  The design keeps every
// operation of the source inside the trip loop:
//   * a "slice" (a lane shift in VMEM on the TPU) is a volatile load from
//     shared memory of the block's rows of x, so that nvcc can neither
//     hoist the trip-invariant loads out of the trip loop nor merge them;
//     the slices of x0 are loaded anew every trip, as the source does, so
//     x0 * th_i cannot be hoisted either;
//   * built with -fmad=false, so (a - b) * 0.01 + acc stays a subtract, a
//     multiply and an add;
//   * a thread runs the chains of 8 rows at one column together, so the 8
//     independent dependency chains hide the add latency;
//   * the work is cut into warp units (8 rows x 32 columns) and each block
//     of a grid that fills the card once takes a contiguous run of units,
//     so every SM gets the same work to within one unit (the TPU grid's
//     355 tiles of 32x256 would be 2.7 waves of 132 SMs).  A block stages
//     the rows of its units in shared memory (at most 4 row groups of 8,
//     48 KB at 1080p widths) with 16-byte loads.
// chip_smoke.py prints the SASS of each body's trip loop: the shared
// loads and float instructions in one trip.
#include <cuda_runtime.h>

namespace {

constexpr int kBW = 256;           // mb_vpu3.py BW: columns of a chain block
constexpr int kInW = kBW + 128;    // row width of x
constexpr int kRows = 8;           // chains a thread runs together
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// float32(0.5 + 0.01 i), as numpy rounds the double once
__constant__ float kThreshold[16] = {
    0x1.000000p-1f, 0x1.051eb8p-1f, 0x1.0a3d70p-1f, 0x1.0f5c28p-1f,
    0x1.147ae2p-1f, 0x1.19999ap-1f, 0x1.1eb852p-1f, 0x1.23d70ap-1f,
    0x1.28f5c2p-1f, 0x1.2e147ap-1f, 0x1.333334p-1f, 0x1.3851ecp-1f,
    0x1.3d70a4p-1f, 0x1.428f5cp-1f, 0x1.47ae14p-1f, 0x1.4cccccp-1f};

// One trip of a body over the kRows chains of a thread; xs points at the
// thread's column c in the first of its rows (row stride kInW).
template <int kBody>
__device__ __forceinline__ void trip(const volatile float* xs, float* acc,
                                     int t) {
  if (kBody == 1) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = (i * 7 + 3) % 100;
#pragma unroll
      for (int e = 0; e < kRows; ++e) acc[e] = acc[e] + xs[e * kInW + c];
    }
#pragma unroll
    for (int e = 0; e < kRows; ++e) acc[e] = acc[e] * 0.5f;
  } else if (kBody == 2) {
    float x0[kRows];
#pragma unroll
    for (int e = 0; e < kRows; ++e) x0[e] = xs[e * kInW + 7];
    const float tf = (float)t;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float s = tf + (float)i;
#pragma unroll
      for (int e = 0; e < kRows; ++e)
        acc[e] = fmaxf(acc[e] * 0x1.fff2e4p-1f, x0[e] * s);   // 0.9999f
    }
  } else if (kBody == 3) {
    float x0[kRows];
#pragma unroll
    for (int e = 0; e < kRows; ++e) x0[e] = xs[e * kInW + 3];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int e = 0; e < kRows; ++e)
        acc[e] = acc[e] + (acc[e] < x0[e] * kThreshold[i] ? 0.25f : -0.25f);
    }
  } else if (kBody == 4) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = (i * 7 + 3) % 50;
      const int d = (i * 11 + 17) % 50;
#pragma unroll
      for (int e = 0; e < kRows; ++e)
        acc[e] = acc[e] + (xs[e * kInW + c] - xs[e * kInW + d]) * 0.01f;
    }
  }
}

// Units [u0, u1) of block b: unit u is row group u / n_seg (kRows rows)
// and 32-column output segment u % n_seg.
__host__ __device__ __forceinline__ long long unit_begin(int b, int grid,
                                                        long long n_units) {
  return n_units * b / grid;
}

template <int kBody>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const float* __restrict__ x, float* __restrict__ out, int gw,
             int trips, long long n_units, int n_seg) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const long long u0 = unit_begin(blockIdx.x, gridDim.x, n_units);
  const long long u1 = unit_begin(blockIdx.x + 1, gridDim.x, n_units);
  if (u0 >= u1) return;
  const long long g0 = u0 / n_seg;
  const long long g1 = (u1 - 1) / n_seg;
  // stage the rows of groups g0..g1 (each row 384 floats = 96 float4)
  const float4* src =
      reinterpret_cast<const float4*>(x) + g0 * kRows * (kInW / 4);
  const int n4 = (int)(g1 - g0 + 1) * kRows * (kInW / 4);
  for (int i = threadIdx.x; i < n4; i += kThreads) smem4[i] = src[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (long long u = u0 + (threadIdx.x >> 5); u < u1; u += kWarps) {
    const long long g = u / n_seg;
    const int o = (int)(u - g * n_seg) * 32 + lane;      // output column
    const volatile float* xs = smem + (g - g0) * kRows * kInW + (o % kBW);
    float acc[kRows];
#pragma unroll
    for (int e = 0; e < kRows; ++e) acc[e] = xs[e * kInW];
#pragma unroll 1
    for (int t = 0; t < trips; ++t) trip<kBody>(xs, acc, t);
    float* dst = out + g * kRows * gw + o;
#pragma unroll
    for (int e = 0; e < kRows; ++e) dst[(long long)e * gw] = acc[e];
  }
}

// Shared memory for the most row groups that one block of a `grid`-block
// launch spans.
size_t smem_for(int grid, long long n_units, int n_seg) {
  long long most = 0;
  for (int b = 0; b < grid; ++b) {
    const long long u0 = unit_begin(b, grid, n_units);
    const long long u1 = unit_begin(b + 1, grid, n_units);
    if (u1 > u0) {
      const long long span = (u1 - 1) / n_seg - u0 / n_seg + 1;
      most = span > most ? span : most;
    }
  }
  return (size_t)most * kRows * kInW * sizeof(float);
}

struct Config {
  int dev = -1, gh = 0, gw = 0, grid = 0;
  size_t smem = 0;
};

template <int kBody>
int launch(const float* x, float* out, int gh, int gw, int trips,
           cudaStream_t stream) {
  static Config cfg;               // the last shape's grid, per body
  const int n_seg = gw / 32;
  const long long n_units = (long long)(gh / kRows) * n_seg;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (cfg.dev != dev || cfg.gh != gh || cfg.gw != gw) {
    int sms = 0, occ = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    size_t smem = smem_for(sms, n_units, n_seg);
    err = cudaFuncSetAttribute(chain_kernel<kBody>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, chain_kernel<kBody>, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (occ < 1) return (int)cudaErrorInvalidConfiguration;
    // one full wave: every SM holds `occ` blocks, each a contiguous run
    // of units
    cfg.grid = sms * occ;
    cfg.smem = smem_for(cfg.grid, n_units, n_seg);
    if (cfg.smem > smem) {
      err = cudaFuncSetAttribute(chain_kernel<kBody>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)cfg.smem);
      if (err != cudaSuccess) return (int)err;
    }
    cfg.dev = dev;
    cfg.gh = gh;
    cfg.gw = gw;
  }
  chain_kernel<kBody><<<cfg.grid, kThreads, cfg.smem, stream>>>(
      x, out, gw, trips, n_units, n_seg);
  return (int)cudaGetLastError();
}

}  // namespace

// body: 0 empty, 1 slices, 2 arith, 3 cmpsel, 4 rect (ops/chain.py BODIES).
// gh a multiple of 8 (32 on the TPU grid), gw of 256; x f32 [gh, 384],
// out f32 [gh, gw], both 16-byte aligned.
extern "C" int clfd_chain(const float* x, float* out, int gh, int gw,
                          int body, int trips, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (body) {
    case 0: return launch<0>(x, out, gh, gw, trips, s);
    case 1: return launch<1>(x, out, gh, gw, trips, s);
    case 2: return launch<2>(x, out, gh, gw, trips, s);
    case 3: return launch<3>(x, out, gh, gw, trips, s);
    case 4: return launch<4>(x, out, gh, gw, trips, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
