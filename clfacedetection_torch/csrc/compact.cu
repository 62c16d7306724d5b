// Ordered stream compaction of a flag array, per frame.
//
// Replaces the TPU kernel clfacedetection_tpu/ops/compact_kernel.py
// build_compact_kernel (pallas_call at compact_kernel.py:105) and takes
// the place of the XLA compactions _compact / _compact_hier
// (pyramid.py:119-183) on the port's path.  Contract of _compact: out[b]
// holds the flat indices of the first `cap` set flags of frame b in
// ascending order, padded with n; total[b] is the TRUE count of set flags,
// so total > cap is the overflow signal.
//
// What bounds it on the H100: reading the flags (2.9 MB a 1080p frame)
// twice, and three launches.  The TPU kernel walks bands in grid order
// with a running count in scratch; GPU blocks run in no order, so the
// running count becomes a scan over tiles:
//   1. count:   per-tile set-flag counts (__syncthreads_count);
//   2. scan:    one block per frame turns the tile counts into exclusive
//               tile offsets and writes the total;
//   3. scatter: each tile re-reads its flags and writes every index whose
//               slot (tile offset + warp-ballot prefix + block prefix) is
//               below cap; then slots [total, cap) get the pad value n.
// A tile is 8 passes of 256 consecutive flags, so loads are coalesced and
// the in-tile order is the raster order.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPasses = 8;
constexpr int kTile = kThreads * kPasses;  // = ops/compact_kernel.py TILE
constexpr int kScanThreads = 1024;

__global__ void __launch_bounds__(kThreads)
count_kernel(const unsigned char* __restrict__ flags, int* __restrict__ counts,
             int n, int n_tiles) {
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const unsigned char* f = flags + (size_t)b * n;
  int cnt = 0;
  for (int k = 0; k < kPasses; ++k) {
    const int i = tile * kTile + k * kThreads + threadIdx.x;
    cnt += __syncthreads_count(i < n && f[i] != 0);
  }
  if (threadIdx.x == 0) counts[(size_t)b * n_tiles + tile] = cnt;
}

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ counts, int* __restrict__ offsets,
            int* __restrict__ total, int n_tiles) {
  __shared__ int s[kScanThreads];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int per = (n_tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(t * per, n_tiles);
  const int hi = min(lo + per, n_tiles);
  const int* c = counts + (size_t)b * n_tiles;
  int local = 0;
  for (int i = lo; i < hi; ++i) local += c[i];
  s[t] = local;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int v = t >= off ? s[t - off] : 0;
    __syncthreads();
    s[t] += v;
    __syncthreads();
  }
  int run = s[t] - local;  // exclusive prefix of this thread's tiles
  int* o = offsets + (size_t)b * n_tiles;
  for (int i = lo; i < hi; ++i) {
    o[i] = run;
    run += c[i];
  }
  if (t == kScanThreads - 1) total[b] = s[t];
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const unsigned char* __restrict__ flags,
               const int* __restrict__ offsets, const int* __restrict__ total,
               int* __restrict__ out, int n, int n_tiles, int cap) {
  __shared__ int warp_cnt[kThreads / 32];
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned char* f = flags + (size_t)b * n;
  int* o = out + (size_t)b * cap;
  const int base = offsets[(size_t)b * n_tiles + tile];
  int running = 0;
  for (int k = 0; k < kPasses; ++k) {
    const int i = tile * kTile + k * kThreads + threadIdx.x;
    const bool set = i < n && f[i] != 0;
    const unsigned m = __ballot_sync(0xffffffffu, set);
    if (lane == 0) warp_cnt[warp] = __popc(m);
    __syncthreads();
    int before = 0, all = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      const int c = warp_cnt[w];
      before += w < warp ? c : 0;
      all += c;
    }
    if (set) {
      const int slot = base + running + before
                     + __popc(m & ((1u << lane) - 1u));
      if (slot < cap) o[slot] = i;
    }
    running += all;
    __syncthreads();
  }
  const int tot = total[b];
  for (int s = tile * kThreads + threadIdx.x; s < cap;
       s += n_tiles * kThreads) {
    if (s >= tot) o[s] = n;
  }
}

}  // namespace

extern "C" int clfd_compact_count(const unsigned char* flags, int* counts,
                                  int n, int n_tiles, int batch,
                                  void* stream) {
  count_kernel<<<dim3(n_tiles, batch), kThreads, 0, (cudaStream_t)stream>>>(
      flags, counts, n, n_tiles);
  return (int)cudaGetLastError();
}

extern "C" int clfd_compact_scan(const int* counts, int* offsets, int* total,
                                 int n_tiles, int batch, void* stream) {
  scan_kernel<<<batch, kScanThreads, 0, (cudaStream_t)stream>>>(
      counts, offsets, total, n_tiles);
  return (int)cudaGetLastError();
}

extern "C" int clfd_compact_scatter(const unsigned char* flags,
                                    const int* offsets, const int* total,
                                    int* out, int n, int n_tiles, int cap,
                                    int batch, void* stream) {
  scatter_kernel<<<dim3(n_tiles, batch), kThreads, 0,
                   (cudaStream_t)stream>>>(flags, offsets, total, out, n,
                                           n_tiles, cap);
  return (int)cudaGetLastError();
}
