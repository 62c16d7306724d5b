// The packed stump-cascade table shared by the front and tail kernels.
// Layout (defined in clfacedetection_torch/ops/stump_table.py):
//   stages, STAGE_WORDS each: first node, node count, threshold (f32 bits), 0
//   nodes, NODE_WORDS each:   rect count; 3 x (ya, xa, yb, xb);
//                             3 weights, threshold, left leaf, right leaf
//                             (f32 bits); 0
// Every thread of a warp reads the same table entry at the same time, so
// the reads are warp-uniform broadcasts that stay in L1.
#pragma once

#define CLFD_STAGE_WORDS 4
#define CLFD_NODE_WORDS 20

// Upright rect sum from the four corners (y, x) offsets of `p`, in int32:
// the differences are exact whatever the order, and the cast to f32 comes
// after them.
__device__ __forceinline__ int clfd_rect(const int* __restrict__ p, int wp,
                                         int ya, int xa, int yb, int xb) {
  return __ldg(p + ya * wp + xa) - __ldg(p + ya * wp + xb)
       - __ldg(p + yb * wp + xa) + __ldg(p + yb * wp + xb);
}

// Sequential stage sum of stage `st` for the window whose top-left
// integral entry is `p`, in classifier order, separately rounded:
//   node = sum_k f32(rect_k) * w_k        (rect order)
//   vote = node < thr * vnf ? left : right
//   ssum = ssum + vote                    (classifier order, from 0)
// This is the JAX package's XLA front order (pyramid.py:568-605).
__device__ __forceinline__ float clfd_stage_sum(const int* __restrict__ table,
                                                int n_table_stages, int st,
                                                const int* __restrict__ p,
                                                int wp, float vnf) {
  const int* sd = table + st * CLFD_STAGE_WORDS;
  const int n0 = __ldg(sd + 0);
  const int cnt = __ldg(sd + 1);
  const int* nodes = table + n_table_stages * CLFD_STAGE_WORDS;
  float ssum = 0.0f;
  for (int j = 0; j < cnt; ++j) {
    const int* nd = nodes + (n0 + j) * CLFD_NODE_WORDS;
    const int nr = __ldg(nd + 0);
    float nv = 0.0f;
    for (int k = 0; k < nr; ++k) {
      const int* r = nd + 1 + 4 * k;
      const float rs = (float)clfd_rect(p, wp, __ldg(r), __ldg(r + 1),
                                        __ldg(r + 2), __ldg(r + 3));
      const float term = __fmul_rn(rs, __int_as_float(__ldg(nd + 13 + k)));
      nv = (k == 0) ? term : __fadd_rn(nv, term);
    }
    const float t = __fmul_rn(__int_as_float(__ldg(nd + 16)), vnf);
    const float vote = nv < t ? __int_as_float(__ldg(nd + 17))
                              : __int_as_float(__ldg(nd + 18));
    ssum = __fadd_rn(ssum, vote);
  }
  return ssum;
}

__device__ __forceinline__ float clfd_stage_threshold(
    const int* __restrict__ table, int st) {
  return __int_as_float(__ldg(table + st * CLFD_STAGE_WORDS + 2));
}
