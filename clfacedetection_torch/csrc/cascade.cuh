// The packed cascade table shared by the front and tail kernels.
// Layout (defined in clfacedetection_torch/ops/cascade_table.py):
//   stages, STAGE_WORDS each:  first classifier, classifier count,
//                              threshold (f32 bits), classifier stride
//                              clf_words = CLF_HEAD + T * NODE_WORDS
//   classifiers, clf_words each: head of CLF_HEAD words (node count,
//                              alpha[0..T] as f32 bits, zeros), then
//                              T nodes of NODE_WORDS:
//     0 rect count, 1 plane (0 sum, 1 tilted), 2 left, 3 right,
//     4 threshold (f32 bits), 5..7 weights (f32 bits),
//     8..31 three rects of four (y, x) corners, signs + - - +
// A link > 0 is the next node of the classifier; a link <= 0 is the leaf
// alpha[-link].  In the front every thread of a warp reads the same table
// entry at the same time (warp-uniform broadcasts that stay in L1).
//
// The stump view (CascadeTable.stumps, tail2 only): the same stage
// records with word 3 = 0, then STUMP_WORDS per classifier: rect count;
// 3 x (ya, xa, yb, xb); 3 weights, threshold, left leaf, right leaf (f32
// bits); 0.
#pragma once

#define CLFD_STAGE_WORDS 4
#define CLFD_CLF_HEAD 8
#define CLFD_NODE_WORDS 32
#define CLFD_MAX_T 3
#define CLFD_STUMP_WORDS 20

// Upright rect sum from the four corners (y, x) offsets of `p`, in int32:
// the differences are exact whatever the order, and the cast to f32 comes
// after them.
__device__ __forceinline__ int clfd_rect(const int* __restrict__ p, int wp,
                                         int ya, int xa, int yb, int xb) {
  return __ldg(p + ya * wp + xa) - __ldg(p + ya * wp + xb)
       - __ldg(p + yb * wp + xa) + __ldg(p + yb * wp + xb);
}

// The table's 16-byte groups (every stage, classifier, node and rect
// starts on one; the buffer comes from the CUDA allocator), read with one
// vector load each.
__device__ __forceinline__ int4 clfd_ld4(const int* __restrict__ p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

// int32 rect sum at `p` from corners a = (y0, x0, y1, x1) and
// b = (y2, x2, y3, x3), signs + - - +: exact for upright and tilted
// corners alike; the cast to f32 comes after it.
__device__ __forceinline__ int clfd_corners(const int* __restrict__ p, int wp,
                                            int4 a, int4 b) {
  return __ldg(p + a.x * wp + a.y) - __ldg(p + a.z * wp + a.w)
       - __ldg(p + b.x * wp + b.y) + __ldg(p + b.z * wp + b.w);
}

// The classifier's vote at the window whose top-left plane entry is `ps`
// (sum) or `pt` (tilted; may be null when no node is tilted).  Walk from
// node 0, evaluating only the nodes on the path:
//   node = sum_k f32(rect_k) * w_k        (rect order, separately rounded)
//   go left iff node < thr * vnf          (the product rounded first)
// The host checks that links point forward, so the walk ends within MAX_T
// steps.
__device__ __forceinline__ float clfd_clf_vote(const int* __restrict__ cl,
                                               const int* __restrict__ ps,
                                               const int* __restrict__ pt,
                                               int wp, float vnf) {
  // node count and alpha[0..2], loaded before the walk so that the leaf
  // value does not wait for a load issued after the compare
  const int4 head = clfd_ld4(cl);
  int node = 0;
  for (int step = 0; step < CLFD_MAX_T; ++step) {
    const int* nd = cl + CLFD_CLF_HEAD + node * CLFD_NODE_WORDS;
    const int4 h = clfd_ld4(nd);       // rect count, plane, left, right
    const int4 f = clfd_ld4(nd + 4);   // threshold, three weights
    const int* __restrict__ p = h.y ? pt : ps;
    float nv = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k < h.x) {
        const int rs = clfd_corners(p, wp, clfd_ld4(nd + 8 + 8 * k),
                                    clfd_ld4(nd + 12 + 8 * k));
        const float w = __int_as_float(k == 0 ? f.y : (k == 1 ? f.z : f.w));
        const float term = __fmul_rn((float)rs, w);
        nv = (k == 0) ? term : __fadd_rn(nv, term);
      }
    }
    const float t = __fmul_rn(__int_as_float(f.x), vnf);
    const int next = nv < t ? h.z : h.w;
    if (next <= 0) {
      const int leaf = -next;
      return __int_as_float(leaf == 0 ? head.y
                            : leaf == 1 ? head.z
                            : leaf == 2 ? head.w : __ldg(cl + 4));
    }
    node = next;
  }
  return 0.0f;  // not reached for a table that passed the host's check
}

// Sequential stage sum of stage `st`, in classifier order from 0:
//   ssum = ssum + vote                    (separately rounded)
// This is the JAX package's XLA front order (pyramid.py:597-605).
__device__ __forceinline__ float clfd_stage_sum(const int* __restrict__ table,
                                                int n_table_stages, int st,
                                                const int* __restrict__ ps,
                                                const int* __restrict__ pt,
                                                int wp, float vnf) {
  const int4 sd = clfd_ld4(table + st * CLFD_STAGE_WORDS);
  const int* clfs = table + n_table_stages * CLFD_STAGE_WORDS
                  + sd.x * sd.w;
  float ssum = 0.0f;
  for (int j = 0; j < sd.y; ++j) {
    ssum = __fadd_rn(ssum, clfd_clf_vote(clfs + j * sd.w, ps, pt, wp, vnf));
  }
  return ssum;
}

// The same stage sum over the stump view, for upright stumps:
//   node = sum_k f32(rect_k) * w_k        (rect order)
//   vote = node < thr * vnf ? left : right
//   ssum = ssum + vote                    (classifier order, from 0)
// Equal bit for bit to clfd_stage_sum on the packed table.
__device__ __forceinline__ float clfd_stump_stage_sum(
    const int* __restrict__ stumps, int n_table_stages, int st,
    const int* __restrict__ p, int wp, float vnf) {
  const int* sd = stumps + st * CLFD_STAGE_WORDS;
  const int n0 = __ldg(sd + 0);
  const int cnt = __ldg(sd + 1);
  const int* nodes = stumps + n_table_stages * CLFD_STAGE_WORDS;
  float ssum = 0.0f;
  for (int j = 0; j < cnt; ++j) {
    const int* nd = nodes + (n0 + j) * CLFD_STUMP_WORDS;
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
