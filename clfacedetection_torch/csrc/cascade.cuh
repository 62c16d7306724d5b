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
// alpha[-link].  Every thread of a warp reads the same table entry at the
// same time (warp-uniform broadcasts); the front may stage its stages'
// part of either view in shared memory (the ClfdShared reader below).
//
// The stump view (CascadeTable.stumps; tail2, and the front for stump
// cascades): the same stage
// records with word 3 = 0, then STUMP_WORDS per classifier: rect count;
// 3 x (ya, xa, yb, xb); 3 weights, threshold, left leaf, right leaf (f32
// bits); 0.
#pragma once

#define CLFD_STAGE_WORDS 4
#define CLFD_CLF_HEAD 8
#define CLFD_NODE_WORDS 32
#define CLFD_MAX_T 3
#define CLFD_STUMP_WORDS 20

// Where a walk reads the table and the planes from: the read-only data
// path of device memory (the default), or shared memory, where a block
// staged them.  The arithmetic is the same either way.
struct ClfdGlobal {
  static __device__ __forceinline__ int ld(const int* __restrict__ p) {
    return __ldg(p);
  }
  // the table's 16-byte groups (every stage, classifier, node and rect
  // starts on one; the buffer comes from the CUDA allocator)
  static __device__ __forceinline__ int4 ld4(const int* __restrict__ p) {
    return __ldg(reinterpret_cast<const int4*>(p));
  }
};

struct ClfdShared {
  static __device__ __forceinline__ int ld(const int* p) { return *p; }
  static __device__ __forceinline__ int4 ld4(const int* p) {
    return *reinterpret_cast<const int4*>(p);
  }
};

// Upright rect sum from the four corners (y, x) offsets of `p`, in int32:
// the differences are exact whatever the order, and the cast to f32 comes
// after them.
template <class P = ClfdGlobal>
__device__ __forceinline__ int clfd_rect(const int* __restrict__ p, int wp,
                                         int ya, int xa, int yb, int xb) {
  return P::ld(p + ya * wp + xa) - P::ld(p + ya * wp + xb)
       - P::ld(p + yb * wp + xa) + P::ld(p + yb * wp + xb);
}

// int32 rect sum at `p` from corners a = (y0, x0, y1, x1) and
// b = (y2, x2, y3, x3), signs + - - +: exact for upright and tilted
// corners alike; the cast to f32 comes after it.
template <class P = ClfdGlobal>
__device__ __forceinline__ int clfd_corners(const int* __restrict__ p, int wp,
                                            int4 a, int4 b) {
  return P::ld(p + a.x * wp + a.y) - P::ld(p + a.z * wp + a.w)
       - P::ld(p + b.x * wp + b.y) + P::ld(p + b.z * wp + b.w);
}

// The classifier's vote at the window whose top-left plane entry is `ps`
// (sum) or `pt` (tilted; may be null when no node is tilted).  Walk from
// node 0, evaluating only the nodes on the path:
//   node = sum_k f32(rect_k) * w_k        (rect order, separately rounded)
//   go left iff node < thr * vnf          (the product rounded first)
// The host checks that links point forward, so the walk ends within MAX_T
// steps.  T is where the table lives, P where the planes do.
template <class T = ClfdGlobal, class P = ClfdGlobal>
__device__ __forceinline__ float clfd_clf_vote(const int* __restrict__ cl,
                                               const int* __restrict__ ps,
                                               const int* __restrict__ pt,
                                               int wp, float vnf) {
  // node count and alpha[0..2], loaded before the walk so that the leaf
  // value does not wait for a load issued after the compare
  const int4 head = T::ld4(cl);
  int node = 0;
  for (int step = 0; step < CLFD_MAX_T; ++step) {
    const int* nd = cl + CLFD_CLF_HEAD + node * CLFD_NODE_WORDS;
    const int4 h = T::ld4(nd);       // rect count, plane, left, right
    const int4 f = T::ld4(nd + 4);   // threshold, three weights
    const int* __restrict__ p = h.y ? pt : ps;
    float nv = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k < h.x) {
        const int rs = clfd_corners<P>(p, wp, T::ld4(nd + 8 + 8 * k),
                                       T::ld4(nd + 12 + 8 * k));
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
                            : leaf == 2 ? head.w : T::ld(cl + 4));
    }
    node = next;
  }
  return 0.0f;  // not reached for a table that passed the host's check
}

// Sequential stage sum of stage `st`, in classifier order from 0:
//   ssum = ssum + vote                    (separately rounded)
// This is the JAX package's XLA front order (pyramid.py:597-605).
template <class T = ClfdGlobal, class P = ClfdGlobal>
__device__ __forceinline__ float clfd_stage_sum(const int* __restrict__ table,
                                                int n_table_stages, int st,
                                                const int* __restrict__ ps,
                                                const int* __restrict__ pt,
                                                int wp, float vnf) {
  const int4 sd = T::ld4(table + st * CLFD_STAGE_WORDS);
  const int* clfs = table + n_table_stages * CLFD_STAGE_WORDS
                  + sd.x * sd.w;
  float ssum = 0.0f;
  for (int j = 0; j < sd.y; ++j) {
    ssum = __fadd_rn(ssum,
                     clfd_clf_vote<T, P>(clfs + j * sd.w, ps, pt, wp, vnf));
  }
  return ssum;
}

// One stump's vote at the window whose top-left plane entry is `p`, from
// its record's five 16-byte groups (the stump view, head of this file):
//   node = sum_k f32(rect_k) * w_k        (rect order, separately rounded)
//   vote = node < thr * vnf ? left : right  (the product rounded first)
template <class P = ClfdGlobal>
__device__ __forceinline__ float clfd_stump_vote(int4 g0, int4 g1, int4 g2,
                                                 int4 g3, int4 g4,
                                                 const int* __restrict__ p,
                                                 int wp, float vnf) {
  float nv = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k < g0.x) {
      const int ya = k == 0 ? g0.y : (k == 1 ? g1.y : g2.y);
      const int xa = k == 0 ? g0.z : (k == 1 ? g1.z : g2.z);
      const int yb = k == 0 ? g0.w : (k == 1 ? g1.w : g2.w);
      const int xb = k == 0 ? g1.x : (k == 1 ? g2.x : g3.x);
      const int wt = k == 0 ? g3.y : (k == 1 ? g3.z : g3.w);
      const float rs = (float)clfd_rect<P>(p, wp, ya, xa, yb, xb);
      const float term = __fmul_rn(rs, __int_as_float(wt));
      nv = (k == 0) ? term : __fadd_rn(nv, term);
    }
  }
  const float t = __fmul_rn(__int_as_float(g4.x), vnf);
  return nv < t ? __int_as_float(g4.y) : __int_as_float(g4.z);
}

// The same stage sum over the stump view, for upright stumps, at W
// windows at once (`p[w]`, `vnf[w]` -> `ssum[w]`):
//   node = sum_k f32(rect_k) * w_k        (rect order)
//   vote = node < thr * vnf ? left : right
//   ssum = ssum + vote                    (classifier order, from 0)
// Equal bit for bit to clfd_stage_sum on the packed table, window by
// window.  A stump's 80 bytes are five 16-byte groups (each record starts
// on one), read with independent vector loads before any corner load and
// shared by the W windows; the rect loop is unrolled and two stumps are
// in flight, so that the walk waits on one load round trip a stump pair
// and not on one a word.
template <int W, class T = ClfdGlobal, class P = ClfdGlobal>
__device__ __forceinline__ void clfd_stump_stage_sums(
    const int* __restrict__ stumps, int n_table_stages, int st,
    const int* const* p, int wp, const float* vnf, float* ssum) {
  const int4 sd = T::ld4(stumps + st * CLFD_STAGE_WORDS);
  const int* nodes = stumps + n_table_stages * CLFD_STAGE_WORDS
                   + sd.x * CLFD_STUMP_WORDS;
#pragma unroll
  for (int w = 0; w < W; ++w) ssum[w] = 0.0f;
#pragma unroll 2
  for (int j = 0; j < sd.y; ++j) {
    const int* nd = nodes + j * CLFD_STUMP_WORDS;
    // nr ya xa yb | xb ya xa yb | xb ya xa yb | xb w0 w1 w2 | thr l r 0
    const int4 g0 = T::ld4(nd), g1 = T::ld4(nd + 4), g2 = T::ld4(nd + 8);
    const int4 g3 = T::ld4(nd + 12), g4 = T::ld4(nd + 16);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      ssum[w] = __fadd_rn(ssum[w], clfd_stump_vote<P>(g0, g1, g2, g3, g4,
                                                      p[w], wp, vnf[w]));
    }
  }
}

template <class T = ClfdGlobal>
__device__ __forceinline__ float clfd_stage_threshold(
    const int* __restrict__ table, int st) {
  return __int_as_float(T::ld(table + st * CLFD_STAGE_WORDS + 2));
}
