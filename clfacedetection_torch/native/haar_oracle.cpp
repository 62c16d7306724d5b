// Standalone C oracle: the reference's cascade evaluation core rebuilt
// from its documented semantics, independently of the numpy oracle
// (detect/reference_impl.py) so the two can cross-check each other
// window for window.  The port's copy of the JAX package's
// native/haar_oracle.cpp, with the same extern "C" entry points.
//
// Semantics implemented (citations into the reference's sources):
//   * hidden-cascade build: stage-threshold bias 1e-4, third-rect drop,
//     stump/tree detection            (icvCreateHidHaarClassifierCascade,
//                                      tempcv.cpp:307-536)
//   * per-scale setup: equ rect, inv_window_area, cvRound rect scaling
//     (the flagx/flagy block-align branch is dead code: base_w >= 1 so
//     kx >= 1 always), weight = float(orig * inv_area * (tilted? .5:1)),
//     rect0 weight = float(-sum(w_k*area_k)/area_0), tilted corner
//     mapping into the 45-degree RSAT
//                                     (cvSetImagesForHaarClassifierCascade,
//                                      tempcv.cpp:549-768, corners 743-750)
//   * window run: bounds reject -1, variance normalization (double),
//     CART walk with float thresholds/alphas and double sums, sequential
//     stage loop returning -i on fail, stage-tree DFS returning 0
//                                     (icvEvalHidHaarClassifier +
//                                      cvRunHaarClassifierCascadeSum,
//                                      tempcv.cpp:771-948)
//
// Precision contract (deliberately mirrored): rect weights, node
// thresholds, alphas and biased stage thresholds are float; rect-sum *
// weight products round to FLOAT before accumulation — tempcv.cpp:782
// multiplies an int calc_sum expression by a float weight, so C++ usual
// arithmetic conversions narrow the rect sum to f32 and round the
// product to f32 (observable when rect sums exceed 2^24, i.e. large
// windows at big scales); stage sums, node-value accumulation across
// rects, and variance stay double; cvRound is round-half-to-even
// (lrint under the default FE_TONEAREST).  The NumPy oracle
// (reference_impl.py _node_value) makes the identical choice, so the
// cross-checks in tests/test_c_oracle.py and tests/test_torch_native.py
// pin this contract.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cfloat>

namespace {

inline long cv_round(double v) { return lrint(v); }

struct Corner { int32_t y, x; };

struct NodeRect {
    Corner c[4];      // +,-,-,+ corner signs
    float weight;     // 0 => absent
    int tilted;
};

struct Node {
    NodeRect rect[3];
    float threshold;
    int32_t left, right;   // >0: node index within classifier; <=0: -alpha idx
};

struct Oracle {
    // spec copies (scale-independent)
    int n_stages, n_clf, n_nodes, n_alphas;
    int window_w, window_h;
    int16_t *rx, *ry, *rw, *rh;
    float *rweight;             // [n_nodes*3], third rect dropped
    uint8_t *tilt;
    float *node_thr;
    int32_t *left, *right;
    int32_t *clf_node_ofs, *clf_node_cnt, *clf_alpha_ofs;
    float *alphas;
    int32_t *stage_clf_ofs, *stage_clf_cnt;
    float *stage_thr;           // biased
    int32_t *stage_parent, *stage_next, *stage_child;
    int is_tree;

    // per-scale state (set_images)
    const int32_t *sum;
    const double *sqsum;
    const int32_t *tsum;
    int width, height;          // integral plane dims (W+1, H+1)
    int real_w, real_h;
    // scaled corner extents over ALL node rects: per-term cvRound can
    // overhang the cvRound(window*scale) box by 1-2 px (and tilted
    // corners can reach x-th < 0), so the window bounds check alone
    // does not make every rect read in-bounds — the reference reads
    // that slack inside its own larger allocation (tempcv.cpp buffers),
    // a NumPy-backed oracle must reject instead (heap overread)
    int max_cx, max_cy, min_cx;
    double inv_area;
    Corner equ[4];
    Node *nodes;                // [n_nodes] scaled
};

// int rect sum, like the reference's calc_sum macro (tempcv.cpp:545):
// the sum/tilted planes are int32 and the four-corner combination stays
// integer until it meets the float weight
inline int32_t rect_sum(const Oracle *o, const NodeRect &r, int x, int y) {
    const int32_t *img = r.tilted ? o->tsum : o->sum;
    const int w = o->width;
    return img[(r.c[0].y + y) * w + r.c[0].x + x]
         - img[(r.c[1].y + y) * w + r.c[1].x + x]
         - img[(r.c[2].y + y) * w + r.c[2].x + x]
         + img[(r.c[3].y + y) * w + r.c[3].x + x];
}

// CART walk (tempcv.cpp:771-792): do { node value vs t*vnf } while leaf.
// Each rect term is an f32 product (int calc_sum narrowed to float by
// usual arithmetic conversions at tempcv.cpp:782) accumulated in double.
inline double eval_classifier(const Oracle *o, int clf, double vnf,
                              int x, int y) {
    const Node *base = o->nodes + o->clf_node_ofs[clf];
    const float *alpha = o->alphas + o->clf_alpha_ofs[clf];
    int idx = 0;
    for (;;) {
        const Node *nd = base + idx;
        double t = (double)nd->threshold * vnf;
        double s = (double)((float)rect_sum(o, nd->rect[0], x, y)
                            * nd->rect[0].weight);
        s += (double)((float)rect_sum(o, nd->rect[1], x, y)
                      * nd->rect[1].weight);
        if (nd->rect[2].weight != 0.0f)
            s += (double)((float)rect_sum(o, nd->rect[2], x, y)
                          * nd->rect[2].weight);
        idx = s < t ? nd->left : nd->right;
        if (idx <= 0)
            return (double)alpha[-idx];
    }
}

inline double stage_sum(const Oracle *o, int st, double vnf, int x, int y) {
    int c0 = o->stage_clf_ofs[st];
    double total = 0.0;
    for (int j = 0; j < o->stage_clf_cnt[st]; ++j)
        total += eval_classifier(o, c0 + j, vnf, x, y);
    return total;
}

template <typename T>
T *copy(const T *src, size_t n) {
    T *dst = (T *)malloc(n * sizeof(T));
    memcpy(dst, src, n * sizeof(T));
    return dst;
}

}  // namespace

extern "C" {

void *clfd_oracle_create(
    int n_stages, int n_clf, int n_nodes, int n_alphas,
    const int16_t *rect_x, const int16_t *rect_y,
    const int16_t *rect_w, const int16_t *rect_h,
    const float *rect_weight, const uint8_t *tilted,
    const float *node_threshold, const int32_t *left, const int32_t *right,
    const int32_t *clf_node_ofs, const int32_t *clf_node_cnt,
    const int32_t *clf_alpha_ofs, const float *alphas,
    const int32_t *stage_clf_ofs, const int32_t *stage_clf_cnt,
    const float *stage_threshold,
    const int32_t *stage_parent, const int32_t *stage_next,
    const int32_t *stage_child,
    int window_w, int window_h) {
    Oracle *o = (Oracle *)calloc(1, sizeof(Oracle));
    o->n_stages = n_stages;
    o->n_clf = n_clf;
    o->n_nodes = n_nodes;
    o->n_alphas = n_alphas;
    o->window_w = window_w;
    o->window_h = window_h;
    o->rx = copy(rect_x, (size_t)n_nodes * 3);
    o->ry = copy(rect_y, (size_t)n_nodes * 3);
    o->rw = copy(rect_w, (size_t)n_nodes * 3);
    o->rh = copy(rect_h, (size_t)n_nodes * 3);
    o->rweight = copy(rect_weight, (size_t)n_nodes * 3);
    o->tilt = copy(tilted, (size_t)n_nodes);
    o->node_thr = copy(node_threshold, (size_t)n_nodes);
    o->left = copy(left, (size_t)n_nodes);
    o->right = copy(right, (size_t)n_nodes);
    o->clf_node_ofs = copy(clf_node_ofs, (size_t)n_clf);
    o->clf_node_cnt = copy(clf_node_cnt, (size_t)n_clf);
    o->clf_alpha_ofs = copy(clf_alpha_ofs, (size_t)n_clf);
    o->alphas = copy(alphas, (size_t)n_alphas);
    o->stage_clf_ofs = copy(stage_clf_ofs, (size_t)n_stages);
    o->stage_clf_cnt = copy(stage_clf_cnt, (size_t)n_stages);
    o->stage_parent = copy(stage_parent, (size_t)n_stages);
    o->stage_next = copy(stage_next, (size_t)n_stages);
    o->stage_child = copy(stage_child, (size_t)n_stages);
    // hidden-cascade prep (tempcv.cpp:419,453-458): biased stage
    // thresholds; drop a ~zero-weight or empty third rect
    o->stage_thr = (float *)malloc((size_t)n_stages * sizeof(float));
    for (int i = 0; i < n_stages; ++i)
        o->stage_thr[i] = stage_threshold[i] - 0.0001f;
    for (int n = 0; n < n_nodes; ++n) {
        int k = n * 3 + 2;
        if (fabs((double)o->rweight[k]) < DBL_EPSILON || o->rw[k] == 0 ||
            o->rh[k] == 0)
            o->rweight[k] = 0.0f;
    }
    o->is_tree = 0;
    for (int i = 0; i < n_stages; ++i)
        if (o->stage_next[i] != -1) o->is_tree = 1;
    o->nodes = (Node *)calloc((size_t)n_nodes, sizeof(Node));
    return o;
}

void clfd_oracle_set_images(void *handle, const int32_t *sum,
                            const double *sqsum, const int32_t *tilted_sum,
                            int width, int height, double scale) {
    Oracle *o = (Oracle *)handle;
    o->sum = sum;
    o->sqsum = sqsum;
    o->tsum = tilted_sum;
    o->width = width;
    o->height = height;
    o->real_w = (int)cv_round(o->window_w * scale);
    o->real_h = (int)cv_round(o->window_h * scale);

    // equalization rect (tempcv.cpp:614-618)
    int exy = (int)cv_round(scale);
    int ew = (int)cv_round((o->window_w - 2) * scale);
    int eh = (int)cv_round((o->window_h - 2) * scale);
    o->inv_area = 1.0 / ((double)ew * eh);
    o->equ[0] = {(int32_t)exy, (int32_t)exy};
    o->equ[1] = {(int32_t)exy, (int32_t)(exy + ew)};
    o->equ[2] = {(int32_t)(exy + eh), (int32_t)exy};
    o->equ[3] = {(int32_t)(exy + eh), (int32_t)(exy + ew)};

    // per-node scaled rects + renormalized weights (tempcv.cpp:636-762)
    o->max_cx = o->real_w;
    o->max_cy = o->real_h;
    o->min_cx = 0;
    for (int n = 0; n < o->n_nodes; ++n) {
        Node *nd = o->nodes + n;
        nd->threshold = o->node_thr[n];
        nd->left = o->left[n];
        nd->right = o->right[n];
        int is_tilt = o->tilt[n] != 0;
        double corr = o->inv_area * (is_tilt ? 0.5 : 1.0);
        double sum0 = 0.0, area0 = 0.0;
        for (int k = 0; k < 3; ++k) {
            NodeRect *r = nd->rect + k;
            float ow = o->rweight[n * 3 + k];
            if (ow == 0.0f && k >= 1) {   // absent rect (k=0 always present)
                memset(r, 0, sizeof(*r));
                continue;
            }
            int tx = (int)cv_round(o->rx[n * 3 + k] * scale);
            int ty = (int)cv_round(o->ry[n * 3 + k] * scale);
            int tw = (int)cv_round(o->rw[n * 3 + k] * scale);
            int th = (int)cv_round(o->rh[n * 3 + k] * scale);
            r->tilted = is_tilt;
            if (!is_tilt) {
                r->c[0] = {(int32_t)ty, (int32_t)tx};
                r->c[1] = {(int32_t)ty, (int32_t)(tx + tw)};
                r->c[2] = {(int32_t)(ty + th), (int32_t)tx};
                r->c[3] = {(int32_t)(ty + th), (int32_t)(tx + tw)};
            } else {  // RSAT corners (tempcv.cpp:743-750)
                r->c[0] = {(int32_t)ty, (int32_t)tx};
                r->c[1] = {(int32_t)(ty + th), (int32_t)(tx - th)};
                r->c[2] = {(int32_t)(ty + tw), (int32_t)(tx + tw)};
                r->c[3] = {(int32_t)(ty + tw + th), (int32_t)(tx + tw - th)};
            }
            r->weight = (float)((double)ow * corr);
            for (int c = 0; c < 4; ++c) {
                if (r->c[c].x > o->max_cx) o->max_cx = r->c[c].x;
                if (r->c[c].y > o->max_cy) o->max_cy = r->c[c].y;
                if (r->c[c].x < o->min_cx) o->min_cx = r->c[c].x;
            }
            if (k == 0)
                area0 = (double)tw * th;
            else
                sum0 += (double)r->weight * tw * th;
        }
        nd->rect[0].weight = (float)(-sum0 / area0);
    }
}

// codes: 1 pass, -i fail at stage i (sequential), 0 fail (stage tree),
// -1 out of bounds.  stage_sums: the sum of the stage where evaluation
// stopped (the ROC gypWeight, tempcv.cpp:1083).
void clfd_oracle_run(const void *handle, const int32_t *xs, const int32_t *ys,
                     int n, int32_t *codes, double *stage_sums) {
    const Oracle *o = (const Oracle *)handle;
    for (int i = 0; i < n; ++i) {
        int x = xs[i], y = ys[i];
        double ss = 0.0;
        if (x < 0 || y < 0 || x + o->real_w >= o->width ||
            y + o->real_h >= o->height ||
            // per-term cvRound corner overhang / tilted negative reach:
            // any rect read that would leave the caller's plane is a
            // reject, same code as the window bounds check (-1) — the
            // reference reads this slack inside its own allocation
            x + o->max_cx >= o->width || y + o->max_cy >= o->height ||
            x + o->min_cx < 0) {
            codes[i] = -1;
            stage_sums[i] = 0.0;
            continue;
        }
        // variance normalization (tempcv.cpp:822-832)
        const int w = o->width;
        double mean = (double)o->sum[(o->equ[0].y + y) * w + o->equ[0].x + x]
                    - (double)o->sum[(o->equ[1].y + y) * w + o->equ[1].x + x]
                    - (double)o->sum[(o->equ[2].y + y) * w + o->equ[2].x + x]
                    + (double)o->sum[(o->equ[3].y + y) * w + o->equ[3].x + x];
        mean *= o->inv_area;
        double vnf = o->sqsum[(o->equ[0].y + y) * w + o->equ[0].x + x]
                   - o->sqsum[(o->equ[1].y + y) * w + o->equ[1].x + x]
                   - o->sqsum[(o->equ[2].y + y) * w + o->equ[2].x + x]
                   + o->sqsum[(o->equ[3].y + y) * w + o->equ[3].x + x];
        vnf = vnf * o->inv_area - mean * mean;
        vnf = vnf >= 0.0 ? sqrt(vnf) : 1.0;

        int code;
        if (o->is_tree) {
            // stage-tree DFS (tempcv.cpp:834-861)
            int ptr = 0;
            code = 1;
            while (ptr >= 0) {
                ss = stage_sum(o, ptr, vnf, x, y);
                if (ss >= (double)o->stage_thr[ptr]) {
                    ptr = o->stage_child[ptr];
                } else {
                    while (ptr >= 0 && o->stage_next[ptr] == -1)
                        ptr = o->stage_parent[ptr];
                    if (ptr < 0) { code = 0; break; }
                    ptr = o->stage_next[ptr];
                }
            }
        } else {
            code = 1;
            for (int st = 0; st < o->n_stages; ++st) {
                ss = stage_sum(o, st, vnf, x, y);
                if (ss < (double)o->stage_thr[st]) { code = -st; break; }
            }
        }
        codes[i] = code;
        stage_sums[i] = ss;
    }
}

void clfd_oracle_destroy(void *handle) {
    Oracle *o = (Oracle *)handle;
    if (!o) return;
    free(o->rx); free(o->ry); free(o->rw); free(o->rh);
    free(o->rweight); free(o->tilt); free(o->node_thr);
    free(o->left); free(o->right);
    free(o->clf_node_ofs); free(o->clf_node_cnt); free(o->clf_alpha_ofs);
    free(o->alphas);
    free(o->stage_clf_ofs); free(o->stage_clf_cnt); free(o->stage_thr);
    free(o->stage_parent); free(o->stage_next); free(o->stage_child);
    free(o->nodes);
    free(o);
}

}  // extern "C"
