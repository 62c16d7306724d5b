// Native rectangle grouping — C++ twin of detect/grouping.py.
//
// Union-find partition over the ASimilarRects predicate plus class
// averaging and the small-inside-large containment filter, exactly the
// AgroupRectangles semantics of the reference's OpenCV copy
// (tempcv.cpp:129-243).  Grouping is inherently sequential host work
// (SURVEY.md section 7 hard-part #6) — the reference also runs it on the
// host after device readback (clod.cpp:1324-1326).  This implementation
// removes the O(n^2) Python-loop overhead for large candidate sets; the
// Python twin remains the behavioral specification and the fallback.
// The port's copy of the JAX package's native/grouping.cpp, with the
// same extern "C" entry points; native/__init__.py builds it.

#include <cstdint>
#include <cstdlib>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

struct Rect { int64_t x, y, w, h; };

inline bool similar(const Rect& a, const Rect& b, double eps) {
    double delta = eps * (std::min(a.w, b.w) + std::min(a.h, b.h)) * 0.5;
    return std::llabs(a.x - b.x) <= delta &&
           std::llabs(a.y - b.y) <= delta &&
           std::llabs(a.x + a.w - b.x - b.w) <= delta &&
           std::llabs(a.y + a.h - b.y - b.h) <= delta;
}

int find_root(std::vector<int>& parent, int i) {
    int root = i;
    while (parent[root] != root) root = parent[root];
    while (parent[i] != root) { int next = parent[i]; parent[i] = root; i = next; }
    return root;
}

}  // namespace

extern "C" {

// Partition boxes[n][4] into similarity classes; labels out (first-
// appearance order).  Returns the number of classes.
int clfd_partition(const int64_t* boxes, int n, double eps,
                   int32_t* labels) {
    std::vector<Rect> r(n);
    for (int i = 0; i < n; i++)
        r[i] = Rect{boxes[4 * i], boxes[4 * i + 1], boxes[4 * i + 2],
                    boxes[4 * i + 3]};
    std::vector<int> parent(n), rank(n, 0);
    for (int i = 0; i < n; i++) parent[i] = i;
    for (int i = 0; i < n; i++)
        for (int j = 0; j < n; j++) {
            if (i == j || !similar(r[i], r[j], eps)) continue;
            int ri = find_root(parent, i), rj = find_root(parent, j);
            if (ri == rj) continue;
            if (rank[ri] < rank[rj]) std::swap(ri, rj);
            parent[rj] = ri;
            if (rank[ri] == rank[rj]) rank[ri]++;
        }
    std::vector<int32_t> root_label(n, -1);
    int ncls = 0;
    for (int i = 0; i < n; i++) {
        int root = find_root(parent, i);
        if (root_label[root] < 0) root_label[root] = ncls++;
        labels[i] = root_label[root];
    }
    return ncls;
}

// Full grouping.  out_boxes must hold n*4 int64, out_neigh n int32.
// Returns the number of kept classes (m); variant 0 = opencv semantics,
// 1 = the reference clod port's buggy containment test (clod.cpp:333-339).
int clfd_group_rectangles(const int64_t* boxes, int n, int group_threshold,
                          double eps, int variant,
                          int64_t* out_boxes, int32_t* out_neigh) {
    if (group_threshold <= 0 || n == 0) {
        for (int i = 0; i < n; i++) {
            for (int k = 0; k < 4; k++) out_boxes[4 * i + k] = boxes[4 * i + k];
            out_neigh[i] = 1;
        }
        return n;
    }
    std::vector<int32_t> labels(n);
    int ncls = clfd_partition(boxes, n, eps, labels.data());

    std::vector<int64_t> sums(4 * ncls, 0);
    std::vector<int32_t> counts(ncls, 0);
    for (int i = 0; i < n; i++) {
        int c = labels[i];
        for (int k = 0; k < 4; k++) sums[4 * c + k] += boxes[4 * i + k];
        counts[c]++;
    }
    // class average with float32 1/n scaling + C truncation
    // (tempcv.cpp:188-195)
    std::vector<Rect> rr(ncls);
    for (int c = 0; c < ncls; c++) {
        float s = 1.f / counts[c];
        rr[c] = Rect{(int64_t)(float(sums[4 * c + 0]) * s),
                     (int64_t)(float(sums[4 * c + 1]) * s),
                     (int64_t)(float(sums[4 * c + 2]) * s),
                     (int64_t)(float(sums[4 * c + 3]) * s)};
    }

    int m = 0;
    for (int i = 0; i < ncls; i++) {
        const Rect& r1 = rr[i];
        int n1 = counts[i];
        if (n1 <= group_threshold) continue;
        bool contained = false;
        for (int j = 0; j < ncls; j++) {
            int n2 = counts[j];
            if (j == i || n2 <= group_threshold) continue;
            const Rect& r2 = rr[j];
            bool inside;
            if (variant == 1) {
                int64_t dx = std::max((int64_t)(r2.w * eps), (int64_t)INT32_MAX);
                int64_t dy = std::max((int64_t)(r2.h * eps), (int64_t)INT32_MAX);
                inside = r1.x >= r2.x - dx && r1.y >= r2.y - dy &&
                         r1.w + r1.w <= r2.x + r2.w + dx &&
                         r1.h + r1.h <= r2.y + r2.h + dy;
            } else {
                int64_t dx = (int64_t)(r2.w * eps);
                int64_t dy = (int64_t)(r2.h * eps);
                inside = r1.x >= r2.x - dx && r1.y >= r2.y - dy &&
                         r1.x + r1.w <= r2.x + r2.w + dx &&
                         r1.y + r1.h <= r2.y + r2.h + dy;
            }
            if (inside && (n2 > std::max(3, n1) || n1 < 3)) {
                contained = true;
                break;
            }
        }
        if (!contained) {
            out_boxes[4 * m + 0] = r1.x;
            out_boxes[4 * m + 1] = r1.y;
            out_boxes[4 * m + 2] = r1.w;
            out_boxes[4 * m + 3] = r1.h;
            out_neigh[m] = n1;
            m++;
        }
    }
    return m;
}

}  // extern "C"
