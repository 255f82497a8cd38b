// Binned-SAH BVH build on the host (the port's own copy of the JAX
// package's native builder, same algorithm and node layout).
//
// Layout contract, identical to the numpy builder in accel/bvh.py (its
// docstring is the spec): depth-first order, internal node i has left
// child i+1 and right child right[i]; leaves have right[i] == -1 and
// prims [first, first+count) in perm order.  The node arrays equal the
// numpy builder's; the order of triangles inside a leaf can differ, since
// the split partitions with std::partition (not stable) where numpy keeps
// the input order.
//
// Built with the host C++ compiler at first use (accel/bvh.py) and
// loaded with ctypes:
//   lrt_bvh_build(v0, v1, v2, T, node_min, node_max, right, first, count,
//                 perm, &n_nodes, &depth, cap)
// Output arrays must be preallocated with cap >= 2*T (worst case node
// count); returns 0 on success, -1 if cap is too small.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int N_BINS = 16;
constexpr int MAX_LEAF = 4;
constexpr float TRAVERSAL_COST = 1.0f;
constexpr float INTERSECT_COST = 1.0f;

struct V3 {
    double x, y, z;
};

inline V3 vmin(const V3& a, const V3& b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(const V3& a, const V3& b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline double area(const V3& lo, const V3& hi) {
    double dx = std::max(hi.x - lo.x, 0.0);
    double dy = std::max(hi.y - lo.y, 0.0);
    double dz = std::max(hi.z - lo.z, 0.0);
    return dx * dy + dy * dz + dz * dx;
}
inline double axis_of(const V3& v, int a) {
    return a == 0 ? v.x : (a == 1 ? v.y : v.z);
}

struct Builder {
    const std::vector<V3>& lo;
    const std::vector<V3>& hi;
    const std::vector<V3>& cen;
    int64_t* perm;
    float* node_min;
    float* node_max;
    int32_t* right;
    int32_t* first;
    int32_t* count;
    int64_t cap;
    int64_t n_nodes = 0;
    int depth = 1;
    bool overflow = false;

    // An explicit stack instead of recursion: a mesh of millions of
    // triangles must not blow the C stack.
    struct Task {
        int64_t s, e;
        int dep;
        int64_t parent;  // node index whose right[] links to this subtree
    };

    int64_t alloc_node(int64_t s, int64_t e, int dep) {
        if (n_nodes >= cap) {
            overflow = true;
            return 0;
        }
        int64_t ni = n_nodes++;
        depth = std::max(depth, dep);
        V3 bmin{1e300, 1e300, 1e300}, bmax{-1e300, -1e300, -1e300};
        for (int64_t i = s; i < e; ++i) {
            bmin = vmin(bmin, lo[perm[i]]);
            bmax = vmax(bmax, hi[perm[i]]);
        }
        node_min[ni * 3] = static_cast<float>(bmin.x);
        node_min[ni * 3 + 1] = static_cast<float>(bmin.y);
        node_min[ni * 3 + 2] = static_cast<float>(bmin.z);
        node_max[ni * 3] = static_cast<float>(bmax.x);
        node_max[ni * 3 + 1] = static_cast<float>(bmax.y);
        node_max[ni * 3 + 2] = static_cast<float>(bmax.z);
        right[ni] = -1;
        first[ni] = static_cast<int32_t>(s);
        count[ni] = static_cast<int32_t>(e - s);
        return ni;
    }

    // Returns split point in [s, e) or -1 for "make a leaf".
    int64_t find_split(int64_t s, int64_t e, const V3& bmin, const V3& bmax) {
        int64_t n = e - s;
        if (n <= MAX_LEAF) return -1;

        V3 cmin{1e300, 1e300, 1e300}, cmax{-1e300, -1e300, -1e300};
        for (int64_t i = s; i < e; ++i) {
            cmin = vmin(cmin, cen[perm[i]]);
            cmax = vmax(cmax, cen[perm[i]]);
        }
        double ext[3] = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
        int axis = 0;
        if (ext[1] > ext[axis]) axis = 1;
        if (ext[2] > ext[axis]) axis = 2;

        if (ext[axis] < 1e-12) return s + n / 2;  // degenerate: median

        double scale = N_BINS * (1.0 - 1e-7) / ext[axis];
        double c0 = axis_of(cmin, axis);

        int64_t bin_cnt[N_BINS] = {};
        V3 bin_lo[N_BINS], bin_hi[N_BINS];
        for (int b = 0; b < N_BINS; ++b) {
            bin_lo[b] = {1e300, 1e300, 1e300};
            bin_hi[b] = {-1e300, -1e300, -1e300};
        }
        std::vector<int8_t> bin_of(n);
        for (int64_t i = s; i < e; ++i) {
            int b = std::min(
                static_cast<int>((axis_of(cen[perm[i]], axis) - c0) * scale),
                N_BINS - 1);
            bin_of[i - s] = static_cast<int8_t>(b);
            bin_cnt[b]++;
            bin_lo[b] = vmin(bin_lo[b], lo[perm[i]]);
            bin_hi[b] = vmax(bin_hi[b], hi[perm[i]]);
        }

        V3 l_lo[N_BINS], l_hi[N_BINS], r_lo[N_BINS], r_hi[N_BINS];
        int64_t l_cnt[N_BINS], r_cnt[N_BINS];
        V3 acc_lo = bin_lo[0], acc_hi = bin_hi[0];
        int64_t acc = bin_cnt[0];
        for (int b = 0; b < N_BINS; ++b) {
            if (b) {
                acc_lo = vmin(acc_lo, bin_lo[b]);
                acc_hi = vmax(acc_hi, bin_hi[b]);
                acc += bin_cnt[b];
            }
            l_lo[b] = acc_lo;
            l_hi[b] = acc_hi;
            l_cnt[b] = acc;
        }
        acc_lo = bin_lo[N_BINS - 1];
        acc_hi = bin_hi[N_BINS - 1];
        acc = bin_cnt[N_BINS - 1];
        for (int b = N_BINS - 1; b >= 0; --b) {
            if (b < N_BINS - 1) {
                acc_lo = vmin(acc_lo, bin_lo[b]);
                acc_hi = vmax(acc_hi, bin_hi[b]);
                acc += bin_cnt[b];
            }
            r_lo[b] = acc_lo;
            r_hi[b] = acc_hi;
            r_cnt[b] = acc;
        }

        double best_cost = 1e300;
        int best = -1;
        for (int b = 0; b < N_BINS - 1; ++b) {
            if (l_cnt[b] == 0 || r_cnt[b + 1] == 0) continue;
            double c = area(l_lo[b], l_hi[b]) * l_cnt[b] +
                       area(r_lo[b + 1], r_hi[b + 1]) * r_cnt[b + 1];
            if (c < best_cost) {
                best_cost = c;
                best = b;
            }
        }

        if (best < 0) {  // all prims in one bin: sorted median split
            std::sort(perm + s, perm + e, [&](int64_t a, int64_t b2) {
                return axis_of(cen[a], axis) < axis_of(cen[b2], axis);
            });
            return s + n / 2;
        }

        double parent_area = std::max(area(bmin, bmax), 1e-30);
        double split_cost = TRAVERSAL_COST + best_cost / parent_area;
        if (split_cost >= INTERSECT_COST * n && n <= 8 * MAX_LEAF) return -1;

        int64_t mid = std::partition(perm + s, perm + e,
                                     [&](int64_t t) {
                                         int b = std::min(
                                             static_cast<int>(
                                                 (axis_of(cen[t], axis) - c0) *
                                                 scale),
                                             N_BINS - 1);
                                         return b <= best;
                                     }) -
                      perm;
        if (mid == s || mid == e) mid = s + n / 2;
        return mid;
    }

    void build(int64_t total) {
        std::vector<Task> stack;
        stack.push_back({0, total, 1, -1});
        while (!stack.empty() && !overflow) {
            Task t = stack.back();
            stack.pop_back();
            int64_t ni = alloc_node(t.s, t.e, t.dep);
            if (overflow) return;
            if (t.parent >= 0) right[t.parent] = static_cast<int32_t>(ni);
            V3 bmin{node_min[ni * 3], node_min[ni * 3 + 1],
                    node_min[ni * 3 + 2]};
            V3 bmax{node_max[ni * 3], node_max[ni * 3 + 1],
                    node_max[ni * 3 + 2]};
            int64_t mid = find_split(t.s, t.e, bmin, bmax);
            if (mid < 0) continue;  // leaf: first/count already set
            first[ni] = 0;
            count[ni] = 0;
            // depth-first: left child must be ni+1 -> push right first
            stack.push_back({mid, t.e, t.dep + 1, ni});
            stack.push_back({t.s, mid, t.dep + 1, -2});
        }
    }
};

}  // namespace

extern "C" {

int lrt_bvh_build(const float* v0, const float* v1, const float* v2,
                  int64_t T, float* node_min, float* node_max, int32_t* right,
                  int32_t* first, int32_t* count, int32_t* perm_out,
                  int64_t* n_nodes, int32_t* depth, int64_t cap) {
    if (T == 0) {
        if (cap < 1) return -1;
        for (int k = 0; k < 3; ++k) node_min[k] = node_max[k] = 0.0f;
        right[0] = -1;
        first[0] = 0;
        count[0] = 0;
        *n_nodes = 1;
        *depth = 1;
        return 0;
    }
    std::vector<V3> lo(T), hi(T), cen(T);
    for (int64_t i = 0; i < T; ++i) {
        V3 a{v0[i * 3], v0[i * 3 + 1], v0[i * 3 + 2]};
        V3 b{v1[i * 3], v1[i * 3 + 1], v1[i * 3 + 2]};
        V3 c{v2[i * 3], v2[i * 3 + 1], v2[i * 3 + 2]};
        lo[i] = vmin(vmin(a, b), c);
        hi[i] = vmax(vmax(a, b), c);
        cen[i] = {0.5 * (lo[i].x + hi[i].x), 0.5 * (lo[i].y + hi[i].y),
                  0.5 * (lo[i].z + hi[i].z)};
    }
    std::vector<int64_t> perm(T);
    for (int64_t i = 0; i < T; ++i) perm[i] = i;

    Builder bld{lo,    hi,    cen,  perm.data(), node_min, node_max,
                right, first, count, cap};
    bld.build(T);
    if (bld.overflow) return -1;
    for (int64_t i = 0; i < T; ++i)
        perm_out[i] = static_cast<int32_t>(perm[i]);
    *n_nodes = bld.n_nodes;
    *depth = bld.depth;
    return 0;
}

}  // extern "C"
