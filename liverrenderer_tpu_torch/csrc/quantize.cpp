// The two quantisers of liverrenderer_tpu_torch/io/quantize.py, Pillow
// 12.1's median cut (libImaging/Quant.c) and fast octree (QuantOctree.c).
// quantize.py keeps each one's plain version (`_median_cut_plain`,
// `_octree_plain`) with the same contract; the tests hold the two equal
// and both to Pillow.  Compiled with the host C++ compiler at first use
// (host_build.py) and called through ctypes.
//
// Both quantise to Pillow's default of 256 colours.
//
// lrt_median_cut(px, n, pal, idx) -> palette entries.  px is n RGB
//   triples; pal gets up to 256 RGB triples, idx n palette indices.
//   Distinct colours counted at the fewest dropped low bits that leave at
//   most 65,536 of them; boxes split from a max-heap on pixel count in
//   QuantHeap.c's sift order, along the widest channel weighted 77 / 150
//   / 29, at the colour where the count passes half (its equals on the
//   high side); leaves high before low; a pixel takes the nearest palette
//   colour among its box colour's neighbours, scanned in distance order
//   (ties by index) while within four times its own box's distance.
//
// lrt_octree(px, n, pal, idx) -> 256.  px is n RGBA quads; pal gets 256
//   RGBA quads.  Fine (3, 4, 3, 3 bits of R, G, B, A) and coarse (2 bits
//   each) bucket cubes, the used coarse buckets plus the most used
//   fine buckets (counts sorted stably, descending), a bucket's colour its
//   float32 mean truncated; transparent pixels first take the colour of
//   the first transparent one.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kMaxHashEntries = 65536;
constexpr int kColors = 256;

struct Box {
    std::vector<int32_t> idx;   // distinct scaled colours in the box
    int64_t count = 0;          // pixels
    int volume = -1;
    int l = -1, r = -1;         // children in the box pool
};

int box_volume(Box& b, const std::vector<int32_t>& uq) {
    if (b.volume >= 0) return b.volume;
    int lo[3] = {255, 255, 255}, hi[3] = {0, 0, 0};
    for (int32_t i : b.idx)
        for (int c = 0; c < 3; ++c) {
            int v = uq[3 * i + c];
            lo[c] = std::min(lo[c], v);
            hi[c] = std::max(hi[c], v);
        }
    b.volume = (hi[0] - lo[0] + 1) * (hi[1] - lo[1] + 1) * (hi[2] - lo[2] + 1);
    return b.volume;
}

// QuantHeap.c on box indices, compared by pixel count
struct Heap {
    std::vector<int> h{0};
    const std::vector<Box>* boxes;
    int cf(int a, int b) const {
        return int((*boxes)[a].count) - int((*boxes)[b].count);
    }
    void add(int v) {
        h.push_back(v);
        size_t k = h.size() - 1;
        while (k != 1) {
            if (cf(v, h[k / 2]) <= 0) break;
            h[k] = h[k / 2];
            k >>= 1;
        }
        h[k] = v;
    }
    bool remove(int* out) {
        size_t n = h.size() - 1;
        if (!n) return false;
        *out = h[1];
        int v = h.back();
        h.pop_back();
        --n;
        if (!n) return true;
        size_t k = 1, l;
        for (; k * 2 <= n; k = l) {
            l = k * 2;
            if (l < n && cf(h[l], h[l + 1]) < 0) ++l;
            if (cf(v, h[l]) > 0) break;
            h[k] = h[l];
        }
        h[k] = v;
        return true;
    }
};

void split(std::vector<Box>& pool, int bi, const std::vector<int32_t>& uq,
           const std::vector<int64_t>& cnt) {
    Box& b = pool[bi];
    int lo[3] = {255, 255, 255}, hi[3] = {0, 0, 0};
    for (int32_t i : b.idx)
        for (int c = 0; c < 3; ++c) {
            int v = uq[3 * i + c];
            lo[c] = std::min(lo[c], v);
            hi[c] = std::max(hi[c], v);
        }
    const int w[3] = {77, 150, 29};
    int axis = 0, best = (hi[0] - lo[0]) * w[0];
    for (int c = 1; c < 3; ++c)
        if (best < (hi[c] - lo[c]) * w[c]) {
            best = (hi[c] - lo[c]) * w[c];
            axis = c;
        }
    // pixels per value of the axis, walked from the top value down
    int64_t per[256] = {0};
    for (int32_t i : b.idx) per[uq[3 * i + axis]] += cnt[i];
    int split_val = -1;
    int64_t left = 0;
    for (int v = 255; v >= 0; --v) {
        if (!per[v]) continue;
        left += per[v];
        if (left * 2 > b.count) {
            split_val = v;
            break;
        }
    }
    // the high side: values >= split_val; if nothing is below, the lowest
    // value goes to the low side
    int minv = lo[axis];
    if (split_val <= minv) split_val = minv + 1;
    Box L, R;
    for (int32_t i : b.idx) {
        if (uq[3 * i + axis] >= split_val) {
            L.idx.push_back(i);
            L.count += cnt[i];
        } else {
            R.idx.push_back(i);
            R.count += cnt[i];
        }
    }
    pool.push_back(std::move(L));
    pool.push_back(std::move(R));
    pool[bi].l = int(pool.size()) - 2;
    pool[bi].r = int(pool.size()) - 1;
    pool[bi].idx.clear();
    pool[bi].idx.shrink_to_fit();
}

inline uint32_t dist2(const uint8_t* a, const uint8_t* b) {
    int d0 = int(a[0]) - b[0], d1 = int(a[1]) - b[1], d2 = int(a[2]) - b[2];
    return uint32_t(d0 * d0 + d1 * d1 + d2 * d2);
}

int count_distinct(const uint8_t* px, int64_t n, int s,
                   std::vector<uint64_t>& bits) {
    std::fill(bits.begin(), bits.end(), 0);
    int count = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint32_t k = uint32_t(px[3 * i] >> s) << 16 |
                     uint32_t(px[3 * i + 1] >> s) << 8 | (px[3 * i + 2] >> s);
        uint64_t m = uint64_t(1) << (k & 63);
        if (!(bits[k >> 6] & m)) {
            bits[k >> 6] |= m;
            ++count;
        }
    }
    return count;
}

// QuantOctree.c's cubes
struct Cube {
    int bits[4];
    std::vector<int64_t> count, sum;     // sum: 4 per bucket
    explicit Cube(const int* b) {
        std::memcpy(bits, b, sizeof(bits));
        size_t n = size_t(1) << (b[0] + b[1] + b[2] + b[3]);
        count.assign(n, 0);
        sum.assign(4 * n, 0);
    }
    size_t size() const { return count.size(); }
    size_t pos(unsigned r, unsigned g, unsigned b, unsigned a) const {
        return size_t(r) << (bits[1] + bits[2] + bits[3]) |
               size_t(g) << (bits[2] + bits[3]) | size_t(b) << bits[3] | a;
    }
    size_t offset(const uint8_t* p) const {
        return pos(p[0] >> (8 - bits[0]), p[1] >> (8 - bits[1]),
                   p[2] >> (8 - bits[2]), p[3] >> (8 - bits[3]));
    }
};

void bucket_avg(int64_t count, const int64_t* sum, uint8_t* dst) {
    if (count == 0) {
        std::memset(dst, 0, 4);
        return;
    }
    float c = float(count);
    for (int k = 0; k < 4; ++k) {
        int v = int(float(uint64_t(sum[k])) / c);
        dst[k] = uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
    }
}

// copy_color_cube: bucket of `to` that each bucket of `from` lands in (or
// comes from) when the cube shrinks or grows
std::vector<size_t> coarse_of_fine(const Cube& fine, const Cube& coarse) {
    std::vector<size_t> out(fine.size());
    int d[4];
    for (int k = 0; k < 4; ++k) d[k] = fine.bits[k] - coarse.bits[k];
    for (unsigned r = 0; r < (1u << fine.bits[0]); ++r)
        for (unsigned g = 0; g < (1u << fine.bits[1]); ++g)
            for (unsigned b = 0; b < (1u << fine.bits[2]); ++b)
                for (unsigned a = 0; a < (1u << fine.bits[3]); ++a)
                    out[fine.pos(r, g, b, a)] =
                        coarse.pos(r >> d[0], g >> d[1], b >> d[2], a >> d[3]);
    return out;
}

std::vector<int64_t> sorted_by_count(const std::vector<int64_t>& count) {
    std::vector<int64_t> order(count.size());
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        return count[a] > count[b];
    });
    return order;
}

int64_t used(const std::vector<int64_t>& count) {
    return std::count_if(count.begin(), count.end(),
                         [](int64_t c) { return c > 0; });
}

}  // namespace

extern "C" int32_t lrt_median_cut(const uint8_t* px, int64_t n,
                                  uint8_t* pal, uint8_t* idx) {
    if (n <= 0) return 0;
    std::vector<uint64_t> bits((size_t(1) << 24) / 64);
    int s = 0;
    while (s < 8 && count_distinct(px, n, s, bits) > kMaxHashEntries) ++s;
    // distinct scaled colours and their pixel counts
    std::unordered_map<uint32_t, int32_t> slot;
    std::vector<int32_t> uq, key_of(n);
    std::vector<int64_t> cnt;
    for (int64_t i = 0; i < n; ++i) {
        uint32_t k = uint32_t(px[3 * i] >> s) << 16 |
                     uint32_t(px[3 * i + 1] >> s) << 8 | (px[3 * i + 2] >> s);
        auto it = slot.find(k);
        if (it == slot.end()) {
            it = slot.emplace(k, int32_t(cnt.size())).first;
            cnt.push_back(0);
            uq.push_back(int32_t(k >> 16));
            uq.push_back(int32_t((k >> 8) & 255));
            uq.push_back(int32_t(k & 255));
        }
        cnt[it->second] += 1;
        key_of[i] = it->second;
    }
    std::vector<Box> pool(1);
    pool[0].idx.resize(cnt.size());
    std::iota(pool[0].idx.begin(), pool[0].idx.end(), 0);
    pool[0].count = n;
    pool.reserve(2 * size_t(kColors) + 1);
    Heap heap;
    heap.boxes = &pool;
    heap.add(0);
    for (int it = 0; it < kColors - 1; ++it) {
        int bi = -1;
        bool got;
        while ((got = heap.remove(&bi)) && box_volume(pool[bi], uq) == 1) {
        }
        if (!got) break;
        split(pool, bi, uq, cnt);
        heap.add(pool[bi].l);
        heap.add(pool[bi].r);
    }
    // leaves, high side first
    std::vector<int32_t> leaf_of(cnt.size(), 0);
    int n_pal = 0;
    std::vector<int> stack{0};
    while (!stack.empty()) {
        int b = stack.back();
        stack.pop_back();
        if (pool[b].l >= 0) {
            stack.push_back(pool[b].r);
            stack.push_back(pool[b].l);
        } else if (!pool[b].idx.empty()) {
            for (int32_t i : pool[b].idx) leaf_of[i] = n_pal;
            ++n_pal;
        }
    }
    std::vector<uint64_t> sum(3 * n_pal, 0), num(n_pal, 0);
    for (int64_t i = 0; i < n; ++i) {
        int e = leaf_of[key_of[i]];
        for (int c = 0; c < 3; ++c) sum[3 * e + c] += px[3 * i + c];
        num[e] += 1;
    }
    for (int e = 0; e < n_pal; ++e)
        for (int c = 0; c < 3; ++c)
            pal[3 * e + c] = uint8_t(int(.5 + double(sum[3 * e + c]) /
                                               double(num[e])));
    // map_image_pixels_from_median_box
    std::vector<uint32_t> avg(size_t(n_pal) * n_pal);
    std::vector<int32_t> order(size_t(n_pal) * n_pal);
    for (int i = 0; i < n_pal; ++i) {
        for (int j = 0; j < n_pal; ++j)
            avg[size_t(i) * n_pal + j] = dist2(pal + 3 * i, pal + 3 * j);
        int32_t* o = &order[size_t(i) * n_pal];
        std::iota(o, o + n_pal, 0);
        const uint32_t* row = &avg[size_t(i) * n_pal];
        std::stable_sort(o, o + n_pal,
                         [&](int32_t a, int32_t b) { return row[a] < row[b]; });
    }
    std::unordered_map<uint32_t, uint8_t> seen;
    seen.reserve(size_t(std::min<int64_t>(n, 1 << 20)));
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* p = px + 3 * i;
        uint32_t full = uint32_t(p[0]) << 16 | uint32_t(p[1]) << 8 | p[2];
        auto it = seen.find(full);
        if (it != seen.end()) {
            idx[i] = it->second;
            continue;
        }
        int own = leaf_of[key_of[i]];
        uint32_t bestdist = dist2(pal + 3 * own, p);
        uint32_t initial = bestdist << 2;
        int best = own;
        const int32_t* o = &order[size_t(own) * n_pal];
        const uint32_t* row = &avg[size_t(own) * n_pal];
        for (int j = 0; j < n_pal; ++j) {
            if (row[o[j]] > initial) break;
            uint32_t d = dist2(pal + 3 * o[j], p);
            if (d < bestdist) {
                bestdist = d;
                best = o[j];
            }
        }
        idx[i] = uint8_t(best);
        seen.emplace(full, uint8_t(best));
    }
    return n_pal;
}

extern "C" int32_t lrt_octree(const uint8_t* px_in, int64_t n,
                              uint8_t* pal, uint8_t* idx) {
    if (n <= 0) return 0;
    static const int kFine[4] = {3, 4, 3, 3}, kCoarse[4] = {2, 2, 2, 2};
    std::vector<uint8_t> px(px_in, px_in + 4 * n);
    int64_t first = -1;
    for (int64_t i = 0; i < n; ++i) {
        if (px[4 * i + 3]) continue;
        if (first < 0) {
            first = i;
        } else {
            std::memcpy(&px[4 * i], &px[4 * first], 3);
        }
    }
    Cube fine(kFine), coarse(kCoarse);
    std::vector<size_t> fb(n);
    for (int64_t i = 0; i < n; ++i) {
        size_t b = fine.offset(&px[4 * i]);
        fb[i] = b;
        fine.count[b] += 1;
        for (int k = 0; k < 4; ++k) fine.sum[4 * b + k] += px[4 * i + k];
    }
    std::vector<size_t> to_coarse = coarse_of_fine(fine, coarse);
    for (size_t b = 0; b < fine.size(); ++b) {
        coarse.count[to_coarse[b]] += fine.count[b];
        for (int k = 0; k < 4; ++k)
            coarse.sum[4 * to_coarse[b] + k] += fine.sum[4 * b + k];
    }
    int64_t n_coarse = std::min<int64_t>(used(coarse.count), kColors);
    int64_t n_fine = kColors - n_coarse;
    std::vector<int64_t> f_order = sorted_by_count(fine.count);
    auto subtract = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            size_t b = size_t(f_order[i]);
            if (!fine.count[b]) continue;
            uint8_t p[4];
            bucket_avg(fine.count[b], &fine.sum[4 * b], p);
            size_t c = coarse.offset(p);
            coarse.count[c] -= fine.count[b];
            for (int k = 0; k < 4; ++k)
                coarse.sum[4 * c + k] -= fine.sum[4 * b + k];
        }
    };
    subtract(0, n_fine);
    while (n_coarse > used(coarse.count)) {
        int64_t done = n_fine;
        n_coarse = used(coarse.count);
        n_fine = kColors - n_coarse;
        subtract(done, n_fine);
    }
    std::vector<int64_t> c_order = sorted_by_count(coarse.count);
    for (int64_t i = 0; i < kColors; ++i) {
        if (i < n_coarse) {
            size_t b = size_t(c_order[i]);
            bucket_avg(coarse.count[b], &coarse.sum[4 * b], pal + 4 * i);
        } else {
            size_t b = size_t(f_order[i - n_coarse]);
            bucket_avg(fine.count[b], &fine.sum[4 * b], pal + 4 * i);
        }
    }
    std::vector<int32_t> coarse_lut(coarse.size(), 0);
    for (int64_t i = n_coarse - 1; i >= 0; --i)
        coarse_lut[coarse.offset(pal + 4 * i)] = int32_t(i);
    std::vector<int32_t> lut(fine.size());
    for (size_t b = 0; b < fine.size(); ++b) lut[b] = coarse_lut[to_coarse[b]];
    for (int64_t i = n_coarse + n_fine - 1; i >= n_coarse; --i)
        lut[fine.offset(pal + 4 * i)] = int32_t(i);
    for (int64_t i = 0; i < n; ++i) idx[i] = uint8_t(lut[fb[i]]);
    return kColors;
}
