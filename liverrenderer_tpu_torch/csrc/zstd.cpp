// The Zstandard frame decoder (RFC 8878) of liverrenderer_tpu_torch/io/
// zstd.py, as libtiff's ZSTD codec has libzstd decode a TIFF strip or
// tile.  zstd.py keeps the plain Python version (`_decode_plain`) with the
// same contract; the tests hold the two equal.  Compiled with the host C++
// compiler at first use (host_build.py) and called through ctypes.
//
// lrt_zstd_decode(src, n, dst, occ) -> the bytes written to dst (at most
//   occ), or -1 where libzstd returns an error.  The first frame of src:
//   decoded in one pass when its content size is known, no larger than
//   occ and the whole frame is in src (any error fails); otherwise block by
//   block until occ bytes are out, one more block (and the checksum) read
//   only when a block filled occ exactly, and the bytes so far returned
//   where the data runs out.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Error {};

constexpr int64_t kBlockMax = 1 << 17;
constexpr uint32_t kMagic = 0xFD2FB528u, kSkipMagic = 0x184D2A50u;

const uint32_t kLLBase[36][2] = {
    {0, 0}, {1, 0}, {2, 0}, {3, 0}, {4, 0}, {5, 0}, {6, 0}, {7, 0},
    {8, 0}, {9, 0}, {10, 0}, {11, 0}, {12, 0}, {13, 0}, {14, 0}, {15, 0},
    {16, 1}, {18, 1}, {20, 1}, {22, 1}, {24, 2}, {28, 2}, {32, 3}, {40, 3},
    {48, 4}, {64, 6}, {128, 7}, {256, 8}, {512, 9}, {1024, 10}, {2048, 11},
    {4096, 12}, {8192, 13}, {16384, 14}, {32768, 15}, {65536, 16}};
const uint32_t kMLBase[53][2] = {
    {3, 0}, {4, 0}, {5, 0}, {6, 0}, {7, 0}, {8, 0}, {9, 0}, {10, 0},
    {11, 0}, {12, 0}, {13, 0}, {14, 0}, {15, 0}, {16, 0}, {17, 0}, {18, 0},
    {19, 0}, {20, 0}, {21, 0}, {22, 0}, {23, 0}, {24, 0}, {25, 0}, {26, 0},
    {27, 0}, {28, 0}, {29, 0}, {30, 0}, {31, 0}, {32, 0}, {33, 0}, {34, 0},
    {35, 1}, {37, 1}, {39, 1}, {41, 1}, {43, 2}, {47, 2}, {51, 3}, {59, 3},
    {67, 4}, {83, 4}, {99, 5}, {131, 7}, {259, 8}, {515, 9}, {1027, 10},
    {2051, 11}, {4099, 12}, {8195, 13}, {16387, 14}, {32771, 15},
    {65539, 16}};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1,
                                1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1,
                                1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1,
    -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1,
                                -1};

int highbit(uint64_t x) { return 63 - __builtin_clzll(x); }

uint64_t le(const uint8_t* p, int n) {
    uint64_t v = 0;
    for (int k = n - 1; k >= 0; --k) v = (v << 8) | p[k];
    return v;
}

// ---------------------------------------------------------------- XXH64
constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                   P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                   P5 = 2870177450012600261ull;
uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
uint64_t xxh64(const uint8_t* d, int64_t n) {
    int64_t p = 0;
    uint64_t h;
    if (n >= 32) {
        uint64_t v[4] = {P1 + P2, P2, 0, 0 - P1};
        while (p + 32 <= n) {
            for (int k = 0; k < 4; ++k, p += 8)
                v[k] = rotl(v[k] + le(d + p, 8) * P2, 31) * P1;
        }
        h = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18);
        for (int k = 0; k < 4; ++k) {
            h ^= rotl(v[k] * P2, 31) * P1;
            h = h * P1 + P4;
        }
    } else {
        h = P5;
    }
    h += uint64_t(n);
    for (; p + 8 <= n; p += 8) h = rotl(h ^ (rotl(le(d + p, 8) * P2, 31) * P1), 27) * P1 + P4;
    if (p + 4 <= n) {
        h = rotl(h ^ (le(d + p, 4) * P1), 23) * P2 + P3;
        p += 4;
    }
    for (; p < n; ++p) h = rotl(h ^ (d[p] * P5), 11) * P1;
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    return h ^ (h >> 32);
}

// ---------------------------------------------- the backward bit stream
struct Back {
    const uint8_t* d;
    int64_t pos;     // bits not yet read, counted from the stream's start
    Back(const uint8_t* data, int64_t n) : d(data) {
        if (n <= 0 || data[n - 1] == 0) throw Error{};
        pos = 8 * n - (8 - highbit(data[n - 1]));
    }
    int bit(int64_t i) const { return i >= 0 ? (d[i >> 3] >> (i & 7)) & 1 : 0; }
    uint32_t peek(int n) const {
        if (n == 0) return 0;
        const int64_t lo = pos - n;
        if (lo >= 0 && ((lo & 7) + n) <= 57) {
            uint64_t v = 0;
            const int64_t b0 = lo >> 3, b1 = (pos - 1) >> 3;
            for (int64_t b = b1; b >= b0; --b) v = (v << 8) | d[b];
            return uint32_t((v >> (lo & 7)) & ((1ull << n) - 1));
        }
        uint32_t v = 0;
        for (int64_t i = pos - 1; i >= lo; --i) v = (v << 1) | uint32_t(bit(i));
        return v;
    }
    uint32_t read(int n) {
        const uint32_t v = peek(n);
        pos -= n;
        return v;
    }
};

// --------------------------------------------------------- FSE tables
struct FseEntry {
    uint16_t symbol;
    uint8_t nb;
    uint32_t base;
};
struct Fse {
    int log = 0;
    std::vector<FseEntry> t;
};

// FSE_readNCount -> bytes used
int64_t read_ncount(const uint8_t* data, int64_t n, int max_sym, int& log,
                    std::vector<int>& counts) {
    uint8_t buf[8] = {0};
    const uint8_t* src = data;
    int64_t len = n;
    if (n < 8) {
        memcpy(buf, data, size_t(n));
        src = buf;
        len = 8;
    }
    int64_t pos = 0;
    auto peekb = [&](int k) -> uint32_t {
        uint32_t v = 0;
        for (int i = k - 1; i >= 0; --i) {
            const int64_t b = pos + i;
            v = (v << 1) | (b < 8 * len ? (src[b >> 3] >> (b & 7)) & 1 : 0);
        }
        return v;
    };
    auto bits = [&](int k) {
        const uint32_t v = peekb(k);
        pos += k;
        return v;
    };
    log = int(bits(4)) + 5;
    if (log > 15) throw Error{};
    int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
    counts.clear();
    bool prev0 = false;
    for (;;) {
        if (prev0) {
            for (;;) {
                const uint32_t r = bits(2);
                for (uint32_t k = 0; k < r; ++k) counts.push_back(0);
                if (r != 3) break;
            }
            if (int(counts.size()) > max_sym) break;
        }
        const int mx = 2 * threshold - 1 - remaining;
        int count;
        const uint32_t low = peekb(nbits - 1);
        if (int(low) < mx) {
            count = int(low);
            pos += nbits - 1;
        } else {
            count = int(peekb(nbits));
            if (count >= threshold) count -= mx;
            pos += nbits;
        }
        --count;
        remaining -= count < 0 ? -count : count;
        counts.push_back(count);
        prev0 = count == 0;
        if (remaining < threshold) {
            if (remaining <= 1) break;
            nbits = highbit(uint64_t(remaining)) + 1;
            threshold = 1 << (nbits - 1);
        }
        if (int(counts.size()) > max_sym) break;
    }
    const int64_t used = (pos + 7) / 8;
    if (remaining != 1 || int(counts.size()) > max_sym + 1 || used > n)
        throw Error{};
    return used;
}

Fse fse_table(int log, const std::vector<int>& counts) {
    const int size = 1 << log;
    std::vector<uint16_t> sym(size, 0);
    std::vector<uint32_t> nxt(counts.size());
    int high = size - 1;
    for (size_t s = 0; s < counts.size(); ++s) {
        if (counts[s] == -1) {
            if (high < 0) throw Error{};
            sym[high--] = uint16_t(s);
            nxt[s] = 1;
        } else {
            nxt[s] = uint32_t(counts[s]);
        }
    }
    const int step = (size >> 1) + (size >> 3) + 3;
    int pos = 0;
    for (size_t s = 0; s < counts.size(); ++s) {
        for (int k = 0; k < counts[s]; ++k) {
            sym[pos] = uint16_t(s);
            pos = (pos + step) & (size - 1);
            while (pos > high) pos = (pos + step) & (size - 1);
        }
    }
    if (pos != 0) throw Error{};
    Fse f;
    f.log = log;
    f.t.resize(size);
    for (int u = 0; u < size; ++u) {
        const uint16_t s = sym[u];
        const uint32_t n = nxt[s]++;
        const int nb = log - highbit(n);
        f.t[u] = {s, uint8_t(nb), (n << nb) - uint32_t(size)};
    }
    return f;
}

Fse fse_default(const int16_t* c, int n, int log) {
    return fse_table(log, std::vector<int>(c, c + n));
}

// ------------------------------------------------------------- Huffman
struct Huf {
    int log = 0;
    std::vector<uint16_t> sym;
    std::vector<uint8_t> nb;
};

std::vector<int> fse_weights(const uint8_t* d, int64_t n) {
    int log;
    std::vector<int> counts;
    const int64_t used = read_ncount(d, n, 255, log, counts);
    if (log > 6) throw Error{};
    const Fse f = fse_table(log, counts);
    Back bs(d + used, n - used);
    uint32_t s1 = bs.read(log), s2 = bs.read(log);
    std::vector<int> out;
    for (;;) {
        if (out.size() > 253) throw Error{};
        FseEntry e = f.t[s1];
        out.push_back(e.symbol);
        s1 = e.base + bs.read(e.nb);
        if (bs.pos < 0) {
            out.push_back(f.t[s2].symbol);
            break;
        }
        if (out.size() > 253) throw Error{};
        e = f.t[s2];
        out.push_back(e.symbol);
        s2 = e.base + bs.read(e.nb);
        if (bs.pos < 0) {
            out.push_back(f.t[s1].symbol);
            break;
        }
    }
    return out;
}

// HUF_readStats + HUF_readDTableX1 -> bytes used
int64_t huf_table(const uint8_t* d, int64_t n, Huf& h) {
    if (n < 1) throw Error{};
    const int head = d[0];
    std::vector<int> w;
    int64_t used;
    if (head >= 128) {
        const int cnt = head - 127, size = (cnt + 1) / 2;
        if (1 + size > n) throw Error{};
        for (int k = 0; k < size; ++k) {
            w.push_back(d[1 + k] >> 4);
            w.push_back(d[1 + k] & 15);
        }
        w.resize(size_t(cnt));
        used = 1 + size;
    } else {
        if (1 + head > n) throw Error{};
        w = fse_weights(d + 1, head);
        used = 1 + head;
    }
    uint32_t total = 0;
    for (int x : w) {
        if (x > 12) throw Error{};
        total += (1u << x) >> 1;
    }
    if (total == 0) throw Error{};
    const int log = highbit(total) + 1;
    if (log > 12) throw Error{};
    const uint32_t rest = (1u << log) - total;
    if (rest & (rest - 1)) throw Error{};
    w.push_back(highbit(rest) + 1);
    int ones = 0;
    for (int x : w) ones += x == 1;
    if (ones < 2 || (ones & 1)) throw Error{};
    std::vector<int> rank(log + 2, 0), start(log + 2, 0);
    for (int x : w) ++rank[x];
    int next = 0;
    for (int k = 1; k <= log; ++k) {
        start[k] = next;
        next += rank[k] << (k - 1);
    }
    h.log = log;
    h.sym.assign(size_t(1) << log, 0);
    h.nb.assign(size_t(1) << log, 0);
    for (size_t s = 0; s < w.size(); ++s) {
        const int x = w[s];
        if (!x) continue;
        const int cnt = (1 << x) >> 1;
        for (int k = 0; k < cnt; ++k) {
            h.sym[start[x] + k] = uint16_t(s);
            h.nb[start[x] + k] = uint8_t(log + 1 - x);
        }
        start[x] += cnt;
    }
    return used;
}

void huf_stream(const uint8_t* d, int64_t n, int64_t count, const Huf& h,
                uint8_t* out) {
    Back bs(d, n);
    for (int64_t i = 0; i < count; ++i) {
        const uint32_t k = bs.peek(h.log);
        out[i] = uint8_t(h.sym[k]);
        bs.pos -= h.nb[k];
    }
    if (bs.pos != 0) throw Error{};
}

// -------------------------------------------------------------- frame
struct Frame {
    bool has_huf = false;
    Huf huf;
    bool has_table[3] = {false, false, false};
    Fse tables[3];      // LL, OF, ML
    int64_t reps[3] = {1, 4, 8};
    std::vector<uint8_t> lits;

    int64_t literals(const uint8_t* b, int64_t n) {
        const int kind = b[0] & 3, sf = (b[0] >> 2) & 3;
        if (kind <= 1) {
            int64_t size, hs;
            if (sf == 0 || sf == 2) {
                size = b[0] >> 3;
                hs = 1;
            } else if (sf == 1) {
                if (n < 2) throw Error{};
                size = (b[0] >> 4) + (int64_t(b[1]) << 4);
                hs = 2;
            } else {
                if (n < 3) throw Error{};
                size = (b[0] >> 4) + (int64_t(b[1]) << 4) + (int64_t(b[2]) << 12);
                hs = 3;
            }
            if (size > kBlockMax) throw Error{};
            if (kind == 0) {
                if (hs + size > n) throw Error{};
                lits.assign(b + hs, b + hs + size);
                return hs + size;
            }
            if (hs + 1 > n) throw Error{};
            lits.assign(size_t(size), b[hs]);
            return hs + 1;
        }
        const int hs = sf <= 1 ? 3 : sf + 2;
        if (n < hs) throw Error{};
        const uint64_t v = le(b, hs) >> 4;
        const int bits = sf <= 1 ? 10 : (sf == 2 ? 14 : 18);
        const int64_t size = int64_t(v & ((1ull << bits) - 1)),
                      csize = int64_t(v >> bits);
        if (size > kBlockMax) throw Error{};
        if (hs + csize > n) throw Error{};
        const uint8_t* data = b + hs;
        int64_t p = 0;
        if (kind == 2) {
            p = huf_table(data, csize, huf);
            has_huf = true;
        } else if (!has_huf) {
            throw Error{};
        }
        lits.assign(size_t(size), 0);
        if (sf == 0) {
            huf_stream(data + p, csize - p, size, huf, lits.data());
            return hs + csize;
        }
        const uint8_t* body = data + p;
        const int64_t blen = csize - p;
        if (blen < 10 || size < 6) throw Error{};
        const int64_t l[3] = {int64_t(le(body, 2)), int64_t(le(body + 2, 2)),
                              int64_t(le(body + 4, 2))};
        const int64_t l4 = blen - 6 - l[0] - l[1] - l[2];
        if (l4 < 0) throw Error{};
        const int64_t seg = (size + 3) / 4;
        if (3 * seg > size) throw Error{};
        int64_t q = 6;
        for (int k = 0; k < 4; ++k) {
            const int64_t length = k < 3 ? l[k] : l4;
            huf_stream(body + q, length, k < 3 ? seg : size - 3 * seg, huf,
                       lits.data() + k * seg);
            q += length;
        }
        return hs + csize;
    }

    // `limit` bounds `out`: the block's largest size, checked before each
    // sequence is written, as libzstd's ZSTD_execSequence checks its room.
    void sequences(const uint8_t* b, int64_t n, std::vector<uint8_t>& out,
                   int64_t limit) {
        if (n < 1) throw Error{};
        int64_t nseq = b[0], p = 1;
        if (nseq >= 128) {
            if (nseq < 255) {
                if (n < 2) throw Error{};
                nseq = ((nseq - 128) << 8) + b[1];
                p = 2;
            } else {
                if (n < 3) throw Error{};
                nseq = b[1] + (int64_t(b[2]) << 8) + 0x7F00;
                p = 3;
            }
        }
        if (nseq == 0) {
            if (p != n) throw Error{};
            if (int64_t(out.size() + lits.size()) > limit) throw Error{};
            out.insert(out.end(), lits.begin(), lits.end());
            return;
        }
        if (p >= n) throw Error{};
        const int modes = b[p++];
        if (modes & 3) throw Error{};
        static const int shifts[3] = {6, 4, 2}, max_sym[3] = {35, 31, 52},
                         max_log[3] = {9, 8, 9};
        for (int k = 0; k < 3; ++k) {
            const int mode = (modes >> shifts[k]) & 3;
            if (mode == 0) {
                tables[k] = k == 0 ? fse_default(kLLDefault, 36, 6)
                          : k == 1 ? fse_default(kOFDefault, 29, 5)
                                   : fse_default(kMLDefault, 53, 6);
                has_table[k] = true;
            } else if (mode == 1) {
                if (p >= n) throw Error{};
                if (b[p] > max_sym[k]) throw Error{};
                tables[k].log = 0;
                tables[k].t.assign(1, FseEntry{b[p], 0, 0});
                has_table[k] = true;
                ++p;
            } else if (mode == 2) {
                int log;
                std::vector<int> counts;
                const int64_t used = read_ncount(b + p, n - p, max_sym[k], log,
                                                 counts);
                if (log > max_log[k]) throw Error{};
                tables[k] = fse_table(log, counts);
                has_table[k] = true;
                p += used;
            } else if (!has_table[k]) {
                throw Error{};
            }
        }
        const Fse &ll_t = tables[0], &of_t = tables[1], &ml_t = tables[2];
        Back bs(b + p, n - p);
        uint32_t sl = bs.read(ll_t.log), so = bs.read(of_t.log),
                 sm = bs.read(ml_t.log);
        int64_t lp = 0;
        const int64_t nl = int64_t(lits.size());
        for (int64_t i = 0; i < nseq; ++i) {
            const int of_code = of_t.t[so].symbol, ml_code = ml_t.t[sm].symbol,
                      ll_code = ll_t.t[sl].symbol;
            if (of_code > 31) throw Error{};
            const bool ll0 = ll_code == 0;
            int64_t off;
            if (of_code > 1) {
                off = (int64_t(1) << of_code) + int64_t(bs.read(of_code)) - 3;
                reps[2] = reps[1];
                reps[1] = reps[0];
                reps[0] = off;
            } else if (of_code == 0) {
                off = ll0 ? reps[1] : reps[0];
                if (ll0) reps[1] = reps[0];
                reps[0] = off;
            } else {
                const int idx = 1 + int(ll0) + int(bs.read(1));
                off = idx == 3 ? reps[0] - 1 : reps[idx];
                if (off == 0) off = -1;
                if (idx != 1) reps[2] = reps[1];
                reps[1] = reps[0];
                reps[0] = off;
            }
            const int64_t ml = kMLBase[ml_code][0] + bs.read(int(kMLBase[ml_code][1]));
            const int64_t ll = kLLBase[ll_code][0] + bs.read(int(kLLBase[ll_code][1]));
            if (i < nseq - 1) {
                FseEntry e = ll_t.t[sl];
                sl = e.base + bs.read(e.nb);
                e = ml_t.t[sm];
                sm = e.base + bs.read(e.nb);
                e = of_t.t[so];
                so = e.base + bs.read(e.nb);
            }
            if (lp + ll > nl) throw Error{};
            if (int64_t(out.size()) + ll + ml > limit) throw Error{};
            out.insert(out.end(), lits.begin() + lp, lits.begin() + lp + ll);
            lp += ll;
            if (off <= 0 || off > int64_t(out.size())) throw Error{};
            const int64_t start = int64_t(out.size()) - off;
            out.resize(out.size() + size_t(ml));
            uint8_t* o = out.data();
            const int64_t end = int64_t(out.size());
            for (int64_t k = end - ml; k < end; ++k) o[k] = o[start + (k - (end - ml))];
        }
        if (bs.pos != 0) throw Error{};
        if (int64_t(out.size()) + nl - lp > limit) throw Error{};
        out.insert(out.end(), lits.begin() + lp, lits.end());
    }
};

struct Header {
    int64_t size = 0, window = 0, fcs = -1;  // fcs -1: no content size
    bool checksum = false;
};

Header frame_header(const uint8_t* src, int64_t n) {
    if (n < 4) throw Error{};
    const uint32_t magic = uint32_t(le(src, 4));
    if ((magic & 0xFFFFFFF0u) == kSkipMagic || magic != kMagic) throw Error{};
    if (n < 5) throw Error{};
    const int fhd = src[4];
    const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1,
              did_flag = fhd & 3;
    if (fhd & 8) throw Error{};
    static const int did_sizes[4] = {0, 1, 2, 4};
    const int did_size = did_sizes[did_flag];
    const int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (fcs_flag == 1 ? 2 : (fcs_flag == 2 ? 4 : 8));
    Header h;
    h.size = 5 + (single ? 0 : 1) + did_size + fcs_size;
    h.checksum = (fhd >> 2) & 1;
    if (n < h.size) throw Error{};
    int64_t p = 5;
    if (!single) {
        const int wd = src[p++];
        const int wlog = 10 + (wd >> 3);
        if (wlog > 31) throw Error{};
        const int64_t base = int64_t(1) << wlog;
        h.window = base + (base >> 3) * (wd & 7);
    }
    const uint64_t did = le(src + p, did_size);
    p += did_size;
    if (fcs_size) {
        const uint64_t fcs = le(src + p, fcs_size);
        // A size of 2^63 or more exceeds any TIFF strip and the window limit.
        if (fcs >> 63) throw Error{};
        h.fcs = int64_t(fcs);
        if (fcs_size == 2) h.fcs += 256;
    }
    if (did) throw Error{};
    if (single) h.window = h.fcs;
    return h;
}

int64_t frame_size(const uint8_t* src, int64_t n, const Header& h) {
    int64_t p = h.size;
    for (;;) {
        if (p + 3 > n) return n + 1;
        const uint32_t bh = uint32_t(le(src + p, 3));
        const int btype = (bh >> 1) & 3;
        if (btype == 3) return n + 1;
        p += 3 + (btype == 1 ? 1 : int64_t(bh >> 3));
        if (bh & 1) return p + 4 * int64_t(h.checksum);
    }
}

}  // namespace

extern "C" int64_t lrt_zstd_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                                   int64_t occ) {
    std::vector<uint8_t> out;
    auto done = [&]() -> int64_t {
        const int64_t k = int64_t(out.size()) < occ ? int64_t(out.size()) : occ;
        if (k > 0) memcpy(dst, out.data(), size_t(k));
        return k;
    };
    try {
        const Header h = frame_header(src, n);
        const bool one_pass = h.fcs >= 0 && h.fcs <= occ &&
                              frame_size(src, n, h) <= n;
        if (!one_pass && h.window > (int64_t(1) << 27)) return -1;
        const int64_t block_max = h.window < kBlockMax ? h.window : kBlockMax;
        Frame fr;
        int64_t p = h.size;
        bool filled = false;
        for (;;) {
            if (!one_pass && int64_t(out.size()) >= occ) {
                if (int64_t(out.size()) > occ || filled) return done();
                filled = true;
            }
            if (p + 3 > n) {
                if (one_pass) return -1;
                return done();
            }
            const uint32_t bh = uint32_t(le(src + p, 3));
            const bool last = bh & 1;
            const int btype = (bh >> 1) & 3;
            const int64_t bsize = bh >> 3;
            p += 3;
            if (btype == 3) return -1;
            const int64_t csize = btype == 1 ? 1 : bsize;
            if (p + csize > n) {
                if (one_pass) return -1;
                return done();
            }
            const uint8_t* body = src + p;
            p += csize;
            if (btype == 0) {
                out.insert(out.end(), body, body + bsize);
            } else if (btype == 1) {
                out.insert(out.end(), size_t(bsize), body[0]);
            } else {
                if (bsize > block_max || bsize == 0) return -1;
                const int64_t used = fr.literals(body, csize);
                int64_t limit = int64_t(out.size()) + block_max;
                if (one_pass && occ < limit) limit = occ;
                fr.sequences(body + used, csize - used, out, limit);
            }
            if (one_pass && int64_t(out.size()) > occ) return -1;
            if (last) break;
        }
        if (h.fcs >= 0 && int64_t(out.size()) != h.fcs) return -1;
        if (h.checksum && (one_pass || int64_t(out.size()) <= occ)) {
            if (p + 4 > n) {
                if (one_pass) return -1;
                return done();
            }
            if (uint32_t(le(src + p, 4)) !=
                uint32_t(xxh64(out.data(), int64_t(out.size()))))
                return -1;
        }
    } catch (...) {  // Error, and std::bad_alloc: none may cross extern "C"
        return -1;
    }
    return done();
}
