// The serial loops of liverrenderer_tpu_torch's WebP decoder (io/vp8l.py,
// io/vp8.py), as libwebp 1.6's decoder (src/dec/, src/dsp/) runs them.
// vp8l.py and vp8.py keep each loop's plain Python version with the same
// contract (`_entropy_plain`, `_predictor_plain`, `_frame_plain`); the
// tests hold the two equal.  Compiled with the host C++ compiler at first
// use (host_build.py) and called through ctypes.  The tables (VP8's
// default and update coefficient probabilities, its 4x4 mode
// probabilities, the dequantisation tables, VP8L's distance map) come
// from the Python modules, so one copy serves both versions.
//
// lrt_vp8l_entropy(data, n, bitpos, xsize, ysize, cache_bits, groups,
//   meta_bits, ngroups, plane, out) -> the bit position after the image,
//   or a negative error.  One VP8L entropy-coded image (RFC 9649 section
//   5): the ngroups prefix-code groups (five codes each: green + lengths
//   + cache, red, blue, alpha, distance; simple codes or code lengths
//   with the repeat symbols 16/17/18), then the pixels: literals,
//   backward references (length and distance prefix codes with their
//   extra bits, the 120-entry distance map) and colour-cache hits.  The
//   group of a pixel is groups[(y >> meta_bits) * gw + (x >> meta_bits)]
//   (groups null: group 0).  Bits are read LSB first; reading past the
//   end of the data (or past 64 bits of data shorter than 8 bytes, as
//   libwebp's 64-bit window reads it) is an error.
// lrt_vp8l_predictor(argb, w, h, modes, bits): the predictor transform's
//   inverse in place (modes: the transform image, mode in bits 8-11).
// lrt_vp8_frame(data, n, tables, y, u, v, info) -> 0, or a negative error:
//   one VP8 key frame (RFC 6386) -> the Y, U, V planes of its macroblocks
//   (16 * mb_w x 16 * mb_h, 8 * mb_w x 8 * mb_h), loop-filtered.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ------------------------------------------------------------ VP8L ------
struct LBits {
    const uint8_t* data;
    int64_t n;
    int64_t pos;    // bits consumed
    int64_t avail;  // bits that can be consumed before end-of-stream
    uint32_t peek(int k) const {
        uint32_t v = 0;
        for (int i = 0; i < k; ++i) {
            const int64_t p = pos + i;
            const int64_t by = p >> 3;
            if (by < n) v |= uint32_t((data[by] >> (p & 7)) & 1) << i;
        }
        return v;
    }
    uint32_t read(int k) {
        const uint32_t v = peek(k);
        pos += k;
        return v;
    }
    bool eos() const { return pos > avail; }
};

constexpr int kMaxLen = 15;
constexpr int kRootBits = 10;

// A canonical prefix code: puff's counts and sorted symbols, a root
// table over the first kRootBits bits (bit 0 = first bit read)
struct Code {
    int single = -1;            // the symbol of a one-symbol code (0 bits)
    int count[kMaxLen + 1] = {};
    std::vector<int> symbol;
    std::vector<int32_t> root;  // (symbol << 4) | len, or -1: longer code
};

// Builds `code` from the lengths; false when libwebp's table code refuses
// them (a length over 15, no symbol, an incomplete or oversubscribed set).
bool build(Code& code, const int* lengths, int n) {
    int total = 0;
    for (int s = 0; s < n; ++s) {
        if (lengths[s] > kMaxLen) return false;
        if (lengths[s]) ++total;
    }
    if (total == 0) return false;
    std::memset(code.count, 0, sizeof(code.count));
    for (int s = 0; s < n; ++s) ++code.count[lengths[s]];
    int offs[kMaxLen + 2];
    offs[1] = 0;
    for (int len = 1; len <= kMaxLen; ++len) {
        if (code.count[len] > (1 << len)) return false;
        offs[len + 1] = offs[len] + code.count[len];
    }
    code.symbol.assign(total, 0);
    for (int s = 0; s < n; ++s)
        if (lengths[s]) code.symbol[offs[lengths[s]]++] = s;
    if (total == 1) {
        code.single = code.symbol[0];
        return true;
    }
    code.single = -1;
    int left = 1;
    for (int len = 1; len <= kMaxLen; ++len) {
        left <<= 1;
        left -= code.count[len];
        if (left < 0) return false;
    }
    if (left != 0) return false;
    code.root.assign(1 << kRootBits, -1);
    int c = 0, idx = 0;
    for (int len = 1; len <= kMaxLen; ++len) {
        for (int k = 0; k < code.count[len]; ++k, ++c, ++idx) {
            if (len <= kRootBits) {
                int rev = 0;
                for (int b = 0; b < len; ++b) rev |= ((c >> b) & 1) << (len - 1 - b);
                for (int e = rev; e < (1 << kRootBits); e += 1 << len)
                    code.root[e] = (code.symbol[idx] << 4) | len;
            }
        }
        c <<= 1;
    }
    return true;
}

int read_symbol(const Code& code, LBits& br) {
    if (code.single >= 0) return code.single;
    const int32_t e = code.root[br.peek(kRootBits)];
    if (e >= 0) {
        br.pos += e & 15;
        return e >> 4;
    }
    int c = 0, first = 0, index = 0;
    for (int len = 1; len <= kMaxLen; ++len) {
        c |= int(br.read(1));
        const int count = code.count[len];
        if (c - count < first) return code.symbol[index + (c - first)];
        index += count;
        first += count;
        first <<= 1;
        c <<= 1;
    }
    return 0;  // not reached for a complete code
}

constexpr int kCodeOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                7,  8,  9, 10, 11, 12, 13, 14, 15};

bool read_code(Code& code, LBits& br, int alphabet) {
    std::vector<int> lengths(alphabet > 256 ? alphabet : 256, 0);
    if (br.read(1)) {  // simple code
        const int nsym = br.read(1) + 1;
        const int first8 = br.read(1);
        lengths[br.read(first8 ? 8 : 1)] = 1;
        if (nsym == 2) lengths[br.read(8)] = 1;
    } else {
        int cl[19] = {};
        const int ncodes = br.read(4) + 4;
        for (int i = 0; i < ncodes; ++i) cl[kCodeOrder[i]] = br.read(3);
        Code lc;
        if (!build(lc, cl, 19)) return false;
        int max_symbol = alphabet;
        if (br.read(1)) {
            const int nbits = 2 + 2 * br.read(3);
            max_symbol = 2 + br.read(nbits);
            if (max_symbol > alphabet) return false;
        }
        int prev = 8, s = 0;
        while (s < alphabet) {
            if (max_symbol-- == 0) break;
            const int len = read_symbol(lc, br);
            if (len < 16) {
                lengths[s++] = len;
                if (len) prev = len;
            } else {
                static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
                int repeat = br.read(extra[len - 16]) + offset[len - 16];
                if (s + repeat > alphabet) return false;
                const int v = len == 16 ? prev : 0;
                while (repeat-- > 0) lengths[s++] = v;
            }
        }
    }
    if (br.eos()) return false;
    return build(code, lengths.data(), alphabet);
}

int copy_value(int sym, LBits& br) {
    if (sym < 4) return sym + 1;
    const int extra = (sym - 2) >> 1;
    const int offset = (2 + (sym & 1)) << extra;
    return offset + br.read(extra) + 1;
}

uint32_t clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

uint32_t average2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

uint32_t add_pixels(uint32_t a, uint32_t b) {
    const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
    const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

int ch(uint32_t p, int s) { return int((p >> s) & 0xff); }

uint32_t select(uint32_t t, uint32_t l, uint32_t tl) {
    int d = 0;
    for (int s = 0; s < 32; s += 8) {
        d += std::abs(ch(l, s) - ch(tl, s)) - std::abs(ch(t, s) - ch(tl, s));
    }
    return d <= 0 ? t : l;
}

uint32_t add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8)
        out |= clip255(ch(a, s) + ch(b, s) - ch(c, s)) << s;
    return out;
}

uint32_t add_sub_half(uint32_t a, uint32_t b) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
        const int x = ch(a, s), y = ch(b, s);
        out |= clip255(x + (x - y) / 2) << s;
    }
    return out;
}

uint32_t predict(int mode, uint32_t l, uint32_t t, uint32_t tr, uint32_t tl) {
    switch (mode) {
        case 1: return l;
        case 2: return t;
        case 3: return tr;
        case 4: return tl;
        case 5: return average2(average2(l, tr), t);
        case 6: return average2(l, tl);
        case 7: return average2(l, t);
        case 8: return average2(tl, t);
        case 9: return average2(t, tr);
        case 10: return average2(average2(l, tl), average2(t, tr));
        case 11: return select(t, l, tl);
        case 12: return add_sub_full(l, t, tl);
        case 13: return add_sub_half(average2(l, t), tl);
        default: return 0xff000000u;  // 0, and libwebp's 14 and 15
    }
}

}  // namespace

extern "C" int64_t lrt_vp8l_entropy(const uint8_t* data, int64_t n,
                                    int64_t bitpos, int32_t xsize,
                                    int32_t ysize, int32_t cache_bits,
                                    const int32_t* groups, int32_t meta_bits,
                                    int32_t ngroups, const uint8_t* plane,
                                    uint32_t* out) {
    LBits br{data, n, bitpos, n >= 8 ? 8 * n : 64};
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    static const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};
    std::vector<Code> codes(size_t(ngroups) * 5);
    for (int g = 0; g < ngroups; ++g)
        for (int j = 0; j < 5; ++j)
            if (!read_code(codes[size_t(g) * 5 + j], br,
                           kAlphabet[j] + (j == 0 ? cache_size : 0)))
                return -1;
    std::vector<uint32_t> cache(cache_size ? cache_size : 1, 0);
    const int gw = groups ? (xsize + (1 << meta_bits) - 1) >> meta_bits : 0;
    const int64_t total = int64_t(xsize) * ysize;
    int64_t i = 0, cached = 0;
    auto insert_to = [&](int64_t end) {
        for (; cached < end; ++cached)
            cache[(0x1e35a7bdu * out[cached]) >> (32 - cache_bits)] = out[cached];
    };
    while (i < total) {
        const int x = int(i % xsize), y = int(i / xsize);
        const Code* c = codes.data() +
            (groups ? size_t(groups[(y >> meta_bits) * gw + (x >> meta_bits)]) * 5 : 0);
        const int code = read_symbol(c[0], br);
        if (br.eos()) return -2;
        if (code < 256) {
            const uint32_t red = read_symbol(c[1], br);
            const uint32_t blue = read_symbol(c[2], br);
            const uint32_t alpha = read_symbol(c[3], br);
            if (br.eos()) return -2;
            out[i++] = (alpha << 24) | (red << 16) | (uint32_t(code) << 8) | blue;
        } else if (code < 256 + 24) {
            const int length = copy_value(code - 256, br);
            const int dsym = read_symbol(c[4], br);
            const int dcode = copy_value(dsym, br);
            int64_t dist;
            if (dcode > 120) {
                dist = dcode - 120;
            } else {
                const int d = plane[dcode - 1];
                dist = int64_t(d >> 4) * xsize + (8 - (d & 15));
                if (dist < 1) dist = 1;
            }
            if (br.eos()) return -2;
            if (i < dist || total - i < length) return -3;
            for (int k = 0; k < length; ++k, ++i) out[i] = out[i - dist];
        } else {
            if (code - 280 >= cache_size) return -3;
            insert_to(i);
            out[i++] = cache[code - 280];
        }
        if (cache_size) insert_to(i);
    }
    if (br.eos()) return -2;
    return br.pos;
}

extern "C" void lrt_vp8l_predictor(uint32_t* argb, int32_t w, int32_t h,
                                   const uint32_t* modes, int32_t bits) {
    const int tw = (w + (1 << bits) - 1) >> bits;
    for (int x = 0; x < w; ++x)
        argb[x] = add_pixels(argb[x], x ? argb[x - 1] : 0xff000000u);
    for (int y = 1; y < h; ++y) {
        uint32_t* row = argb + int64_t(y) * w;
        const uint32_t* up = row - w;
        row[0] = add_pixels(row[0], up[0]);
        for (int x = 1; x < w; ++x) {
            const int mode = (modes[(y >> bits) * tw + (x >> bits)] >> 8) & 15;
            // the top-right of the last column is the row's first pixel
            const uint32_t p = predict(mode, row[x - 1], up[x], up[x + 1], up[x - 1]);
            row[x] = add_pixels(row[x], p);
        }
    }
}

// ------------------------------------------------------------- VP8 ------
namespace {

// offsets into the tables the caller passes (int32 each): the default
// coefficient probabilities [4][8][3][11], their update probabilities,
// the 4x4 mode probabilities [10][10][9], the DC and AC dequantisation
// tables [128]
constexpr int kP0 = 0, kUpd = 1056, kBm = 2112, kDc = 3012, kAc = 3140;
constexpr int BPS = 32;
constexpr int kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
// the 4x4 mode tree (libwebp's kYModesIntra4; modes DC TM VE HE RD VR LD
// VL HD HU = 0..9)
constexpr int8_t kYModesIntra4[18] = {0, 1, -1, 2, -2, 3, 4, 6, -3, 5,
                                      -4, -5, -6, 7, -7, 8, -8, -9};

// libwebp's boolean decoder (range kept as range - 1), bytes loaded one at
// a time; past the end it shifts in one zero byte and flags eof
struct BoolDec {
    const uint8_t* buf;
    const uint8_t* end;
    uint64_t value = 0;
    int range = 254;
    int bits = -8;
    bool eof = false;
    BoolDec(const uint8_t* b, int64_t n) : buf(b), end(b + n) { load(); }
    void load() {
        if (buf < end) {
            bits += 8;
            value = *buf++ | (value << 8);
        } else if (!eof) {
            value <<= 8;
            bits += 8;
            eof = true;
        } else {
            bits = 0;
        }
    }
    int bit(int prob) {
        if (bits < 0) load();
        int r = range;
        const int pos = bits;
        const uint32_t split = uint32_t(r * prob) >> 8;
        const uint32_t v = uint32_t(value >> pos);
        const int b = v > split;
        if (b) {
            r -= split;
            value -= uint64_t(split + 1) << pos;
        } else {
            r = split + 1;
        }
        int shift = 0;
        while ((r << shift) < 128) ++shift;
        r <<= shift;
        bits -= shift;
        range = r - 1;
        return b;
    }
    int get(int n) {
        int v = 0;
        while (n-- > 0) v |= bit(0x80) << n;
        return v;
    }
    int sget(int n) {
        const int v = get(n);
        return bit(0x80) ? -v : v;
    }
};

uint8_t clip8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

struct Quant {
    int y1[2], y2[2], uv[2];
};

struct MB {
    int16_t coeffs[384];
    uint8_t imodes[16];
    int is_i4x4, uvmode, segment, skip;
};

int large_value(BoolDec& br, const uint8_t* p) {
    int v;
    if (!br.bit(p[3])) {
        v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
    } else if (!br.bit(p[6])) {
        if (!br.bit(p[7])) {
            v = 5 + br.bit(159);
        } else {
            v = 7 + 2 * br.bit(165);
            v += br.bit(145);
        }
    } else {
        const int bit1 = br.bit(p[8]);
        const int bit0 = br.bit(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
        v += 3 + (8 << cat);
    }
    return v;
}

// GetCoeffs: one block's tokens from coefficient n -> out (zigzag order
// undone, dequantised); returns the index after the last non-zero one
int get_coeffs(BoolDec& br, const uint8_t (*probs)[3][11], int ctx,
               const int* dq, int n, int16_t* out) {
    const uint8_t* p = probs[kBands[n]][ctx];
    for (; n < 16; ++n) {
        if (!br.bit(p[0])) return n;
        while (!br.bit(p[1])) {
            p = probs[kBands[++n]][0];
            if (n == 16) return 16;
        }
        const uint8_t (*pc)[11] = probs[kBands[n + 1]];
        int v;
        if (!br.bit(p[2])) {
            v = 1;
            p = pc[1];
        } else {
            v = large_value(br, p);
            p = pc[2];
        }
        const int s = br.bit(0x80) ? -v : v;
        out[kZigzag[n]] = int16_t(s * dq[n > 0]);
    }
    return 16;
}

void transform_wht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        const int a0 = in[0 + i] + in[12 + i];
        const int a1 = in[4 + i] + in[8 + i];
        const int a2 = in[4 + i] - in[8 + i];
        const int a3 = in[0 + i] - in[12 + i];
        tmp[0 + i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
        const int dc = tmp[0 + i * 4] + 3;
        const int a0 = dc + tmp[3 + i * 4];
        const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
        const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
        const int a3 = dc - tmp[3 + i * 4];
        out[0] = int16_t((a0 + a1) >> 3);
        out[16] = int16_t((a3 + a2) >> 3);
        out[32] = int16_t((a0 - a1) >> 3);
        out[48] = int16_t((a3 - a2) >> 3);
        out += 64;
    }
}

int mul1(int a) { return ((a * 20091) >> 16) + a; }
int mul2(int a) { return (a * 35468) >> 16; }

// TransformOne: the inverse DCT of one block added to dst (exact for the
// DC-only and three-coefficient blocks libwebp takes shortcuts on)
void transform(const int16_t* in, uint8_t* dst) {
    int C[16], *tmp = C;
    for (int i = 0; i < 4; ++i, ++in, tmp += 4) {
        const int a = in[0] + in[8];
        const int b = in[0] - in[8];
        const int c = mul2(in[4]) - mul1(in[12]);
        const int d = mul1(in[4]) + mul2(in[12]);
        tmp[0] = a + d;
        tmp[1] = b + c;
        tmp[2] = b - c;
        tmp[3] = a - d;
    }
    tmp = C;
    for (int i = 0; i < 4; ++i, ++tmp, dst += BPS) {
        const int dc = tmp[0] + 4;
        const int a = dc + tmp[8];
        const int b = dc - tmp[8];
        const int c = mul2(tmp[4]) - mul1(tmp[12]);
        const int d = mul1(tmp[4]) + mul2(tmp[12]);
        dst[0] = clip8(dst[0] + ((a + d) >> 3));
        dst[1] = clip8(dst[1] + ((b + c) >> 3));
        dst[2] = clip8(dst[2] + ((b - c) >> 3));
        dst[3] = clip8(dst[3] + ((a - d) >> 3));
    }
}

#define DST(x, y) dst[(x) + (y) * BPS]
#define AVG3(a, b, c) uint8_t(((a) + 2 * (b) + (c) + 2) >> 2)
#define AVG2(a, b) uint8_t(((a) + (b) + 1) >> 1)

void true_motion(uint8_t* dst, int size) {
    const uint8_t* top = dst - BPS;
    for (int y = 0; y < size; ++y, dst += BPS)
        for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - top[-1]);
}

void fill(uint8_t* dst, int size, int v) {
    for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

// VP8PredLuma16 / VP8PredChroma8: modes DC TM VE HE, then DC without top,
// without left, without both
void pred_block(uint8_t* dst, int mode, int size) {
    const int sh = size == 16 ? 5 : 4;
    int dc = 0;
    switch (mode) {
        case 0:
            for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
            fill(dst, size, (dc + size) >> sh);
            break;
        case 1: true_motion(dst, size); break;
        case 2:
            for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size);
            break;
        case 3:
            for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], size);
            break;
        case 4:
            for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
            fill(dst, size, (dc + size / 2) >> (sh - 1));
            break;
        case 5:
            for (int j = 0; j < size; ++j) dc += dst[j - BPS];
            fill(dst, size, (dc + size / 2) >> (sh - 1));
            break;
        default: fill(dst, size, 0x80);
    }
}

void pred4(uint8_t* dst, int mode) {
    const uint8_t* top = dst - BPS;
    const int X = dst[-1 - BPS];
    const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
    const int A = top[0], B = top[1], C = top[2], D = top[3];
    const int E = top[4], F = top[5], G = top[6], H = top[7];
    switch (mode) {
        case 0: {  // DC
            int dc = 4;
            for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
            fill(dst, 4, dc >> 3);
            break;
        }
        case 1: true_motion(dst, 4); break;
        case 2: {  // VE
            const uint8_t vals[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D), AVG3(C, D, E)};
            for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
            break;
        }
        case 3:  // HE
            std::memset(dst, AVG3(X, I, J), 4);
            std::memset(dst + BPS, AVG3(I, J, K), 4);
            std::memset(dst + 2 * BPS, AVG3(J, K, L), 4);
            std::memset(dst + 3 * BPS, AVG3(K, L, L), 4);
            break;
        case 4:  // RD
            DST(0, 3) = AVG3(J, K, L);
            DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
            DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
            DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
            DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
            DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
            DST(3, 0) = AVG3(D, C, B);
            break;
        case 5:  // VR
            DST(0, 0) = DST(1, 2) = AVG2(X, A);
            DST(1, 0) = DST(2, 2) = AVG2(A, B);
            DST(2, 0) = DST(3, 2) = AVG2(B, C);
            DST(3, 0) = AVG2(C, D);
            DST(0, 3) = AVG3(K, J, I);
            DST(0, 2) = AVG3(J, I, X);
            DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
            DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
            DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
            DST(3, 1) = AVG3(B, C, D);
            break;
        case 6:  // LD
            DST(0, 0) = AVG3(A, B, C);
            DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
            DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
            DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
            DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
            DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
            DST(3, 3) = AVG3(G, H, H);
            break;
        case 7:  // VL
            DST(0, 0) = AVG2(A, B);
            DST(1, 0) = DST(0, 2) = AVG2(B, C);
            DST(2, 0) = DST(1, 2) = AVG2(C, D);
            DST(3, 0) = DST(2, 2) = AVG2(D, E);
            DST(0, 1) = AVG3(A, B, C);
            DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
            DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
            DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
            DST(3, 2) = AVG3(E, F, G);
            DST(3, 3) = AVG3(F, G, H);
            break;
        case 8:  // HD
            DST(0, 0) = DST(2, 1) = AVG2(I, X);
            DST(0, 1) = DST(2, 2) = AVG2(J, I);
            DST(0, 2) = DST(2, 3) = AVG2(K, J);
            DST(0, 3) = AVG2(L, K);
            DST(3, 0) = AVG3(A, B, C);
            DST(2, 0) = AVG3(X, A, B);
            DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
            DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
            DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
            DST(1, 3) = AVG3(L, K, J);
            break;
        default:  // HU
            DST(0, 0) = AVG2(I, J);
            DST(2, 0) = DST(0, 1) = AVG2(J, K);
            DST(2, 1) = DST(0, 2) = AVG2(K, L);
            DST(1, 0) = AVG3(I, J, K);
            DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
            DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
            DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
    }
}

#undef DST
#undef AVG3
#undef AVG2

// ------------------------------------------------------ loop filter ----
int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

void do_filter2(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
}

void do_filter4(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    const int a3 = (a1 + 1) >> 1;
    p[-2 * step] = clip8(p1 + a3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a3);
}

void do_filter6(uint8_t* p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7;
    const int a2 = (18 * a + 63) >> 7;
    const int a3 = (9 * a + 63) >> 7;
    p[-3 * step] = clip8(p2 + a3);
    p[-2 * step] = clip8(p1 + a2);
    p[-step] = clip8(p0 + a1);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a2);
    p[2 * step] = clip8(q2 - a3);
}

bool hev(const uint8_t* p, int step, int thresh) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

bool needs_filter(const uint8_t* p, int step, int t) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

bool needs_filter2(const uint8_t* p, int step, int t, int it) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
    const int p0 = p[-step], q0 = p[0];
    const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
    return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
           std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
           std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void simple_edge(uint8_t* p, int step, int along, int thresh) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < 16; ++i)
        if (needs_filter(p + i * along, step, t2)) do_filter2(p + i * along, step);
}

// FilterLoop26 (macroblock edges, six) and FilterLoop24 (inner, four)
void edge(uint8_t* p, int step, int along, int size, int thresh, int ithresh,
          int hev_t, bool inner) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < size; ++i, p += along) {
        if (!needs_filter2(p, step, t2, ithresh)) continue;
        if (hev(p, step, hev_t)) {
            do_filter2(p, step);
        } else if (inner) {
            do_filter4(p, step);
        } else {
            do_filter6(p, step);
        }
    }
}

struct FInfo {
    int limit, ilevel, inner, hev_thresh;
};

}  // namespace

extern "C" int32_t lrt_vp8_frame(const uint8_t* data, int64_t n,
                                 const int32_t* tables, uint8_t* ybuf,
                                 uint8_t* ubuf, uint8_t* vbuf, int32_t* info) {
    if (n < 10) return -1;
    const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
    const int part0 = bits >> 5;
    if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1)) return -2;
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return -3;
    const int width = ((data[7] << 8) | data[6]) & 0x3fff;
    const int height = ((data[9] << 8) | data[8]) & 0x3fff;
    const int mb_w = (width + 15) >> 4, mb_h = (height + 15) >> 4;
    info[0] = width;
    info[1] = height;
    const uint8_t* buf = data + 10;
    int64_t size = n - 10;
    if (part0 > size) return -4;
    BoolDec br(buf, part0);
    buf += part0;
    size -= part0;
    br.get(1);  // colour space
    br.get(1);  // clamping type
    // segment header
    int use_segment = br.get(1), update_map = 0, absolute_delta = 1;
    int quantizer[4] = {}, filter_strength[4] = {};
    int seg_probs[3] = {255, 255, 255};
    if (use_segment) {
        update_map = br.get(1);
        if (br.get(1)) {
            absolute_delta = br.get(1);
            for (int s = 0; s < 4; ++s) quantizer[s] = br.get(1) ? br.sget(7) : 0;
            for (int s = 0; s < 4; ++s) filter_strength[s] = br.get(1) ? br.sget(6) : 0;
        }
        if (update_map)
            for (int s = 0; s < 3; ++s) seg_probs[s] = br.get(1) ? br.get(8) : 255;
    }
    if (br.eof) return -5;
    // filter header
    const int simple = br.get(1);
    const int level = br.get(6);
    const int sharpness = br.get(3);
    const int use_lf_delta = br.get(1);
    int ref_lf_delta[4] = {}, mode_lf_delta[4] = {};
    if (use_lf_delta && br.get(1)) {
        for (int i = 0; i < 4; ++i)
            if (br.get(1)) ref_lf_delta[i] = br.sget(6);
        for (int i = 0; i < 4; ++i)
            if (br.get(1)) mode_lf_delta[i] = br.sget(6);
    }
    const int filter_type = level == 0 ? 0 : simple ? 1 : 2;
    if (br.eof) return -6;
    // partitions
    const int nparts = 1 << br.get(2);
    if (size < 3 * (nparts - 1)) return -7;
    std::vector<BoolDec> parts;
    {
        const uint8_t* sz = buf;
        const uint8_t* start = buf + 3 * (nparts - 1);
        int64_t left = size - 3 * (nparts - 1);
        for (int p = 0; p < nparts - 1; ++p, sz += 3) {
            int64_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
            if (psize > left) psize = left;
            parts.emplace_back(start, psize);
            start += psize;
            left -= psize;
        }
        parts.emplace_back(start, left);
        if (!(start < buf + size)) return -8;
    }
    // quantisers
    Quant dqm[4];
    {
        const int base_q0 = br.get(7);
        const int dqy1_dc = br.get(1) ? br.sget(4) : 0;
        const int dqy2_dc = br.get(1) ? br.sget(4) : 0;
        const int dqy2_ac = br.get(1) ? br.sget(4) : 0;
        const int dquv_dc = br.get(1) ? br.sget(4) : 0;
        const int dquv_ac = br.get(1) ? br.sget(4) : 0;
        auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
        for (int i = 0; i < 4; ++i) {
            int q;
            if (use_segment) {
                q = quantizer[i] + (absolute_delta ? 0 : base_q0);
            } else if (i > 0) {
                dqm[i] = dqm[0];
                continue;
            } else {
                q = base_q0;
            }
            Quant& m = dqm[i];
            m.y1[0] = tables[kDc + clip(q + dqy1_dc, 127)];
            m.y1[1] = tables[kAc + clip(q, 127)];
            m.y2[0] = tables[kDc + clip(q + dqy2_dc, 127)] * 2;
            m.y2[1] = (tables[kAc + clip(q + dqy2_ac, 127)] * 101581) >> 16;
            if (m.y2[1] < 8) m.y2[1] = 8;
            m.uv[0] = tables[kDc + clip(q + dquv_dc, 117)];
            m.uv[1] = tables[kAc + clip(q + dquv_ac, 127)];
        }
    }
    br.get(1);  // update_proba, ignored
    uint8_t probs[4][8][3][11];
    for (int i = 0; i < 1056; ++i) {
        const int v = br.bit(tables[kUpd + i]) ? br.get(8) : tables[kP0 + i];
        (&probs[0][0][0][0])[i] = uint8_t(v);
    }
    const int use_skip = br.get(1);
    const int skip_p = use_skip ? br.get(8) : 0;
    // filter strengths per segment and (16x16, 4x4)
    FInfo fstr[4][2];
    for (int s = 0; s < 4; ++s) {
        int base = level;
        if (use_segment) base = filter_strength[s] + (absolute_delta ? 0 : level);
        for (int i4 = 0; i4 <= 1; ++i4) {
            int lv = base;
            if (use_lf_delta) {
                lv += ref_lf_delta[0];
                if (i4) lv += mode_lf_delta[0];
            }
            lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
            FInfo& f = fstr[s][i4];
            f.limit = 0;
            f.ilevel = 0;
            f.hev_thresh = 0;
            if (lv > 0) {
                int il = lv;
                if (sharpness > 0) {
                    il >>= sharpness > 4 ? 2 : 1;
                    if (il > 9 - sharpness) il = 9 - sharpness;
                }
                if (il < 1) il = 1;
                f.ilevel = il;
                f.limit = 2 * lv + il;
                f.hev_thresh = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
            }
            f.inner = i4;
        }
    }
    // macroblock rows: modes, tokens, reconstruction
    const int ystride = 16 * mb_w, uvstride = 8 * mb_w;
    std::vector<uint8_t> intra_t(4 * mb_w, 0);
    std::vector<uint8_t> top_nz(mb_w, 0), top_nz_dc(mb_w, 0);
    std::vector<uint8_t> top_y(16 * mb_w), top_u(8 * mb_w), top_v(8 * mb_w);
    std::vector<FInfo> finfo(size_t(mb_w) * mb_h);
    std::vector<MB> row(mb_w);
    uint8_t work[BPS * 17 + BPS * 9];
    uint8_t* const ydst = work + BPS + 8;
    uint8_t* const udst = ydst + BPS * 16 + BPS;
    uint8_t* const vdst = udst + 16;
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
        uint8_t intra_l[4] = {0, 0, 0, 0};
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
            MB& b = row[mb_x];
            uint8_t* top = intra_t.data() + 4 * mb_x;
            b.segment = update_map ? (!br.bit(seg_probs[0]) ? br.bit(seg_probs[1])
                                                            : br.bit(seg_probs[2]) + 2)
                                   : 0;
            b.skip = use_skip ? br.bit(skip_p) : 0;
            b.is_i4x4 = !br.bit(145);
            if (!b.is_i4x4) {
                const int ymode = br.bit(156) ? (br.bit(128) ? 1 : 3) : (br.bit(163) ? 2 : 0);
                b.imodes[0] = uint8_t(ymode);
                std::memset(top, ymode, 4);
                std::memset(intra_l, ymode, 4);
            } else {
                uint8_t* modes = b.imodes;
                for (int y = 0; y < 4; ++y) {
                    int ymode = intra_l[y];
                    for (int x = 0; x < 4; ++x) {
                        const int32_t* prob = tables + kBm + (top[x] * 10 + ymode) * 9;
                        int i = kYModesIntra4[br.bit(prob[0])];
                        while (i > 0) i = kYModesIntra4[2 * i + br.bit(prob[i])];
                        ymode = -i;
                        top[x] = uint8_t(ymode);
                    }
                    std::memcpy(modes, top, 4);
                    modes += 4;
                    intra_l[y] = uint8_t(ymode);
                }
            }
            b.uvmode = !br.bit(142) ? 0 : !br.bit(114) ? 2 : br.bit(183) ? 1 : 3;
        }
        if (br.eof) return -9;
        BoolDec& tb = parts[mb_y & (nparts - 1)];
        uint8_t left_nz = 0, left_nz_dc = 0;
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
            MB& b = row[mb_x];
            std::memset(b.coeffs, 0, sizeof(b.coeffs));
            int skip = b.skip;
            if (!skip) {
                const Quant& q = dqm[b.segment];
                int16_t* dst = b.coeffs;
                uint32_t nz_y = 0, nz_uv = 0;
                int first;
                const uint8_t (*ac)[3][11];
                if (!b.is_i4x4) {
                    int16_t dc[16] = {};
                    const int ctx = top_nz_dc[mb_x] + left_nz_dc;
                    const int nz = get_coeffs(tb, probs[1], ctx, q.y2, 0, dc);
                    top_nz_dc[mb_x] = left_nz_dc = nz > 0;
                    transform_wht(dc, dst);
                    first = 1;
                    ac = probs[0];
                } else {
                    first = 0;
                    ac = probs[3];
                }
                uint32_t tnz = top_nz[mb_x] & 0x0f, lnz = left_nz & 0x0f;
                for (int y = 0; y < 4; ++y) {
                    int l = lnz & 1;
                    for (int x = 0; x < 4; ++x) {
                        const int ctx = l + (tnz & 1);
                        const int nz = get_coeffs(tb, ac, ctx, q.y1, first, dst);
                        l = nz > first;
                        tnz = (tnz >> 1) | (l << 7);
                        nz_y |= nz > 1 || dst[0] != 0;
                        dst += 16;
                    }
                    tnz >>= 4;
                    lnz = (lnz >> 1) | (l << 7);
                }
                uint32_t out_t = tnz, out_l = lnz >> 4;
                for (int ch = 0; ch < 4; ch += 2) {
                    tnz = top_nz[mb_x] >> (4 + ch);
                    lnz = left_nz >> (4 + ch);
                    for (int y = 0; y < 2; ++y) {
                        int l = lnz & 1;
                        for (int x = 0; x < 2; ++x) {
                            const int ctx = l + (tnz & 1);
                            const int nz = get_coeffs(tb, probs[2], ctx, q.uv, 0, dst);
                            l = nz > 0;
                            tnz = (tnz >> 1) | (l << 3);
                            nz_uv |= nz > 1 || dst[0] != 0;
                            dst += 16;
                        }
                        tnz >>= 2;
                        lnz = (lnz >> 1) | (l << 5);
                    }
                    out_t |= (tnz << 4) << ch;
                    out_l |= (lnz & 0xf0) << ch;
                }
                top_nz[mb_x] = uint8_t(out_t);
                left_nz = uint8_t(out_l);
                skip = !(nz_y | nz_uv);
            } else {
                top_nz[mb_x] = left_nz = 0;
                if (!b.is_i4x4) top_nz_dc[mb_x] = left_nz_dc = 0;
            }
            if (filter_type > 0) {
                FInfo f = fstr[b.segment][b.is_i4x4];
                f.inner |= !skip;
                finfo[size_t(mb_y) * mb_w + mb_x] = f;
            }
            if (tb.eof) return -10;
        }
        // reconstruct the row
        for (int j = 0; j < 16; ++j) ydst[j * BPS - 1] = 129;
        for (int j = 0; j < 8; ++j) udst[j * BPS - 1] = vdst[j * BPS - 1] = 129;
        if (mb_y > 0) {
            ydst[-1 - BPS] = udst[-1 - BPS] = vdst[-1 - BPS] = 129;
        } else {
            std::memset(ydst - BPS - 1, 127, 16 + 4 + 1);
            std::memset(udst - BPS - 1, 127, 8 + 1);
            std::memset(vdst - BPS - 1, 127, 8 + 1);
        }
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
            const MB& b = row[mb_x];
            if (mb_x > 0) {
                for (int j = -1; j < 16; ++j) std::memcpy(ydst + j * BPS - 4, ydst + j * BPS + 12, 4);
                for (int j = -1; j < 8; ++j) {
                    std::memcpy(udst + j * BPS - 4, udst + j * BPS + 4, 4);
                    std::memcpy(vdst + j * BPS - 4, vdst + j * BPS + 4, 4);
                }
            }
            if (mb_y > 0) {
                std::memcpy(ydst - BPS, &top_y[16 * mb_x], 16);
                std::memcpy(udst - BPS, &top_u[8 * mb_x], 8);
                std::memcpy(vdst - BPS, &top_v[8 * mb_x], 8);
            }
            if (b.is_i4x4) {
                uint8_t* tr = ydst - BPS + 16;
                if (mb_y > 0) {
                    if (mb_x >= mb_w - 1) {
                        std::memset(tr, top_y[16 * mb_x + 15], 4);
                    } else {
                        std::memcpy(tr, &top_y[16 * (mb_x + 1)], 4);
                    }
                }
                for (int k = 1; k <= 3; ++k) std::memcpy(tr + 4 * k * BPS, tr, 4);
                for (int k = 0; k < 16; ++k) {
                    uint8_t* d = ydst + (k & 3) * 4 + (k >> 2) * 4 * BPS;
                    pred4(d, b.imodes[k]);
                    transform(b.coeffs + 16 * k, d);
                }
            } else {
                int mode = b.imodes[0];
                if (mode == 0) mode = mb_x == 0 ? (mb_y == 0 ? 6 : 5) : (mb_y == 0 ? 4 : 0);
                pred_block(ydst, mode, 16);
                for (int k = 0; k < 16; ++k)
                    transform(b.coeffs + 16 * k, ydst + (k & 3) * 4 + (k >> 2) * 4 * BPS);
            }
            int uvmode = b.uvmode;
            if (uvmode == 0) uvmode = mb_x == 0 ? (mb_y == 0 ? 6 : 5) : (mb_y == 0 ? 4 : 0);
            pred_block(udst, uvmode, 8);
            pred_block(vdst, uvmode, 8);
            for (int k = 0; k < 4; ++k) {
                const int o = (k & 1) * 4 + (k >> 1) * 4 * BPS;
                transform(b.coeffs + 256 + 16 * k, udst + o);
                transform(b.coeffs + 320 + 16 * k, vdst + o);
            }
            if (mb_y < mb_h - 1) {
                std::memcpy(&top_y[16 * mb_x], ydst + 15 * BPS, 16);
                std::memcpy(&top_u[8 * mb_x], udst + 7 * BPS, 8);
                std::memcpy(&top_v[8 * mb_x], vdst + 7 * BPS, 8);
            }
            for (int j = 0; j < 16; ++j)
                std::memcpy(ybuf + int64_t(16 * mb_y + j) * ystride + 16 * mb_x, ydst + j * BPS, 16);
            for (int j = 0; j < 8; ++j) {
                std::memcpy(ubuf + int64_t(8 * mb_y + j) * uvstride + 8 * mb_x, udst + j * BPS, 8);
                std::memcpy(vbuf + int64_t(8 * mb_y + j) * uvstride + 8 * mb_x, vdst + j * BPS, 8);
            }
        }
    }
    // loop filter, macroblocks in raster order
    if (filter_type > 0) {
        for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
            for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
                const FInfo& f = finfo[size_t(mb_y) * mb_w + mb_x];
                const int limit = f.limit;
                if (limit == 0) continue;
                uint8_t* y = ybuf + int64_t(16 * mb_y) * ystride + 16 * mb_x;
                if (filter_type == 1) {
                    if (mb_x > 0) simple_edge(y, 1, ystride, limit + 4);
                    if (f.inner)
                        for (int k = 1; k <= 3; ++k) simple_edge(y + 4 * k, 1, ystride, limit);
                    if (mb_y > 0) simple_edge(y, ystride, 1, limit + 4);
                    if (f.inner)
                        for (int k = 1; k <= 3; ++k) simple_edge(y + 4 * k * ystride, ystride, 1, limit);
                } else {
                    uint8_t* u = ubuf + int64_t(8 * mb_y) * uvstride + 8 * mb_x;
                    uint8_t* v = vbuf + int64_t(8 * mb_y) * uvstride + 8 * mb_x;
                    const int il = f.ilevel, ht = f.hev_thresh;
                    if (mb_x > 0) {
                        edge(y, 1, ystride, 16, limit + 4, il, ht, false);
                        edge(u, 1, uvstride, 8, limit + 4, il, ht, false);
                        edge(v, 1, uvstride, 8, limit + 4, il, ht, false);
                    }
                    if (f.inner) {
                        for (int k = 1; k <= 3; ++k) edge(y + 4 * k, 1, ystride, 16, limit, il, ht, true);
                        edge(u + 4, 1, uvstride, 8, limit, il, ht, true);
                        edge(v + 4, 1, uvstride, 8, limit, il, ht, true);
                    }
                    if (mb_y > 0) {
                        edge(y, ystride, 1, 16, limit + 4, il, ht, false);
                        edge(u, uvstride, 1, 8, limit + 4, il, ht, false);
                        edge(v, uvstride, 1, 8, limit + 4, il, ht, false);
                    }
                    if (f.inner) {
                        for (int k = 1; k <= 3; ++k)
                            edge(y + 4 * k * ystride, ystride, 1, 16, limit, il, ht, true);
                        edge(u + 4 * uvstride, uvstride, 1, 8, limit, il, ht, true);
                        edge(v + 4 * uvstride, uvstride, 1, 8, limit, il, ht, true);
                    }
                }
            }
        }
    }
    return 0;
}
