// The BC6H and BC7 block decoders of liverrenderer_tpu_torch/io/bcn.py, as
// Pillow 12.1's BcnDecode.c decodes them.  bcn.py keeps each loop's plain
// Python version (`_bc6h_plain`, `_bc7_plain`) with the same contract; the
// tests hold the two equal.  Compiled with the host C++ compiler at first
// use (host_build.py) and called through ctypes.
//
// The tables (BC7's partition and anchor tables, BC6H's endpoint bit
// layouts) come from bcn.py, so one copy serves both versions.
//
// lrt_bc7(src, nb, out, si2, si3, ai0, ai1, ai2): nb 16-byte blocks ->
//   out, nb * 16 RGBA pixels (4x4 in row order).  A first byte of 0 (no
//   mode bit) decodes as Pillow's "degenerate" block, (0, 0, 0, 255).
// lrt_bc6h(src, nb, sign, out, si2, ai0, pack): nb 16-byte blocks ->
//   out, nb * 16 RGB pixels.  The half floats are mapped to 8 bits as
//   Pillow maps them (x 31/64 or x 31/32, half -> float, clamp to [0, 1],
//   x 255 truncated); a reserved mode gives black.

#include <cstdint>
#include <cstring>

namespace {

struct Bc7Mode {
    uint8_t ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};

constexpr Bc7Mode kBc7Modes[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

constexpr uint8_t kW2[4] = {0, 21, 43, 64};
constexpr uint8_t kW3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
constexpr uint8_t kW4[16] = {0,  4,  9,  13, 17, 21, 26, 30,
                             34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t* weights(int n) {
    return n == 2 ? kW2 : n == 3 ? kW3 : kW4;
}

struct Tables {
    const uint16_t* si2;
    const uint32_t* si3;
    const uint8_t *ai0, *ai1, *ai2;
};

int subset_index(const Tables& t, int ns, int p, int i) {
    if (ns == 2) return 1 & (t.si2[p] >> i);
    if (ns == 3) return 3 & (t.si3[p] >> (2 * i));
    return 0;
}

int get_bit(const uint8_t* src, int bit) {
    return (src[bit >> 3] >> (bit & 7)) & 1;
}

// Pillow's get_bits: at most 8 bits, from at most two bytes
uint8_t get_bits(const uint8_t* src, int bit, int count) {
    const int by = bit >> 3;
    bit &= 7;
    if (!count) return 0;
    if (bit + count <= 8) return uint8_t((src[by] >> bit) & ((1 << count) - 1));
    const int x = src[by] | (by + 1 < 16 ? src[by + 1] << 8 : 0);
    return uint8_t((x >> bit) & ((1 << count) - 1));
}

uint8_t expand(uint8_t v, int bits) {
    v = uint8_t(v << (8 - bits));
    return uint8_t(v | (v >> bits));
}

struct Rgba {
    uint8_t r, g, b, a;
};

void bc7_block(const Tables& t, const uint8_t* src, uint8_t* out) {
    Rgba* col = reinterpret_cast<Rgba*>(out);
    int mode = src[0];
    if (!mode) {
        for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 255};
        return;
    }
    int bit = 0;
    while (!(mode & (1 << bit++))) {
    }
    mode = bit - 1;
    const Bc7Mode& info = kBc7Modes[mode];
    int cb = info.cb, ab = info.ab;
    const uint8_t* cw = weights(info.ib);
    const uint8_t* aw = weights((ab && info.ib2) ? info.ib2 : info.ib);
    auto load = [&](int n) {
        const uint8_t v = get_bits(src, bit, n);
        bit += n;
        return v;
    };
    const int partition = load(info.pb);
    const int rotation = load(info.rb);
    const int index_sel = load(info.isb);
    const int numep = info.ns << 1;
    Rgba ep[6] = {};
    for (int i = 0; i < numep; ++i) ep[i].r = load(cb);
    for (int i = 0; i < numep; ++i) ep[i].g = load(cb);
    for (int i = 0; i < numep; ++i) ep[i].b = load(cb);
    for (int i = 0; i < numep; ++i) ep[i].a = ab ? load(ab) : 255;
    auto assign_p = [&](Rgba& e, int v) {
        e.r = uint8_t((e.r << 1) | v);
        e.g = uint8_t((e.g << 1) | v);
        e.b = uint8_t((e.b << 1) | v);
        if (ab) e.a = uint8_t((e.a << 1) | v);
    };
    if (info.epb) {
        ++cb;
        if (ab) ++ab;
        for (int i = 0; i < numep; ++i) assign_p(ep[i], load(1));
    }
    if (info.spb) {
        ++cb;
        if (ab) ++ab;
        for (int i = 0; i < numep; i += 2) {
            const int v = load(1);
            assign_p(ep[i], v);
            assign_p(ep[i + 1], v);
        }
    }
    for (int i = 0; i < numep; ++i) {
        ep[i].r = expand(ep[i].r, cb);
        ep[i].g = expand(ep[i].g, cb);
        ep[i].b = expand(ep[i].b, cb);
        if (ab) ep[i].a = expand(ep[i].a, ab);
    }
    int cibit = bit;
    int aibit = cibit + 16 * info.ib - info.ns;
    for (int i = 0; i < 16; ++i) {
        const int s = subset_index(t, info.ns, partition, i) << 1;
        int ib = info.ib;
        if (i == 0) {
            --ib;
        } else if (info.ns == 2) {
            if (i == t.ai0[partition]) --ib;
        } else if (info.ns == 3) {
            if (i == t.ai1[partition] || i == t.ai2[partition]) --ib;
        }
        const int i0 = get_bits(src, cibit, ib);
        cibit += ib;
        int s0 = cw[i0], s1 = cw[i0];
        if (ab && info.ib2) {
            int ib2 = info.ib2;
            if (i == 0) --ib2;
            const int i1 = get_bits(src, aibit, ib2);
            aibit += ib2;
            if (index_sel) {
                s0 = aw[i1];
                s1 = cw[i0];
            } else {
                s1 = aw[i1];
            }
        }
        const Rgba* e = ep + s;
        const int t0 = 64 - s0, t1 = 64 - s1;
        Rgba c;
        c.r = uint8_t((t0 * e[0].r + s0 * e[1].r + 32) >> 6);
        c.g = uint8_t((t0 * e[0].g + s0 * e[1].g + 32) >> 6);
        c.b = uint8_t((t0 * e[0].b + s0 * e[1].b + 32) >> 6);
        c.a = uint8_t((t1 * e[0].a + s1 * e[1].a + 32) >> 6);
        uint8_t v;
        if (rotation == 1) {
            v = c.r; c.r = c.a; c.a = v;
        } else if (rotation == 2) {
            v = c.g; c.g = c.a; c.a = v;
        } else if (rotation == 3) {
            v = c.b; c.b = c.a; c.a = v;
        }
        col[i] = c;
    }
}

struct Bc6Mode {
    uint8_t ns, tr, pb, epb, rb, gb, bb;
};

constexpr Bc6Mode kBc6Modes[14] = {
    {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},  {2, 1, 5, 11, 5, 4, 4},
    {2, 1, 5, 11, 4, 5, 4}, {2, 1, 5, 11, 4, 4, 5}, {2, 1, 5, 9, 5, 5, 5},
    {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},  {2, 1, 5, 8, 5, 5, 6},
    {2, 0, 5, 6, 6, 6, 6},  {1, 0, 0, 10, 10, 10, 10},
    {1, 1, 0, 11, 9, 9, 9}, {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};

void sign_extend(uint16_t& v, int prec) {
    if (v & (1u << (prec - 1))) v = uint16_t(v | (0xffffu << prec));
}

int unquantize(uint16_t v, int prec, int sign) {
    if (!sign) {
        const int x = v;
        if (prec >= 15) return x;
        if (x == 0) return 0;
        if (x == (1 << prec) - 1) return 0xffff;
        return ((x << 15) + 0x4000) >> (prec - 1);
    }
    int x = int16_t(v);
    if (prec >= 16) return x;
    int s = 0;
    if (x < 0) {
        s = 1;
        x = -x;
    }
    if (x != 0) {
        if (x >= (1 << (prec - 1)) - 1) {
            x = 0x7fff;
        } else {
            x = ((x << 15) + 0x4000) >> (prec - 1);
        }
    }
    return s ? -x : x;
}

float half_to_float(uint16_t h) {
    union {
        uint32_t u;
        float f;
    } o, m;
    m.u = 0x77800000;
    o.u = uint32_t(h & 0x7fff) << 13;
    o.f *= m.f;
    m.u = 0x47800000;
    if (o.f >= m.f) o.u |= 255u << 23;
    o.u |= uint32_t(h & 0x8000) << 16;
    return o.f;
}

float finalize(int v, int sign) {
    if (sign) {
        if (v < 0) return half_to_float(uint16_t(0x8000 | (((-v) * 31) / 32)));
        return half_to_float(uint16_t((v * 31) / 32));
    }
    return half_to_float(uint16_t((v * 31) / 64));
}

uint8_t clamp8(float value) {
    if (value < 0.0f) return 0;
    if (value > 1.0f) return 255;
    return uint8_t(value * 255.0f);
}

void bc6_block(const Tables& t, const uint8_t* pack, const uint8_t* src,
               int sign, uint8_t* out) {
    int mode = src[0] & 0x1f;
    int bit, epbits, ib = 3;
    if ((mode & 3) < 2) {
        mode &= 1;
        bit = 2;
        epbits = 75;
    } else if ((mode & 3) == 2) {
        mode = 2 + (mode >> 2);
        bit = 5;
        epbits = 72;
    } else {
        mode = 10 + (mode >> 2);
        bit = 5;
        epbits = 60;
        ib = 4;
    }
    if (mode > 13) {
        std::memset(out, 0, 16 * 3);
        return;
    }
    const Bc6Mode& info = kBc6Modes[mode];
    const uint8_t* cw = weights(ib);
    const int numep = info.ns == 2 ? 12 : 6;
    uint16_t ep[12] = {};
    for (int i = 0; i < epbits; ++i) {
        const int di = pack[mode * 75 + i];
        ep[di >> 4] = uint16_t(ep[di >> 4] | (get_bit(src, bit + i) << (di & 15)));
    }
    bit += epbits;
    const int partition = get_bits(src, bit, info.pb);
    bit += info.pb;
    const int mask = (1 << info.epb) - 1;
    if (sign)
        for (int i = 0; i < 3; ++i) sign_extend(ep[i], info.epb);
    if (sign || info.tr) {
        for (int i = 3; i < numep; i += 3) {
            sign_extend(ep[i], info.rb);
            sign_extend(ep[i + 1], info.gb);
            sign_extend(ep[i + 2], info.bb);
        }
    }
    if (info.tr) {
        for (int i = 3; i < numep; ++i)
            ep[i] = uint16_t((ep[i] + ep[i % 3]) & mask);
        // Pillow does not sign-extend the sums of a signed block
    }
    int ueps[12];
    for (int i = 0; i < numep; ++i) ueps[i] = unquantize(ep[i], info.epb, sign);
    for (int i = 0; i < 16; ++i) {
        const int s = subset_index(t, info.ns, partition, i) * 6;
        int ib2 = ib;
        if (i == 0) {
            --ib2;
        } else if (info.ns == 2 && i == t.ai0[partition]) {
            --ib2;
        }
        const int i0 = get_bits(src, bit, ib2);
        bit += ib2;
        const int w = cw[i0], tw = 64 - w;
        for (int c = 0; c < 3; ++c) {
            const int v = (ueps[s + c] * tw + ueps[s + 3 + c] * w) >> 6;
            out[i * 3 + c] = clamp8(finalize(v, sign));
        }
    }
}

}  // namespace

extern "C" void lrt_bc7(const uint8_t* src, int64_t nb, uint8_t* out,
                        const uint16_t* si2, const uint32_t* si3,
                        const uint8_t* ai0, const uint8_t* ai1,
                        const uint8_t* ai2) {
    const Tables t{si2, si3, ai0, ai1, ai2};
    for (int64_t k = 0; k < nb; ++k) bc7_block(t, src + 16 * k, out + 64 * k);
}

extern "C" void lrt_bc6h(const uint8_t* src, int64_t nb, int32_t sign,
                         uint8_t* out, const uint16_t* si2,
                         const uint8_t* ai0, const uint8_t* pack) {
    const Tables t{si2, nullptr, ai0, nullptr, nullptr};
    for (int64_t k = 0; k < nb; ++k)
        bc6_block(t, pack, src + 16 * k, sign, out + 48 * k);
}
