// The arithmetic entropy decoder of liverrenderer_tpu_torch/io/jpeg.py
// (io/jpeg_arith.py): one scan of an arithmetic-coded JPEG (ITU T.81
// Annex D, F.2.4 and G.1.3: sequential, DC first/refine, AC first/refine)
// into its components' quantized coefficients, as libjpeg-turbo's
// jdarith.c decodes it: a marker inside the entropy data makes the decoder
// read zeros from there on, statistics, DC predictions and the coding
// registers restart at each scan and restart marker (read_restart_marker
// with jpeg_resync_to_restart), and an overflow of the spectral index or
// of a magnitude skips the rest of the restart interval.  jpeg_arith.py
// keeps the loop's plain Python version, `_scan_plain`, with the same
// contract; the tests hold the two equal.  Compiled with the host C++
// compiler at first use (host_build.py) and called through ctypes.
//
// Arguments:
//   data, n       the scan's entropy-coded segment (after the SOS header,
//                 up to the marker that ends it; RSTn markers inside)
//   ncomp, comp   components in the scan; per component 6 int32: blocks
//                 per coefficient row, the component's own blocks across
//                 and down, h and v sampling, and its coefficient array
//   coefs         per array a pointer to int16 (rows, stride, 64)
//                 coefficients in zig-zag order
//   dc_tab, ac_tab  per scan component a conditioning table 0..15
//   cond          16 x 3 int32: each table's L, U (DC) and Kx (AC)
//   aritab        114 int64: Table D.2 packed as libjpeg's jaricom.c
//   mcux, mcuy    MCUs across and down of an interleaved scan
//   ss, se, ah, al, progressive, restart  the scan's parameters
//   used          out: the bytes of data the decoder read
// Returns 0, -1 for a bad argument, -2 when the data ends without a marker.

#include <cstdint>
#include <cstring>

namespace {

struct Truncated {};

struct Decoder {
    const uint8_t* d;
    int64_t n, pos = 0;
    const int64_t* tab;
    int64_t c = 0, a = 0;
    int ct = -16;
    int unread = 0, next_rst = 0;

    int byte() {
        if (pos >= n) throw Truncated{};
        return d[pos++];
    }
    void reset() {
        c = 0;
        a = 0;
        ct = -16;
    }
    int decode(uint8_t* st) {
        while (a < 0x8000) {
            if (--ct < 0) {
                int data;
                if (unread) {
                    data = 0;
                } else {
                    data = byte();
                    if (data == 0xFF) {
                        do data = byte();
                        while (data == 0xFF);
                        if (data == 0) {
                            data = 0xFF;
                        } else {
                            unread = data;
                            data = 0;
                        }
                    }
                }
                c = (c << 8) | data;
                if ((ct += 8) < 0)
                    if (++ct == 0) a = 0x8000;
            }
            a <<= 1;
        }
        int sv = *st;
        int64_t qe = tab[sv & 0x7F];
        const int nl = static_cast<int>(qe & 0xFF);
        qe >>= 8;
        const int nm = static_cast<int>(qe & 0xFF);
        qe >>= 8;
        int64_t temp = a - qe;
        a = temp;
        temp <<= ct;
        if (c >= temp) {
            c -= temp;
            if (a < qe) {
                a = qe;
                *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
            } else {
                a = qe;
                *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
                sv ^= 0x80;
            }
        } else if (a < 0x8000) {
            if (a < qe) {
                *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
                sv ^= 0x80;
            } else {
                *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
            }
        }
        return sv >> 7;
    }
    void next_marker() {
        for (;;) {
            int b = byte();
            while (b != 0xFF) b = byte();
            do b = byte();
            while (b == 0xFF);
            if (b != 0) {
                unread = b;
                return;
            }
        }
    }
    void restart() {
        if (unread == 0) next_marker();
        const int want = next_rst;
        if (unread == 0xD0 + want) {
            unread = 0;
        } else {
            int marker = unread;
            for (;;) {
                int action;
                if (marker < 0xC0)
                    action = 2;
                else if (marker < 0xD0 || marker > 0xD7)
                    action = 3;
                else if (marker == 0xD0 + ((want + 1) & 7) ||
                         marker == 0xD0 + ((want + 2) & 7))
                    action = 3;
                else if (marker == 0xD0 + ((want - 1) & 7) ||
                         marker == 0xD0 + ((want - 2) & 7))
                    action = 2;
                else
                    action = 1;
                if (action == 1) {
                    unread = 0;
                    break;
                }
                if (action == 3) break;
                next_marker();
                marker = unread;
            }
        }
        next_rst = (want + 1) & 7;
        reset();
    }
};

inline int16_t i16(int32_t v) { return static_cast<int16_t>(v & 0xFFFF); }

struct Scan {
    Decoder e;
    const int32_t* dct;
    const int32_t* act;
    const int32_t* cond;
    int ss, se, ah, al;
    bool prog;
    uint8_t dc_stats[16][64];
    uint8_t ac_stats[16][256];
    uint8_t fixed = 113;
    int32_t last_dc[4] = {0, 0, 0, 0};
    int32_t dc_ctx[4] = {0, 0, 0, 0};
    int ncomp;

    void reset_stats() {
        for (int ci = 0; ci < ncomp; ++ci) {
            if (!prog || (ss == 0 && ah == 0)) {
                std::memset(dc_stats[dct[ci]], 0, 64);
                last_dc[ci] = dc_ctx[ci] = 0;
            }
            if (!prog || ss) std::memset(ac_stats[act[ci]], 0, 256);
        }
    }

    // F.19 - F.24: one DC difference; false on a magnitude overflow
    bool dc_diff(int ci) {
        const int tbl = dct[ci];
        uint8_t* stats = dc_stats[tbl];
        const int s0 = dc_ctx[ci];
        if (e.decode(stats + s0) == 0) {
            dc_ctx[ci] = 0;
            return true;
        }
        const int sign = e.decode(stats + s0 + 1);
        int st = s0 + 2 + sign;
        int m = e.decode(stats + st);
        if (m) {
            st = 20;
            while (e.decode(stats + st)) {
                if ((m <<= 1) == 0x8000) return false;
                ++st;
            }
        }
        const int lo = (1 << cond[3 * tbl]) >> 1;
        const int hi = (1 << cond[3 * tbl + 1]) >> 1;
        dc_ctx[ci] = m < lo ? 0 : (m > hi ? 12 + 4 * sign : 4 + 4 * sign);
        int v = m;
        st += 14;
        while (m >>= 1)
            if (e.decode(stats + st)) v |= m;
        v += 1;
        if (sign) v = -v;
        last_dc[ci] = (last_dc[ci] + v) & 0xFFFF;
        return true;
    }

    // F.21 - F.24 after a nonzero decision at bin st; false on overflow
    bool ac_value(int tbl, int st, int k, int32_t& out) {
        uint8_t* stats = ac_stats[tbl];
        const int sign = e.decode(&fixed);
        st += 2;
        int m = e.decode(stats + st);
        if (m) {
            if (e.decode(stats + st)) {
                m <<= 1;
                st = k <= cond[3 * tbl + 2] ? 189 : 217;
                while (e.decode(stats + st)) {
                    if ((m <<= 1) == 0x8000) return false;
                    ++st;
                }
            }
        }
        int v = m;
        st += 14;
        while (m >>= 1)
            if (e.decode(stats + st)) v |= m;
        v += 1;
        out = sign ? -v : v;
        return true;
    }

    // the zero run from k: k and st of the next nonzero coefficient;
    // false past `last`
    bool ac_run(int tbl, int& k, int& st, int last) {
        uint8_t* stats = ac_stats[tbl];
        st = 3 * (k - 1);
        while (e.decode(stats + st + 1) == 0) {
            st += 3;
            if (++k > last) return false;
        }
        return true;
    }

    bool block(int16_t* c, int ci) {
        if (!prog) {
            if (!dc_diff(ci)) return false;
            c[0] = i16(last_dc[ci]);
            const int tbl = act[ci];
            for (int k = 1; k <= 63; ++k) {
                if (e.decode(ac_stats[tbl] + 3 * (k - 1))) break;
                int st;
                if (!ac_run(tbl, k, st, 63)) return false;
                int32_t v;
                if (!ac_value(tbl, st, k, v)) return false;
                c[k] = i16(v);
            }
            return true;
        }
        if (ss == 0 && ah == 0) {
            if (!dc_diff(ci)) return false;
            c[0] = i16(last_dc[ci] << al);
            return true;
        }
        if (ss == 0) {
            if (e.decode(&fixed)) c[0] = i16(c[0] | (1 << al));
            return true;
        }
        const int tbl = act[ci];
        if (ah == 0) {
            for (int k = ss; k <= se; ++k) {
                if (e.decode(ac_stats[tbl] + 3 * (k - 1))) break;
                int st;
                if (!ac_run(tbl, k, st, se)) return false;
                int32_t v;
                if (!ac_value(tbl, st, k, v)) return false;
                c[k] = i16(static_cast<int32_t>(
                    static_cast<uint32_t>(v) << al));
            }
            return true;
        }
        const int p1 = 1 << al, m1 = -(1 << al);
        uint8_t* stats = ac_stats[tbl];
        int kex = se;
        while (kex > 0 && c[kex] == 0) --kex;
        for (int k = ss; k <= se; ++k) {
            int st = 3 * (k - 1);
            if (k > kex && e.decode(stats + st)) break;
            for (;;) {
                const int v = c[k];
                if (v) {
                    if (e.decode(stats + st + 2))
                        c[k] = i16(v + (v < 0 ? m1 : p1));
                    break;
                }
                if (e.decode(stats + st + 1)) {
                    c[k] = i16(e.decode(&fixed) ? m1 : p1);
                    break;
                }
                st += 3;
                if (++k > se) return false;
            }
        }
        return true;
    }
};

}  // namespace

extern "C" int32_t lrt_jpeg_arith_scan(
    const uint8_t* data, int64_t n, int32_t ncomp, const int32_t* comp,
    int16_t* const* coefs, const int32_t* dc_tab, const int32_t* ac_tab,
    const int32_t* cond, const int64_t* aritab, int32_t mcux, int32_t mcuy,
    int32_t ss, int32_t se, int32_t ah, int32_t al, int32_t progressive,
    int32_t restart, int64_t* used) {
    if (ncomp < 1 || ncomp > 4) return -1;
    for (int i = 0; i < ncomp; ++i)
        if (dc_tab[i] < 0 || dc_tab[i] > 15 || ac_tab[i] < 0 || ac_tab[i] > 15)
            return -1;
    static thread_local Scan sc;
    sc.e = Decoder{data, n, 0, aritab};
    sc.dct = dc_tab;
    sc.act = ac_tab;
    sc.cond = cond;
    sc.ss = ss;
    sc.se = se;
    sc.ah = ah;
    sc.al = al;
    sc.prog = progressive != 0;
    sc.ncomp = ncomp;
    sc.fixed = 113;
    try {
        sc.reset_stats();
        const int64_t n_mcu = ncomp == 1
            ? static_cast<int64_t>(comp[1]) * comp[2]
            : static_cast<int64_t>(mcux) * mcuy;
        int64_t to_go = restart;
        bool error = false;
        for (int64_t m = 0; m < n_mcu; ++m) {
            if (restart > 0) {
                if (to_go == 0) {
                    sc.e.restart();
                    sc.reset_stats();
                    error = false;
                    to_go = restart;
                }
                --to_go;
            }
            if (error) continue;
            for (int ci = 0; ci < ncomp && !error; ++ci) {
                const int32_t* cp = comp + 6 * ci;
                int16_t* base = coefs[cp[5]];
                const int64_t stride = cp[0];
                if (ncomp == 1) {
                    const int64_t by = m / cp[1], bx = m % cp[1];
                    error = !sc.block(base + (by * stride + bx) * 64, ci);
                    continue;
                }
                const int64_t my = m / mcux, mx = m % mcux;
                for (int vy = 0; vy < cp[4] && !error; ++vy)
                    for (int hx = 0; hx < cp[3] && !error; ++hx) {
                        const int64_t by = my * cp[4] + vy;
                        const int64_t bx = mx * cp[3] + hx;
                        error = !sc.block(base + (by * stride + bx) * 64, ci);
                    }
            }
        }
    } catch (const Truncated&) {
        *used = sc.e.pos;
        return -2;
    }
    *used = sc.e.pos;
    return 0;
}
