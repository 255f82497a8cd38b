// The entropy decoder of liverrenderer_tpu_torch/io/jpeg.py: one scan of
// a Huffman-coded JPEG (baseline, extended or progressive; ITU T.81 Annex
// F and G) into its components' quantized coefficients, with libjpeg's
// handling of byte stuffing, fill bytes, markers inside entropy data (the
// decoder reads zeros past them) and restart intervals.  jpeg.py keeps the
// loop's plain Python version, `_scan_plain`, with the same contract; the
// tests hold the two equal.  Compiled with the host C++ compiler at first
// use (host_build.py) and called through ctypes.
//
// Arguments:
//   data, n       the scan's entropy-coded segment (after the SOS header,
//                 up to the marker that ends it; RSTn markers inside)
//   ncomp         components in the scan
//   comp          per component 6 int32: blocks per coefficient row (the
//                 array's stride in blocks), the component's own blocks
//                 across and down (a non-interleaved scan's extent), h and
//                 v sampling, and the index of its coefficient array
//   coefs         per component index a pointer to int16 (rows, stride,
//                 64) coefficients in zig-zag order
//   dc_tab, ac_tab  per scan component a table number 0..3
//   tables        8 tables (DC 0..3, AC 0..3) of 16 code counts and 256
//                 symbols, int32
//   mcux, mcuy    MCUs across and down of an interleaved scan
//   ss, se, ah, al  the scan's spectral selection and successive
//                 approximation; progressive says which decoder runs
//   restart       the restart interval in MCUs (0: none)
// Returns 0, or -1 for a bad argument.

#include <cstdint>
#include <cstring>

namespace {

struct Table {
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint8_t val[256];
};

void make_table(const int32_t* spec, Table& t) {
    int32_t code = 0, p = 0;
    for (int l = 1; l <= 16; ++l) {
        const int32_t n = spec[l - 1];
        if (n) {
            t.valoffset[l] = p - code;
            code += n;
            p += n;
            t.maxcode[l] = code - 1;
        } else {
            t.maxcode[l] = -1;
        }
        code <<= 1;
    }
    t.maxcode[17] = 0x7fffffff;
    for (int i = 0; i < 256; ++i) t.val[i] = static_cast<uint8_t>(spec[16 + i]);
}

struct Bits {
    const uint8_t* d;
    int64_t n, pos = 0;
    uint32_t byte = 0;
    int cnt = 0;
    bool marker = false;

    // the next data byte: 0xFF 0x00 is 0xFF, fill 0xFFs are skipped, and
    // from a marker on the stream reads zeros
    uint32_t next() {
        if (marker || pos >= n) return 0;
        uint32_t c = d[pos];
        if (c != 0xFF) {
            ++pos;
            return c;
        }
        int64_t q = pos + 1;
        while (q < n && d[q] == 0xFF) ++q;
        if (q < n && d[q] == 0) {
            pos = q + 1;
            return 0xFF;
        }
        marker = true;
        return 0;
    }
    int bit() {
        if (cnt == 0) {
            byte = next();
            cnt = 8;
        }
        --cnt;
        return (byte >> cnt) & 1;
    }
    int32_t get(int k) {
        int32_t v = 0;
        while (k-- > 0) v = (v << 1) | bit();
        return v;
    }
    // a restart: drop the buffered bits, skip the RSTn marker
    void restart() {
        cnt = 0;
        marker = false;
        while (pos < n && d[pos] == 0xFF) ++pos;
        if (pos < n && d[pos] >= 0xD0 && d[pos] <= 0xD7) ++pos;
    }
};

int decode(Bits& b, const Table& t) {
    int32_t code = b.bit();
    int l = 1;
    while (code > t.maxcode[l]) {
        code = (code << 1) | b.bit();
        if (++l > 16) return 0;     // a corrupt code: libjpeg's symbol 0
    }
    return t.val[(code + t.valoffset[l]) & 0xFF];
}

inline int32_t extend(int32_t r, int s) {
    return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
}

inline int zz(int k) { return k > 63 ? 63 : k; }

struct Scan {
    Bits bits;
    const Table* dc[4];
    const Table* ac[4];
    int ss, se, ah, al;
    bool progressive;
    int32_t pred[4] = {0, 0, 0, 0};
    int32_t eobrun = 0;

    void block(int16_t* c, int ci, int dct, int act) {
        if (!progressive) {
            int s = decode(bits, *dc[dct]);
            if (s) s = extend(bits.get(s), s);
            pred[ci] += s;
            c[0] = static_cast<int16_t>(pred[ci]);
            for (int k = 1; k < 64; ++k) {
                const int rs = decode(bits, *ac[act]);
                const int r = rs >> 4, sz = rs & 15;
                if (sz) {
                    k += r;
                    c[zz(k)] = static_cast<int16_t>(extend(bits.get(sz), sz));
                } else {
                    if (r != 15) break;
                    k += 15;
                }
            }
            return;
        }
        if (ss == 0) {                       // DC scans
            if (ah == 0) {
                int s = decode(bits, *dc[dct]);
                if (s) s = extend(bits.get(s), s);
                pred[ci] += s;
                c[0] = static_cast<int16_t>(pred[ci] * (1 << al));
            } else if (bits.bit()) {
                c[0] = static_cast<int16_t>(c[0] | (1 << al));
            }
            return;
        }
        if (ah == 0) {                       // AC first scans
            if (eobrun > 0) {
                --eobrun;
                return;
            }
            for (int k = ss; k <= se; ++k) {
                const int rs = decode(bits, *ac[act]);
                int r = rs >> 4;
                const int s = rs & 15;
                if (s) {
                    k += r;
                    c[zz(k)] = static_cast<int16_t>(
                        extend(bits.get(s), s) * (1 << al));
                } else if (r == 15) {
                    k += 15;
                } else {
                    eobrun = 1 << r;
                    if (r) eobrun += bits.get(r);
                    --eobrun;
                    break;
                }
            }
            return;
        }
        // AC refinement scans
        const int p1 = 1 << al, m1 = -1 * (1 << al);
        int k = ss;
        auto refine = [&](int16_t& v) {
            if (bits.bit() && (v & p1) == 0)
                v = static_cast<int16_t>(v + (v >= 0 ? p1 : m1));
        };
        if (eobrun == 0) {
            for (; k <= se; ++k) {
                const int rs = decode(bits, *ac[act]);
                int r = rs >> 4;
                int s = rs & 15;
                if (s) {
                    s = bits.bit() ? p1 : m1;
                } else if (r != 15) {
                    eobrun = 1 << r;
                    if (r) eobrun += bits.get(r);
                    break;
                }
                do {
                    int16_t& v = c[zz(k)];
                    if (v != 0) {
                        refine(v);
                    } else if (--r < 0) {
                        break;
                    }
                    ++k;
                } while (k <= se);
                if (s) c[zz(k)] = static_cast<int16_t>(s);
            }
        }
        if (eobrun > 0) {
            for (; k <= se; ++k)
                if (c[zz(k)] != 0) refine(c[zz(k)]);
            --eobrun;
        }
    }
};

}  // namespace

extern "C" int32_t lrt_jpeg_scan(const uint8_t* data, int64_t n,
                                 int32_t ncomp, const int32_t* comp,
                                 int16_t* const* coefs, const int32_t* dc_tab,
                                 const int32_t* ac_tab, const int32_t* tables,
                                 int32_t mcux, int32_t mcuy, int32_t ss,
                                 int32_t se, int32_t ah, int32_t al,
                                 int32_t progressive, int32_t restart) {
    if (ncomp < 1 || ncomp > 4) return -1;
    static thread_local Table tabs[8];
    for (int i = 0; i < 8; ++i) make_table(tables + 272 * i, tabs[i]);
    Scan sc{Bits{data, n}, {}, {}, ss, se, ah, al, progressive != 0};
    for (int i = 0; i < 4; ++i) {
        sc.dc[i] = &tabs[i];
        sc.ac[i] = &tabs[4 + i];
    }
    int64_t n_mcu;
    if (ncomp == 1)
        n_mcu = static_cast<int64_t>(comp[1]) * comp[2];
    else
        n_mcu = static_cast<int64_t>(mcux) * mcuy;
    int64_t to_go = restart;
    for (int64_t m = 0; m < n_mcu; ++m) {
        if (restart > 0) {
            if (to_go == 0) {
                sc.bits.restart();
                for (int i = 0; i < 4; ++i) sc.pred[i] = 0;
                sc.eobrun = 0;
                to_go = restart;
            }
            --to_go;
        }
        for (int ci = 0; ci < ncomp; ++ci) {
            const int32_t* cp = comp + 6 * ci;
            int16_t* base = coefs[cp[5]];
            const int64_t stride = cp[0];
            if (ncomp == 1) {
                const int64_t by = m / cp[1], bx = m % cp[1];
                sc.block(base + (by * stride + bx) * 64, ci, dc_tab[ci],
                         ac_tab[ci]);
                continue;
            }
            const int64_t my = m / mcux, mx = m % mcux;
            for (int vy = 0; vy < cp[4]; ++vy)
                for (int hx = 0; hx < cp[3]; ++hx) {
                    const int64_t by = my * cp[4] + vy, bx = mx * cp[3] + hx;
                    sc.block(base + (by * stride + bx) * 64, ci, dc_tab[ci],
                             ac_tab[ci]);
                }
        }
    }
    return 0;
}
