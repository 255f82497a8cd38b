// The CCITT fax decoder of liverrenderer_tpu_torch/io/tiff_fax.py: one
// strip or tile of a TIFF with compression 2, 3, 4 or 32771, as libtiff
// 4.7's tif_fax3.c decodes it for Pillow.  tiff_fax.py keeps the plain
// Python version (`_decode_plain`) with the same contract; the tests hold
// the two equal.  Compiled with the host C++ compiler at first use
// (host_build.py) and called through ctypes.
//
// lrt_fax_decode(src, n, kind, rows, lastx, rowbytes, lsb_first, odd_start,
//                runs, nruns, strip, flags, main, white, black, rev)
//   -> 1, or -1 where libtiff fails the strip.
//   kind: 0 RLE (compression 2), 1 RLEW (32771), 2 G3 1-D, 3 G3 2-D,
//   4 G4.  rows rows of lastx pixels go to strip (rowbytes each, black
//   runs set, white runs cleared, bits MSB-first); rows libtiff does not
//   write keep their bytes.  runs: the 2 * nruns uint32 run arrays (two
//   halves, the current row's and the reference row's), kept from strip to
//   strip like flags (bit 2: FAXMODE_NOEOL, set on G3 data without
//   EOLs).  main / white / black: the 128, 4096 and 8192 (state, width,
//   param) int32 rows of libtiff's tables; rev: the bit-reversal table
//   (used unless lsb_first).  odd_start: the data's file offset is odd
//   (RLEW aligns to the pointer's 16-bit words).

#include <cstdint>
#include <cstring>

namespace {

enum { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
       S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL };
enum { RLE, RLEW, G3_1D, G3_2D, G4 };
constexpr int32_t kNoEol = 2;

struct Eof {};
struct Overflow {};

struct Fax {
    const uint8_t* src;
    int64_t cp, ep;
    const uint8_t* rev;
    int kind;
    int32_t lastx;
    int odd_start;
    uint32_t* runs;
    int64_t nruns, cur, ref, thisrun, pa, pb;
    int32_t* flags;
    const int32_t *main_t, *white_t, *black_t;
    uint32_t acc = 0;
    int avail = 0;
    int eolcnt = 0;
    int32_t a0 = 0, run_length = 0, b1 = 0;

    static int32_t s32(int64_t x) { return int32_t(uint32_t(uint64_t(x))); }

    uint32_t byte() {
        const uint8_t b = src[cp++];
        return rev ? rev[b] : b;
    }
    void need8(int n) {
        if (avail < n) {
            if (cp >= ep) {
                if (avail == 0) throw Eof{};
                avail = n;
            } else {
                acc |= byte() << avail;
                avail += 8;
            }
        }
    }
    void need16(int n) {
        if (avail < n) {
            if (cp >= ep) {
                if (avail == 0) throw Eof{};
                avail = n;
            } else {
                acc |= byte() << avail;
                avail += 8;
                if (avail < n) {
                    if (cp >= ep) {
                        avail = n;
                    } else {
                        acc |= byte() << avail;
                        avail += 8;
                    }
                }
            }
        }
    }
    uint32_t get(int n) const { return acc & ((1u << n) - 1); }
    void clr(int n) {
        avail -= n;
        acc = n >= 32 ? 0 : acc >> n;
    }
    // a table lookup -> state, param
    int lookup(int wid, const int32_t* table, bool sixteen, int32_t& param) {
        if (sixteen) need16(wid); else need8(wid);
        const int32_t* e = table + 3 * get(wid);
        clr(e[1]);
        param = e[2];
        return e[0];
    }
    uint32_t ref_at(int64_t i) const {
        return i < 2 * nruns ? runs[i] : 0;
    }
    void setvalue(int64_t x) {
        if (pa >= thisrun + nruns) throw Overflow{};
        runs[pa++] = uint32_t(uint64_t(int64_t(run_length) + x));
        a0 = s32(int64_t(a0) + x);
        run_length = 0;
    }
    void cleanup() {
        if (run_length) setvalue(0);
        if (a0 != lastx) {
            while (a0 > lastx && pa > thisrun) {
                --pa;
                a0 = s32(int64_t(a0) - int64_t(runs[pa]));
            }
            if (a0 < lastx) {
                if (a0 < 0) a0 = 0;
                if ((pa - thisrun) & 1) setvalue(0);
                setvalue(int64_t(lastx) - a0);
            } else if (a0 > lastx) {
                setvalue(lastx);
                setvalue(0);
            }
        }
    }
    // _TIFFFax3fillruns
    void fill(uint8_t* row) {
        int64_t end = pa;
        if ((end - thisrun) & 1) {
            if (end < 2 * nruns) runs[end] = 0;
            ++end;
        }
        uint32_t x = 0;
        const uint32_t lx = uint32_t(lastx);
        for (int64_t i = thisrun; i < end; ++i) {
            uint32_t run = ref_at(i);
            if (uint64_t(x) + run > lx || run > lx) {
                run = lx - x;
                if (i < 2 * nruns) runs[i] = run;
            }
            if (run) {
                const bool black = (i - thisrun) & 1;
                for (uint32_t k = x; k < x + run; ++k) {
                    const uint8_t m = uint8_t(0x80 >> (k & 7));
                    if (black) row[k >> 3] |= m; else row[k >> 3] &= uint8_t(~m);
                }
                x += run;
            }
        }
    }
    void sync_eol() {
        if (*flags & kNoEol) return;
        if (eolcnt == 0) {
            for (;;) {
                need16(11);
                if (get(11) == 0) break;
                clr(1);
            }
        }
        for (;;) {
            try {
                need8(8);
            } catch (Eof&) {                 // tryG3WithoutEOL
                *flags |= kNoEol;
                cp = 0;
                acc = 0;
                avail = 0;
                return;
            }
            if (get(8)) break;
            clr(8);
        }
        while (get(1) == 0) clr(1);
        clr(1);
        eolcnt = 0;
    }
    // one run's makeup and terminating codes -> false on a code that ends
    // the row (an EOL, in 1-D coding, sets eolcnt)
    bool run_codes(const int32_t* table, int wid, int term, int makeup,
                   bool eol) {
        for (;;) {
            int32_t param;
            const int state = lookup(wid, table, true, param);
            if (eol && state == S_EOL) {
                eolcnt = 1;
                return false;
            }
            if (state == term) {
                setvalue(param);
                return true;
            }
            if (state == makeup || state == S_MakeUp) {
                a0 = s32(int64_t(a0) + param);
                run_length = s32(int64_t(run_length) + param);
                continue;
            }
            return false;
        }
    }
    void expand1d_body() {
        for (;;) {
            if (!run_codes(white_t, 12, S_TermW, S_MakeUpW, true)) return;
            if (a0 >= lastx) return;
            if (!run_codes(black_t, 13, S_TermB, S_MakeUpB, true)) return;
            if (a0 >= lastx) return;
            if (runs[pa - 1] == 0 && runs[pa - 2] == 0) pa -= 2;
        }
    }
    void expand1d() {
        try {
            expand1d_body();
        } catch (Eof&) {
            cleanup();
            throw;
        }
        cleanup();
    }
    void check_b1() {
        if (pa != thisrun) {
            while (b1 <= a0 && b1 < lastx) {
                if (pb + 1 >= ref + nruns) throw Overflow{};
                b1 = s32(int64_t(b1) + int64_t(uint32_t(runs[pb] + runs[pb + 1])));
                pb += 2;
            }
        }
    }
    uint32_t next_ref() { return ref_at(pb++); }
    void eol_run() {
        if (pa < 2 * nruns) runs[pa] = uint32_t(int64_t(lastx) - a0);
        ++pa;
    }
    void expand2d_body() {
        bool ended = false;
        while (a0 < lastx) {
            if (pa >= thisrun + nruns) throw Overflow{};
            int32_t param;
            const int state = lookup(7, main_t, false, param);
            if (state == S_Pass) {
                check_b1();
                if (pb + 1 >= ref + nruns) throw Overflow{};
                b1 = s32(int64_t(b1) + next_ref());
                run_length = s32(int64_t(run_length) + b1 - a0);
                a0 = b1;
                b1 = s32(int64_t(b1) + next_ref());
            } else if (state == S_Horiz) {
                bool ok;
                if ((pa - thisrun) & 1)
                    ok = run_codes(black_t, 13, S_TermB, S_MakeUpB, false) &&
                         run_codes(white_t, 12, S_TermW, S_MakeUpW, false);
                else
                    ok = run_codes(white_t, 12, S_TermW, S_MakeUpW, false) &&
                         run_codes(black_t, 13, S_TermB, S_MakeUpB, false);
                if (!ok) {
                    ended = true;
                    break;
                }
                check_b1();
            } else if (state == S_V0 || state == S_VR) {
                check_b1();
                setvalue(int64_t(uint32_t(int64_t(b1) - a0 + param)));
                if (pb >= ref + nruns) throw Overflow{};
                b1 = s32(int64_t(b1) + next_ref());
            } else if (state == S_VL) {
                check_b1();
                if (b1 < s32(int64_t(a0) + param)) {
                    ended = true;
                    break;
                }
                setvalue(int64_t(uint32_t(int64_t(b1) - a0 - param)));
                --pb;
                b1 = s32(int64_t(b1) - int64_t(ref_at(pb)));
            } else if (state == S_Ext) {
                eol_run();
                ended = true;
                break;
            } else if (state == S_EOL) {
                eol_run();
                need8(4);
                clr(4);
                eolcnt = 1;
                ended = true;
                break;
            } else {
                ended = true;
                break;
            }
        }
        if (!ended && run_length) {
            if (s32(int64_t(run_length) + a0) < lastx) {
                need8(1);
                if (!get(1)) return;          // badMain2d: the cleanup
                clr(1);
            }
            setvalue(0);
        }
    }
    void expand2d() {
        try {
            expand2d_body();
        } catch (Eof&) {
            cleanup();
            throw;
        }
        cleanup();
    }
    // Fax4Decode's EOFG4
    int g4_end(uint8_t* row, int line) {
        try {
            need16(13);
        } catch (Eof&) {
        }
        clr(13);
        fill(row);
        return line ? 1 : -1;
    }
    int run(int rows, int rowbytes, uint8_t* strip) {
        int line = 0;
        try {
            while (line < rows) {
                uint8_t* row = strip + int64_t(line) * rowbytes;
                a0 = run_length = 0;
                thisrun = pa = cur;
                bool is1d = true;
                try {
                    if (kind == G3_1D || kind == G3_2D) sync_eol();
                    if (kind == G3_2D) {
                        need8(1);
                        is1d = get(1) != 0;
                        clr(1);
                    }
                    if (kind == G3_2D || kind == G4) {
                        pb = ref;
                        b1 = int32_t(next_ref());
                    }
                } catch (Eof&) {
                    cleanup();
                    fill(row);
                    return -1;
                }
                try {
                    if (kind == G4 || (kind == G3_2D && !is1d))
                        expand2d();
                    else
                        expand1d();
                } catch (Eof&) {
                    if (kind == G4) return g4_end(row, line);
                    fill(row);
                    return -1;
                }
                if (kind == G4 && eolcnt) return g4_end(row, line);
                fill(row);
                if (kind == RLE) {
                    clr(avail & 7);
                } else if (kind == RLEW) {
                    clr(avail & 15);
                    if (avail == 0 && int(cp & 1) != odd_start) ++cp;
                } else if (kind == G3_2D) {
                    if (pa < thisrun + nruns) setvalue(0);
                    const int64_t t = cur;
                    cur = ref;
                    ref = t;
                } else if (kind == G4) {
                    setvalue(0);
                    const int64_t t = cur;
                    cur = ref;
                    ref = t;
                }
                ++line;
            }
        } catch (Overflow&) {
            return -1;
        }
        return 1;
    }
};

}  // namespace

extern "C" int32_t lrt_fax_decode(const uint8_t* src, int64_t n, int32_t kind,
                                  int32_t rows, int32_t lastx,
                                  int32_t rowbytes, int32_t lsb_first,
                                  int32_t odd_start, uint32_t* runs,
                                  int32_t nruns, uint8_t* strip,
                                  int32_t* flags, const int32_t* main_t,
                                  const int32_t* white_t,
                                  const int32_t* black_t,
                                  const uint8_t* rev) {
    Fax f;
    f.src = src;
    f.cp = 0;
    f.ep = n;
    f.rev = lsb_first ? nullptr : rev;
    f.kind = kind;
    f.lastx = lastx;
    f.odd_start = odd_start;
    f.runs = runs;
    f.nruns = nruns;
    f.cur = 0;
    f.ref = nruns;
    f.thisrun = f.pa = f.pb = 0;
    f.flags = flags;
    f.main_t = main_t;
    f.white_t = white_t;
    f.black_t = black_t;
    if (kind == G3_2D || kind == G4) {         // Fax3PreDecode
        runs[nruns] = uint32_t(lastx);
        runs[nruns + 1] = 0;
    }
    return f.run(rows, rowbytes, strip);
}
