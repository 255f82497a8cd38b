// The two LZW decoders of liverrenderer_tpu_torch/io/lzw.py, for TIFF
// strips and tiles (io/tiff.py) and GIF frames (io/gif.py).  lzw.py keeps
// each loop's plain Python version (`_lzw_tiff_plain`, `_lzw_gif_plain`)
// with the same contract; the tests hold the two equal.  Compiled with the
// host C++ compiler at first use (host_build.py) and called through
// ctypes.
//
// lrt_lzw_tiff(src, n, dst, occ, compat) -> bytes written, or -1 for a
//   corrupt code table.  TIFF's LZW as libtiff decodes it: codes MSB-first,
//   Clear 256, EOI 257, 9 to 12 bits, the width growing one code early
//   (when the next free code reaches 2^bits - 1); with `compat`, the old
//   style of LZWDecodeCompat: codes LSB-first, the width growing when the
//   next free code reaches 2^bits.  Stops at EOI, at the end of the
//   data or when `occ` bytes are out; the caller holds a short result to
//   be an error, as libtiff does.
//
// lrt_lzw_gif(src, n, bits, interlace, dst, xsize, ysize, chunk, state)
//   -> the status of Pillow's GIF decoder (GifDecode.c) run on one frame's
//   data (the sub-blocks after the minimum code size byte, to the end of
//   the file) as Pillow's ImageFile.load feeds it, `chunk` bytes at a
//   time: -1 when the frame is complete or the stream broke (state[0] then
//   holds the error: 0, -2 broken, -1 overrun, -8 config), else the bytes
//   it used before it wanted more than the file holds, which Pillow
//   reports as a truncated file.  An end code returns to the feeder, which
//   goes on while the file has bytes it has not fed.  Codes LSB-first in length-prefixed sub-blocks, the
//   width growing when the next free code equals 2^bits - 1, no entries
//   added past 4,096 (a deferred clear), a code equal to the next free
//   one (KwKwK) taken as the last string plus its first byte, and after
//   an end code the decoder reads on.  dst is the frame's xsize * ysize
//   bytes, rows in order; an interlaced frame's rows come in GIF's four
//   passes.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kTiffClear = 256, kTiffEoi = 257, kTiffFirst = 258;
constexpr int kTiffCsize = 4095 + 1024;

struct Entry {
    int32_t prev;      // previous code of the string, -1 for a root
    int32_t length;
    uint8_t value;     // last byte of the string
    uint8_t first;     // first byte of the string
};

}  // namespace

extern "C" int64_t lrt_lzw_tiff(const uint8_t* src, int64_t n, uint8_t* dst,
                                int64_t occ, int32_t compat) {
    static thread_local Entry tab[kTiffCsize];
    for (int i = 0; i < 256; ++i) tab[i] = {-1, 1, uint8_t(i), uint8_t(i)};
    int64_t pos = 0, out = 0;
    uint64_t bitbuf = 0;
    int bitcount = 0, nbits = 9, free_ent = kTiffFirst, old = -1;
    const int grow = compat ? 1 : 2;
    auto next_code = [&]() -> int {
        while (bitcount < nbits) {
            if (pos >= n) return kTiffEoi;
            if (compat)
                bitbuf |= uint64_t(src[pos++]) << bitcount;
            else
                bitbuf = (bitbuf << 8) | src[pos++];
            bitcount += 8;
        }
        bitcount -= nbits;
        if (compat) {
            const int code = int(bitbuf & ((1u << nbits) - 1));
            bitbuf >>= nbits;
            return code;
        }
        return int((bitbuf >> bitcount) & ((1u << nbits) - 1));
    };
    auto emit = [&](int code) {
        const int len = tab[code].length;
        int64_t end = out + len;
        int c = code;
        if (end > occ) {                    // the string runs past the strip
            for (int k = len - 1; k >= 0; --k, c = tab[c].prev)
                if (out + k < occ) dst[out + k] = tab[c].value;
            out = occ;
            return;
        }
        for (int64_t k = end - 1; k >= out; --k, c = tab[c].prev)
            dst[k] = tab[c].value;
        out = end;
    };
    while (out < occ) {
        int code = next_code();
        if (code == kTiffEoi) break;
        if (code == kTiffClear) {
            free_ent = kTiffFirst;
            nbits = 9;
            do {
                code = next_code();
            } while (code == kTiffClear);
            if (code == kTiffEoi) break;
            if (code > kTiffClear) return -1;
            dst[out++] = uint8_t(code);
            old = code;
            continue;
        }
        if (old < 0 || code > free_ent || free_ent >= kTiffCsize) return -1;
        Entry& e = tab[free_ent];
        e.prev = old;
        e.first = tab[old].first;
        e.length = tab[old].length + 1;
        e.value = code < free_ent ? tab[code].first : tab[old].first;
        if (++free_ent > (1 << nbits) - grow) {
            if (++nbits > 12) nbits = 12;
        }
        emit(code);
        old = code;
    }
    return out;
}

extern "C" int64_t lrt_lzw_gif(const uint8_t* src, int64_t n, int32_t bits,
                               int32_t interlace, uint8_t* dst, int32_t xsize,
                               int32_t ysize, int64_t chunk,
                               int32_t* state_out) {
    constexpr int kTable = 4096, kBuffer = 4096;
    static thread_local uint8_t data[kTable], buffer[kBuffer];
    static thread_local int32_t link[kTable];
    state_out[0] = 0;
    if (bits < 0 || bits > 12) {
        state_out[0] = -8;
        return -1;
    }
    const int clear = 1 << bits, end = clear + 1;
    int step = 1, repeat = 0, il = interlace ? 1 : 0;
    if (il) step = repeat = 8;
    int state = 1, next = 0, codesize = 0, codemask = 0;
    int bufferindex = kBuffer, blocksize = 0, bitcount = 0;
    int lastcode = 0;
    uint8_t lastdata = 0;
    uint32_t bitbuffer = 0;
    int x = 0, y = 0;
    int64_t ptr = 0, fed = chunk < n ? chunk : n;
    (void)repeat;
    auto feed = [&]() -> bool {             // false: the file has no more
        if (fed >= n) return false;
        fed = fed + chunk < n ? fed + chunk : n;
        return true;
    };
    auto newline = [&]() -> bool {          // false: the frame is complete
        x = 0;
        y += step;
        while (y >= ysize) {
            switch (il) {
                case 1: y = 4; il = 2; break;
                case 2: step = 4; y = 2; il = 3; break;
                case 3: step = 2; y = 1; il = 0; break;
                default: return false;
            }
        }
        return true;
    };
    for (;;) {
        if (state == 1) {
            next = clear + 2;
            codesize = bits + 1;
            codemask = (1 << codesize) - 1;
            bufferindex = kBuffer;
            state = 2;
        }
        const uint8_t* p;
        int i;
        if (bufferindex < kBuffer) {
            i = kBuffer - bufferindex;
            p = &buffer[bufferindex];
            bufferindex = kBuffer;
        } else {
            while (bitcount < codesize) {
                if (blocksize > 0) {
                    const int c = src[ptr++];
                    blocksize--;
                    bitbuffer |= uint32_t(c) << bitcount;
                    bitcount += 8;
                } else {
                    if (fed - ptr < 1 || fed - ptr < src[ptr] + 1) {
                        if (!feed()) return ptr;
                        continue;
                    }
                    blocksize = src[ptr];
                    ptr++;
                }
            }
            int c = int(bitbuffer & uint32_t(codemask));
            bitbuffer >>= codesize;
            bitcount -= codesize;
            if (c == clear) {
                if (state != 2) state = 1;
                continue;
            }
            if (c == end) {
                if (!feed()) return ptr;
                continue;
            }
            i = 1;
            p = &lastdata;
            if (state == 2) {
                if (c > clear) {
                    state_out[0] = -2;
                    return -1;
                }
                lastdata = uint8_t(c);
                lastcode = c;
                state = 3;
            } else {
                const int thiscode = c;
                if (c > next) {
                    state_out[0] = -2;
                    return -1;
                }
                if (c == next) {
                    if (bufferindex <= 0) {
                        state_out[0] = -2;
                        return -1;
                    }
                    buffer[--bufferindex] = lastdata;
                    c = lastcode;
                }
                while (c >= clear) {
                    if (bufferindex <= 0 || c >= kTable) {
                        state_out[0] = -2;
                        return -1;
                    }
                    buffer[--bufferindex] = data[c];
                    c = link[c];
                }
                lastdata = uint8_t(c);
                if (next < kTable) {
                    data[next] = uint8_t(c);
                    link[next] = lastcode;
                    if (next == codemask && codesize < 12) {
                        codesize++;
                        codemask = (1 << codesize) - 1;
                    }
                    next++;
                }
                lastcode = thiscode;
            }
        }
        if (y >= ysize) {
            state_out[0] = -1;
            return -1;
        }
        for (int k = 0; k < i; ++k) {
            dst[int64_t(y) * xsize + x] = p[k];
            if (++x >= xsize && !newline()) return -1;
        }
    }
}
