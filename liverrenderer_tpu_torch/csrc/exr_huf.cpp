// The Huffman decode loop of the OpenEXR PIZ codec, for
// liverrenderer_tpu_torch/io/exr.py (which builds the canonical code
// tables and keeps this loop's plain Python version, `_huf_decode_plain`).
// Compiled with the host C++ compiler at first use (host_build.py) and
// called through ctypes.
//
// The bit stream is read most significant bit first.  A code of length l
// has the value v of its l bits; it is the code of symbol
// sym[start[l] + v - first[l]] when first[l] <= v < first[l] + count[l]
// (OpenEXR's canonical codes: longer codes take the lower values, so a
// prefix-free stream matches one length only).  The symbol `rlc` is
// followed by 8 bits: the previous value repeats that many more times.
//
// Returns the number of values written on success (== nraw), or a
// negative code: -1 a code runs past nbits, -2 no code matches,
// -3 a run before any value, -4 more values than nraw, -5 fewer.

#include <cstdint>

extern "C" int64_t lrt_huf_decode(const int64_t* first, const int64_t* count,
                                  const int64_t* start, const int32_t* sym,
                                  int32_t max_len, const uint8_t* in,
                                  int64_t nbits, int32_t rlc, uint16_t* out,
                                  int64_t nraw) {
    int64_t pos = 0, o = 0;
    auto bit = [&](int64_t p) { return (in[p >> 3] >> (7 - (p & 7))) & 1; };
    while (pos < nbits) {
        uint64_t code = 0;
        int32_t s = -1;
        for (int32_t l = 1; l <= max_len; ++l) {
            if (pos >= nbits) return -1;
            code = (code << 1) | static_cast<uint64_t>(bit(pos++));
            const uint64_t f = static_cast<uint64_t>(first[l]);
            if (count[l] && code >= f
                && code - f < static_cast<uint64_t>(count[l])) {
                s = sym[start[l] + static_cast<int64_t>(code - f)];
                break;
            }
        }
        if (s < 0) return -2;
        if (s == rlc) {
            if (pos + 8 > nbits) return -1;
            int32_t cs = 0;
            for (int k = 0; k < 8; ++k) cs = (cs << 1) | bit(pos++);
            if (o == 0) return -3;
            if (o + cs > nraw) return -4;
            const uint16_t v = out[o - 1];
            for (int32_t k = 0; k < cs; ++k) out[o++] = v;
        } else {
            if (o >= nraw) return -4;
            out[o++] = static_cast<uint16_t>(s);
        }
    }
    return o == nraw ? o : -5;
}
