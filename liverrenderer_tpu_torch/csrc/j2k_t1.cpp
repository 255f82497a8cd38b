// JPEG 2000 tier-1 of liverrenderer_tpu_torch/io/j2k_t1.py, as OpenJPEG
// 2.5.4 codes it: the MQ coder and the three coding passes over a
// code-block's bit planes, decoding and encoding.  j2k_t1.py keeps the
// plain Python versions (`_t1_plain`, `_t1_enc_plain`) with the same
// contract; the tests hold them equal.  Compiled with the host C++
// compiler at first use (host_build.py) and called through ctypes.
//
// lrt_j2k_t1_decode(data, blocks, nblocks, segs, out) -> 0
//   blocks: 8 int64 a code-block (w, h, orientation 0 LL / 1 HL / 2 LH /
//   3 HH, style switches, numbps, bpno_plus_one, first segment, segments);
//   segs: 3 int64 a segment (offset in data, bytes, passes); out: each
//   block's w * h int32 in turn (OpenJPEG's t1->data: twice the magnitude
//   plus the midpoint of the last plane decoded, signed).
//
// lrt_j2k_t1_encode(coef, w, h, orient, style, out, cap, passes, info)
//   -> the code-block's bytes (or -needed when cap is too small)
//   coef: w * h int32; passes: 2 int64 a pass (cumulative rate,
//   terminated); info[0] numbps, info[1] passes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kLazy = 1, kReset = 2, kTermAll = 4, kVsc = 8, kPterm = 16,
              kSegSym = 32;
constexpr int kSc = 9, kMag = 14, kAgg = 17, kUni = 18, kNCtx = 19;

struct State {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

constexpr State kStates[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

struct Ctx {
  uint8_t st[kNCtx], mps[kNCtx];
  void reset() {
    std::memset(st, 0, sizeof st);
    std::memset(mps, 0, sizeof mps);
    st[kUni] = 46;
    st[kAgg] = 3;
    st[0] = 4;
  }
};

// the zero-coding context of (orientation, h, v, d): t1_init_ctxno_zc,
// the horizontal and vertical counts swapped for HL
int zc_table[4][3][3][5];

void init_zc() {
  for (int o = 0; o < 4; ++o)
    for (int h0 = 0; h0 < 3; ++h0)
      for (int v0 = 0; v0 < 3; ++v0)
        for (int d = 0; d < 5; ++d) {
          int h = o == 1 ? v0 : h0, v = o == 1 ? h0 : v0, n;
          if (o == 3) {
            int hv = h + v;
            if (d == 0) n = hv < 2 ? hv : 2;
            else if (d == 1) n = 3 + (hv < 2 ? hv : 2);
            else if (d == 2) n = hv == 0 ? 6 : 7;
            else n = 8;
          } else if (h == 0) {
            n = v == 0 ? (d == 0 ? 0 : d == 1 ? 1 : 2) : v == 1 ? 3 : 4;
          } else if (h == 1) {
            n = v == 0 ? (d == 0 ? 5 : 6) : 7;
          } else {
            n = 8;
          }
          zc_table[o][h0][v0][d] = n;
        }
}

// The states of a code-block with one sample of margin.
struct Planes {
  int w, h, W;
  bool vsc;
  std::vector<uint8_t> sig, neg, pi, mu;
  Planes(int w_, int h_, bool vsc_)
      : w(w_), h(h_), W(w_ + 2), vsc(vsc_),
        sig((h_ + 2) * (w_ + 2)), neg(sig.size()), pi(sig.size()),
        mu(sig.size()) {}
  bool south(int y) const { return !(vsc && (y & 3) == 3); }
  void counts(int i, int y, int* hh, int* vv, int* dd) const {
    const uint8_t* s = sig.data();
    bool so = south(y);
    *hh = s[i - 1] + s[i + 1];
    *vv = s[i - W] + (so ? s[i + W] : 0);
    *dd = s[i - W - 1] + s[i - W + 1] + (so ? s[i + W - 1] + s[i + W + 1] : 0);
  }
  bool any(int i, int y) const {
    int a, b, c;
    counts(i, y, &a, &b, &c);
    return a || b || c;
  }
  int contrib(int j) const { return sig[j] ? (neg[j] ? -1 : 1) : 0; }
  // Table D.3 -> context, and the xor bit in *xr
  int sign_ctx(int i, int y, int* xr) const {
    int hc = contrib(i - 1) + contrib(i + 1);
    int vc = contrib(i - W) + (south(y) ? contrib(i + W) : 0);
    hc = hc < -1 ? -1 : hc > 1 ? 1 : hc;
    vc = vc < -1 ? -1 : vc > 1 ? 1 : vc;
    if (hc == 0) {
      *xr = vc < 0;
      return kSc + (vc ? 1 : 0);
    }
    *xr = hc < 0;
    return kSc + 3 + hc * vc;
  }
  int mag_ctx(int i, int y) const {
    if (mu[i]) return kMag + 2;
    return kMag + (any(i, y) ? 1 : 0);
  }
  // the column's flags word is not zero
  bool busy(int k, int x) const {
    for (int y = k; y < k + 4; ++y) {
      int i = (y + 1) * W + x + 1;
      if (sig[i] || pi[i] || any(i, y)) return true;
    }
    return false;
  }
};

// ----------------------------------------------------------- decoding --
struct MQDec {
  const uint8_t* buf;
  int bp;
  uint32_t c = 0, a = 0;
  int ct = 0;
  void bytein() {
    uint32_t nxt = buf[bp + 1];
    if (buf[bp] == 0xFF) {
      if (nxt > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += nxt << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += nxt << 8;
      ct = 8;
    }
  }
  // buf holds the segment then 0xFF 0xFF
  void init(const uint8_t* b, int len, bool raw) {
    buf = b;
    bp = 0;
    if (raw) {  // opj_mqc_raw_init_dec leaves A as it was
      c = 0;
      ct = 0;
      return;
    }
    c = static_cast<uint32_t>(len == 0 ? 0xFF : b[0]) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  int decode(Ctx& cx, int k) {
    const State& s = kStates[cx.st[k]];
    int mps = cx.mps[k], d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {
      if (a < s.qe) {
        d = mps;
        cx.st[k] = s.nmps;
      } else {
        d = 1 - mps;
        cx.st[k] = s.nlps;
        cx.mps[k] = mps ^ s.sw;
      }
      a = s.qe;
    } else {
      c -= static_cast<uint32_t>(s.qe) << 16;
      if (a & 0x8000) return mps;
      if (a < s.qe) {
        d = 1 - mps;
        cx.st[k] = s.nlps;
        cx.mps[k] = mps ^ s.sw;
      } else {
        d = mps;
        cx.st[k] = s.nmps;
      }
    }
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
    return d;
  }
  int raw() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (buf[bp] > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = buf[bp++];
          ct = 7;
        }
      } else {
        c = buf[bp++];
        ct = 8;
      }
    }
    --ct;
    return (c >> ct) & 1;
  }
};

void decode_block(const uint8_t* data, const int64_t* blk,
                  const int64_t* segs, int32_t* out) {
  const int w = static_cast<int>(blk[0]), h = static_cast<int>(blk[1]);
  const int orient = static_cast<int>(blk[2]);
  const int sty = static_cast<int>(blk[3]);
  const int32_t nb4 = static_cast<int32_t>(static_cast<uint32_t>(blk[4])) - 4;
  int bpo = static_cast<int>(blk[5]);
  const int64_t first = blk[6], nseg = blk[7];
  Planes pl(w, h, sty & kVsc);
  const int W = pl.W;
  std::vector<int32_t> v(pl.sig.size());
  auto zc = zc_table[orient];
  Ctx cx;
  cx.reset();
  int passtype = 2;
  MQDec mq;
  std::vector<uint8_t> seg;
  auto significant = [&](int i, int ng, int32_t oph) {
    v[i] = ng ? -oph : oph;
    pl.sig[i] = 1;
    pl.neg[i] = static_cast<uint8_t>(ng);
  };
  for (int64_t sn = 0; sn < nseg; ++sn) {
    const int64_t* s = segs + 3 * (first + sn);
    const int len = static_cast<int>(s[1]);
    seg.assign(data + s[0], data + s[0] + len);
    seg.push_back(0xFF);
    seg.push_back(0xFF);
    const bool raw = bpo <= nb4 && passtype < 2 && (sty & kLazy);
    mq.init(seg.data(), len, raw);
    for (int64_t passno = 0; passno < s[2] && bpo >= 1; ++passno) {
      const int32_t one = 1 << bpo, half = one >> 1, oph = one | half;
      if (passtype == 0) {
        for (int k = 0; k < h; k += 4)
          for (int x = 0; x < w; ++x)
            for (int y = k; y < k + 4 && y < h; ++y) {
              int i = (y + 1) * W + x + 1, a, b, c;
              if (pl.sig[i] || pl.pi[i]) continue;
              pl.counts(i, y, &a, &b, &c);
              if (!(a || b || c)) continue;
              if (raw) {
                if (mq.raw()) significant(i, mq.raw(), oph);
              } else if (mq.decode(cx, zc[a][b][c])) {
                int xr, sc = pl.sign_ctx(i, y, &xr);
                significant(i, mq.decode(cx, sc) ^ xr, oph);
              }
              pl.pi[i] = 1;
            }
      } else if (passtype == 1) {
        for (int k = 0; k < h; k += 4)
          for (int x = 0; x < w; ++x)
            for (int y = k; y < k + 4 && y < h; ++y) {
              int i = (y + 1) * W + x + 1;
              if (!pl.sig[i] || pl.pi[i]) continue;
              int b = raw ? mq.raw() : mq.decode(cx, pl.mag_ctx(i, y));
              v[i] += (b ^ (v[i] < 0)) ? half : -half;
              pl.mu[i] = 1;
            }
      } else {
        for (int k = 0; k < h; k += 4)
          for (int x = 0; x < w; ++x) {
            const int rows = h - k < 4 ? h - k : 4;
            int start = 0;
            bool partial = false;
            if (rows == 4 && !pl.busy(k, x)) {
              if (!mq.decode(cx, kAgg)) continue;
              start = mq.decode(cx, kUni) << 1;
              start |= mq.decode(cx, kUni);
              partial = true;
            }
            for (int y = k + start; y < k + rows; ++y) {
              int i = (y + 1) * W + x + 1;
              if (!partial && (pl.sig[i] || pl.pi[i])) continue;
              bool hit = partial;
              if (!hit) {
                int a, b, c;
                pl.counts(i, y, &a, &b, &c);
                hit = mq.decode(cx, zc[a][b][c]);
              }
              if (hit) {
                int xr, sc = pl.sign_ctx(i, y, &xr);
                significant(i, mq.decode(cx, sc) ^ xr, oph);
              }
              partial = false;
            }
          }
        std::fill(pl.pi.begin(), pl.pi.end(), 0);
        if (sty & kSegSym)
          for (int r = 0; r < 4; ++r) mq.decode(cx, kUni);
      }
      if ((sty & kReset) && !raw) cx.reset();
      if (++passtype == 3) {
        passtype = 0;
        --bpo;
      }
    }
  }
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) out[y * w + x] = v[(y + 1) * W + x + 1];
}

// ----------------------------------------------------------- encoding --
constexpr int kBypassInit = -1;

struct MQEnc {
  std::vector<uint8_t> buf{0};  // buf[0]: the byte before the start
  int64_t bp = 0;
  uint32_t a = 0x8000, c = 0;
  int ct = 12;
  void put(uint32_t v) {
    if (bp + 2 >= static_cast<int64_t>(buf.size())) buf.resize(bp + 1024, 0);
    buf[bp] = static_cast<uint8_t>(v);
  }
  void byteout() {
    if (buf[bp] == 0xFF) {
      ++bp;
      put(c >> 20);
      c &= 0xFFFFF;
      ct = 7;
    } else if (!(c & 0x8000000)) {
      ++bp;
      put(c >> 19);
      c &= 0x7FFFF;
      ct = 8;
    } else {
      ++buf[bp];
      if (buf[bp] == 0xFF) {
        c &= 0x7FFFFFF;
        ++bp;
        put(c >> 20);
        c &= 0xFFFFF;
        ct = 7;
      } else {
        ++bp;
        put(c >> 19);
        c &= 0x7FFFF;
        ct = 8;
      }
    }
  }
  void renorm() {
    do {
      a <<= 1;
      c <<= 1;
      if (--ct == 0) byteout();
    } while (!(a & 0x8000));
  }
  void encode(Ctx& cx, int k, int d) {
    const State& s = kStates[cx.st[k]];
    int mps = cx.mps[k];
    a -= s.qe;
    if (d == mps) {
      if (a & 0x8000) {
        c += s.qe;
        return;
      }
      if (a < s.qe) a = s.qe;
      else c += s.qe;
      cx.st[k] = s.nmps;
    } else {
      if (a < s.qe) c += s.qe;
      else a = s.qe;
      cx.st[k] = s.nlps;
      cx.mps[k] = mps ^ s.sw;
    }
    renorm();
  }
  void flush() {
    uint32_t tempc = c + a;
    c |= 0xFFFF;
    if (c >= tempc) c -= 0x8000;
    c <<= ct;
    byteout();
    c <<= ct;
    byteout();
    if (buf[bp] != 0xFF) ++bp;
  }
  void erterm() {
    int k = 11 - ct + 1;
    while (k > 0) {
      c <<= ct;
      ct = 0;
      byteout();
      k -= ct;
    }
    if (buf[bp] != 0xFF) byteout();
  }
  void restart() {
    a = 0x8000;
    c = 0;
    ct = 12;
    --bp;
    if (buf[bp] == 0xFF) ct = 13;
  }
  void bypass_init() {
    c = 0;
    ct = kBypassInit;
  }
  void bypass(int d) {
    if (ct == kBypassInit) ct = 8;
    --ct;
    c += static_cast<uint32_t>(d) << ct;
    if (ct == 0) {
      put(c);
      ct = buf[bp] == 0xFF ? 7 : 8;
      ++bp;
      c = 0;
    }
  }
  int bypass_extra(bool erterm) const {
    uint8_t prev = buf[bp - 1];
    return (ct < 7 || (ct == 7 && (erterm || prev != 0xFF))) ? 1 : 0;
  }
  void bypass_flush(bool erterm) {
    uint8_t prev = buf[bp - 1];
    if (ct < 7 || (ct == 7 && (erterm || prev != 0xFF))) {
      uint32_t bit = 0;
      while (ct > 0) {
        --ct;
        c += bit << ct;
        bit = 1 - bit;
      }
      put(c);
      ++bp;
    } else if (ct == 7 && prev == 0xFF) {
      --bp;
    } else if (ct == 8 && !erterm && prev == 0x7F && buf[bp - 2] == 0xFF) {
      bp -= 2;
    }
  }
  int64_t numbytes() const { return bp - 1; }
};

bool is_term(int numbps, int sty, int bpno, int passtype) {
  if (passtype == 2 && bpno == 0) return true;
  if (sty & kTermAll) return true;
  if (sty & kLazy) {
    if (bpno == numbps - 4 && passtype == 2) return true;
    if (bpno < numbps - 4 && passtype > 0) return true;
  }
  return false;
}

}  // namespace

extern "C" int64_t lrt_j2k_t1_decode(const uint8_t* data,
                                     const int64_t* blocks, int64_t nblocks,
                                     const int64_t* segs, int32_t* out) {
  init_zc();
  int64_t off = 0;
  for (int64_t b = 0; b < nblocks; ++b) {
    const int64_t* blk = blocks + 8 * b;
    decode_block(data, blk, segs, out + off);
    off += blk[0] * blk[1];
  }
  return 0;
}

extern "C" int64_t lrt_j2k_t1_encode(const int32_t* coef, int w, int h,
                                     int orient, int sty, uint8_t* out,
                                     int64_t cap, int64_t* passes,
                                     int64_t* info) {
  init_zc();
  Planes pl(w, h, sty & kVsc);
  const int W = pl.W;
  std::vector<uint32_t> m(pl.sig.size());
  std::vector<uint8_t> ng(pl.sig.size());
  uint32_t top = 0;
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      int32_t v = coef[y * w + x];
      uint32_t a = v < 0 ? 0u - static_cast<uint32_t>(v) : v;
      m[(y + 1) * W + x + 1] = a;
      ng[(y + 1) * W + x + 1] = v < 0;
      if (a > top) top = a;
    }
  int numbps = 0;
  while (numbps < 32 && (top >> numbps)) ++numbps;
  info[0] = numbps;
  info[1] = 0;
  if (numbps == 0) return 0;
  auto zc = zc_table[orient];
  Ctx cx;
  cx.reset();
  MQEnc mq;
  const bool erterm = sty & kPterm;
  int bpno = numbps - 1, passtype = 2;
  int64_t np = 0;
  auto sign = [&](int i, int y, bool raw) {
    if (raw) {
      mq.bypass(ng[i]);
    } else {
      int xr, sc = pl.sign_ctx(i, y, &xr);
      mq.encode(cx, sc, ng[i] ^ xr);
    }
    pl.sig[i] = 1;
    pl.neg[i] = ng[i];
  };
  while (bpno >= 0) {
    const bool raw = bpno < numbps - 4 && passtype < 2 && (sty & kLazy);
    if (np && passes[2 * (np - 1) + 1]) {
      if (raw) mq.bypass_init();
      else mq.restart();
    }
    if (passtype == 0) {
      for (int k = 0; k < h; k += 4)
        for (int x = 0; x < w; ++x)
          for (int y = k; y < k + 4 && y < h; ++y) {
            int i = (y + 1) * W + x + 1, a, b, c;
            if (pl.sig[i] || pl.pi[i]) continue;
            pl.counts(i, y, &a, &b, &c);
            if (!(a || b || c)) continue;
            int v = (m[i] >> bpno) & 1;
            if (raw) mq.bypass(v);
            else mq.encode(cx, zc[a][b][c], v);
            if (v) sign(i, y, raw);
            pl.pi[i] = 1;
          }
    } else if (passtype == 1) {
      for (int k = 0; k < h; k += 4)
        for (int x = 0; x < w; ++x)
          for (int y = k; y < k + 4 && y < h; ++y) {
            int i = (y + 1) * W + x + 1;
            if (!pl.sig[i] || pl.pi[i]) continue;
            int v = (m[i] >> bpno) & 1;
            if (raw) mq.bypass(v);
            else mq.encode(cx, pl.mag_ctx(i, y), v);
            pl.mu[i] = 1;
          }
    } else {
      for (int k = 0; k < h; k += 4)
        for (int x = 0; x < w; ++x) {
          const int rows = h - k < 4 ? h - k : 4;
          int start = 0;
          bool agg = false;
          if (rows == 4 && !pl.busy(k, x)) {
            agg = true;
            start = 4;
            for (int r = 0; r < 4; ++r)
              if ((m[(k + r + 1) * W + x + 1] >> bpno) & 1) {
                start = r;
                break;
              }
            mq.encode(cx, kAgg, start != 4);
            if (start == 4) continue;
            mq.encode(cx, kUni, start >> 1);
            mq.encode(cx, kUni, start & 1);
          }
          for (int r = start; r < rows; ++r) {
            int y = k + r, i = (y + 1) * W + x + 1;
            if (agg && r == start) {
              sign(i, y, false);
              continue;
            }
            if (pl.sig[i] || pl.pi[i]) continue;
            int a, b, c;
            pl.counts(i, y, &a, &b, &c);
            int v = (m[i] >> bpno) & 1;
            mq.encode(cx, zc[a][b][c], v);
            if (v) sign(i, y, false);
          }
        }
      std::fill(pl.pi.begin(), pl.pi.end(), 0);
      if (sty & kSegSym) {
        mq.encode(cx, kUni, 1);
        mq.encode(cx, kUni, 0);
        mq.encode(cx, kUni, 1);
        mq.encode(cx, kUni, 0);
      }
    }
    int64_t* p = passes + 2 * np;
    if (is_term(numbps, sty, bpno, passtype)) {
      if (raw) mq.bypass_flush(erterm);
      else if (erterm) mq.erterm();
      else mq.flush();
      p[0] = mq.numbytes();
      p[1] = 1;
    } else {
      p[0] = mq.numbytes() + (raw ? mq.bypass_extra(erterm) : 3);
      p[1] = 0;
    }
    ++np;
    if (++passtype == 3) {
      passtype = 0;
      --bpno;
    }
    if (sty & kReset) cx.reset();
  }
  const int64_t n = mq.numbytes();
  int64_t last = n;
  for (int64_t k = np; k-- > 0;) {
    if (passes[2 * k] > last) passes[2 * k] = last;
    else last = passes[2 * k];
  }
  if (n > cap) return -n;
  std::memcpy(out, mq.buf.data() + 1, n);
  for (int64_t k = 0; k < np; ++k)
    if (passes[2 * k] > 1 && out[passes[2 * k] - 1] == 0xFF) --passes[2 * k];
  info[1] = np;
  return n;
}
