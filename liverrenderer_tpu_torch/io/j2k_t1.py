"""JPEG 2000 tier-1 (ISO 15444-1 Annex C and D) as OpenJPEG 2.5.4 codes
it: the MQ coder and the three coding passes over a code-block's bit
planes, both ways.

Decoding takes a code-block as tier-2 hands it over: its size, its
band's orientation (0 LL, 1 HL, 2 LH, 3 HH; the zero-coding context of
HL swaps the horizontal and vertical neighbour counts), the
code-block style switches, the bit planes the zero-bitplane tag tree
left (`numbps`), the plane the first cleanup pass starts from
(`bpno_plus_one`, ROI shift included) and its codeword segments, each
(bytes, passes).  Each segment is read as OpenJPEG reads it, with an
artificial 0xFF 0xFF behind its end; BYPASS segments are raw bits.  The
result is OpenJPEG's `t1->data`: each coefficient twice its magnitude
plus the half of the last plane decoded (midpoint reconstruction), with
its sign.

Encoding is OpenJPEG's opj_t1_encode_cblk on a code-block of integer
coefficients (Pillow's lossless save: no switches, one terminated pass at
the end): the passes, their cumulative rates and the bytes.  With the
switches it writes a valid stream in which each codeword segment is
coded on its own (the test composer's use).

The loops are `csrc/j2k_t1.cpp` (built by host_build.py at first use);
`_t1_plain` and `_t1_enc_plain` are their plain versions, held equal by
the tests.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

# code-block style switches (COD / COC SPcod byte 3)
LAZY, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32

# contexts: 9 zero coding, 5 sign coding, 3 magnitude refinement, run
# length, uniform
CTX_SC, CTX_MAG, CTX_AGG, CTX_UNI, N_CTX = 9, 14, 17, 18, 19

# the MQ coder's 47 probability states: (Qe, next MPS, next LPS, switch)
MQ_STATES = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0))


def _zc_table(orient: int) -> list:
    """t1_init_ctxno_zc: [h][v][d] -> the zero-coding context."""
    out = [[[0] * 5 for _ in range(3)] for _ in range(3)]
    for h0 in range(3):
        for v0 in range(3):
            for d in range(5):
                h, v = (v0, h0) if orient == 1 else (h0, v0)
                if orient == 3:
                    hv = h + v
                    if d == 0:
                        n = min(hv, 2)
                    elif d == 1:
                        n = 3 + min(hv, 2)
                    elif d == 2:
                        n = 6 if hv == 0 else 7
                    else:
                        n = 8
                elif h == 0:
                    n = (0 if d == 0 else 1 if d == 1 else 2) if v == 0 \
                        else 3 if v == 1 else 4
                elif h == 1:
                    n = (5 if d == 0 else 6) if v == 0 else 7
                else:
                    n = 8
                out[h0][v0][d] = n
    return out


ZC = [_zc_table(o) for o in range(4)]


def _sc(hc: int, vc: int) -> tuple:
    """Table D.3: the clamped horizontal and vertical sign contributions
    -> (context, the bit the decoded sign is xored with)."""
    if hc == 0:
        return CTX_SC + (1 if vc else 0), 1 if vc < 0 else 0
    return CTX_SC + 3 + hc * vc, 1 if hc < 0 else 0


# ------------------------------------------------------------ decoding ----
class _MQDec:
    """opj_mqc_init_dec / opj_mqc_decode on one segment, with the raw
    (BYPASS) reader of opj_mqc_raw_decode."""

    def __init__(self, data: bytes, raw: bool, a: int = 0):
        self.buf = bytes(data) + b"\xff\xff"
        self.bp = 0
        self.a = a                  # opj_mqc_raw_init_dec leaves A as it was
        if raw:
            self.c, self.ct = 0, 0
            return
        self.c = (0xFF if not data else self.buf[0]) << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _bytein(self):
        nxt = self.buf[self.bp + 1] if self.bp + 1 < len(self.buf) else 0xFF
        if self.buf[self.bp] == 0xFF:
            if nxt > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp += 1
                self.c += nxt << 9
                self.ct = 7
        else:
            self.bp += 1
            self.c += nxt << 8
            self.ct = 8

    def decode(self, ctx: list, cx: int) -> int:
        st, mps = ctx[cx]
        qe, nmps, nlps, sw = MQ_STATES[st]
        self.a -= qe
        if (self.c >> 16) < qe:
            if self.a < qe:
                d = mps
                ctx[cx] = (nmps, mps)
            else:
                d = 1 - mps
                ctx[cx] = (nlps, mps ^ sw)
            self.a = qe
        else:
            self.c -= qe << 16
            if self.a & 0x8000:
                return mps
            if self.a < qe:
                d = 1 - mps
                ctx[cx] = (nlps, mps ^ sw)
            else:
                d = mps
                ctx[cx] = (nmps, mps)
        while True:                                       # renormalise
            if self.ct == 0:
                self._bytein()
            self.a <<= 1
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a >= 0x8000:
                return d

    def raw(self) -> int:
        if self.ct == 0:
            if self.c == 0xFF:
                if self.buf[self.bp] > 0x8F:
                    self.c, self.ct = 0xFF, 8
                else:
                    self.c = self.buf[self.bp]
                    self.bp += 1
                    self.ct = 7
            else:
                self.c = self.buf[self.bp]
                self.bp += 1
                self.ct = 8
        self.ct -= 1
        return (self.c >> self.ct) & 1


def _reset_ctx() -> list:
    ctx = [(0, 0)] * N_CTX
    ctx[CTX_UNI], ctx[CTX_AGG], ctx[0] = (46, 0), (3, 0), (4, 0)
    return ctx


class _Planes:
    """The significance, sign, visited and refined states of a
    code-block, one sample of margin around it, and the neighbourhood
    counts its contexts read (VSC: the row below a stripe is unseen)."""

    def __init__(self, w: int, h: int, vsc: bool):
        self.w, self.h, self.W = w, h, w + 2
        n = (h + 2) * (w + 2)
        self.sig, self.neg = bytearray(n), bytearray(n)
        self.pi, self.mu = bytearray(n), bytearray(n)
        self.vsc = vsc

    def counts(self, i: int, y: int) -> tuple:
        s, W = self.sig, self.W
        south = not (self.vsc and (y & 3) == 3)
        h = s[i - 1] + s[i + 1]
        v = s[i - W] + (s[i + W] if south else 0)
        d = s[i - W - 1] + s[i - W + 1]
        if south:
            d += s[i + W - 1] + s[i + W + 1]
        return h, v, d

    def sign_ctx(self, i: int, y: int) -> tuple:
        s, n, W = self.sig, self.neg, self.W

        def c(j):
            return (-1 if n[j] else 1) if s[j] else 0
        south = 0 if self.vsc and (y & 3) == 3 else c(i + W)
        hc = max(-1, min(1, c(i - 1) + c(i + 1)))
        vc = max(-1, min(1, c(i - W) + south))
        return _sc(hc, vc)

    def mag_ctx(self, i: int, y: int) -> int:
        if self.mu[i]:
            return CTX_MAG + 2
        return CTX_MAG + (1 if any(self.counts(i, y)) else 0)

    def order(self):
        """The scan: stripes of four rows, column by column -> (stripe
        top, x, rows of the column)."""
        for k in range(0, self.h, 4):
            for x in range(self.w):
                yield k, x, range(k, min(k + 4, self.h))


def _t1_plain(w: int, h: int, orient: int, cblksty: int, numbps: int,
              bpno_plus_one: int, segs) -> np.ndarray:
    """opj_t1_decode_cblk -> (h, w) int32 (the plain version of
    csrc/j2k_t1.cpp's decode)."""
    pl = _Planes(w, h, bool(cblksty & VSC))
    W = pl.W
    data = [0] * ((h + 2) * W)
    zc = ZC[orient]
    ctx = _reset_ctx()
    passtype = 2
    nb4 = _i32(numbps) - 4
    a = 0

    def significant(i, neg, oph):
        data[i] = -oph if neg else oph
        pl.sig[i], pl.neg[i] = 1, neg

    for seg, npasses in segs:
        raw = bpno_plus_one <= nb4 and passtype < 2 and bool(cblksty & LAZY)
        mq = _MQDec(seg, raw, a)
        passno = 0
        while passno < npasses and bpno_plus_one >= 1:
            one = 1 << bpno_plus_one
            half = one >> 1
            oph = one | half
            if passtype == 0:                     # significance propagation
                for _, x, rows in pl.order():
                    for y in rows:
                        i = (y + 1) * W + x + 1
                        if pl.sig[i] or pl.pi[i]:
                            continue
                        hh, vv, dd = pl.counts(i, y)
                        if not (hh or vv or dd):
                            continue
                        if raw:
                            if mq.raw():
                                significant(i, mq.raw(), oph)
                        elif mq.decode(ctx, zc[hh][vv][dd]):
                            cx, xr = pl.sign_ctx(i, y)
                            significant(i, mq.decode(ctx, cx) ^ xr, oph)
                        pl.pi[i] = 1
            elif passtype == 1:                   # magnitude refinement
                for _, x, rows in pl.order():
                    for y in rows:
                        i = (y + 1) * W + x + 1
                        if not pl.sig[i] or pl.pi[i]:
                            continue
                        v = mq.raw() if raw else \
                            mq.decode(ctx, pl.mag_ctx(i, y))
                        data[i] += half if v ^ (data[i] < 0) else -half
                        pl.mu[i] = 1
            else:                                 # cleanup
                for k, x, rows in pl.order():
                    start = 0
                    partial = False
                    if len(rows) == 4 and not _busy(pl, k, x):
                        if not mq.decode(ctx, CTX_AGG):
                            continue
                        start = mq.decode(ctx, CTX_UNI) << 1
                        start |= mq.decode(ctx, CTX_UNI)
                        partial = True
                    for y in rows[start:]:
                        i = (y + 1) * W + x + 1
                        if not partial and (pl.sig[i] or pl.pi[i]):
                            continue
                        if not partial:
                            hh, vv, dd = pl.counts(i, y)
                        if partial or mq.decode(ctx, zc[hh][vv][dd]):
                            cx, xr = pl.sign_ctx(i, y)
                            significant(i, mq.decode(ctx, cx) ^ xr, oph)
                        partial = False
                pl.pi[:] = bytes(len(pl.pi))
                if cblksty & SEGSYM:
                    for _ in range(4):
                        mq.decode(ctx, CTX_UNI)
            if cblksty & RESET and not raw:
                ctx = _reset_ctx()
            passtype += 1
            if passtype == 3:
                passtype = 0
                bpno_plus_one -= 1
            passno += 1
        a = mq.a
    out = np.array(data, np.int64).reshape(h + 2, W)[1:-1, 1:-1]
    return out.astype(np.int32)


def _busy(pl: _Planes, k: int, x: int) -> bool:
    """The column's flags word is not zero: one of its four samples, or
    one of their neighbours, is significant or visited."""
    W = pl.W
    for y in range(k, k + 4):
        i = (y + 1) * W + x + 1
        if pl.sig[i] or pl.pi[i] or any(pl.counts(i, y)):
            return True
    return False


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v & 0x80000000 else v


# ------------------------------------------------------------ encoding ----
_BYPASS_INIT = -1


class _MQEnc:
    """opj_mqc_* encoding: index 0 of `buf` is the byte before the start
    (OpenJPEG's bp = start - 1), so numbytes is bp - 1."""

    def __init__(self):
        self.buf = bytearray(1)
        self.bp = 0
        self.a, self.c, self.ct = 0x8000, 0, 12

    def _put(self, v: int):
        if self.bp >= len(self.buf):
            self.buf.extend(bytes(self.bp - len(self.buf) + 64))
        self.buf[self.bp] = v & 0xFF

    def byteout(self):
        if self.buf[self.bp] == 0xFF:
            self.bp += 1
            self._put(self.c >> 20)
            self.c &= 0xFFFFF
            self.ct = 7
        elif not self.c & 0x8000000:
            self.bp += 1
            self._put(self.c >> 19)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            self.buf[self.bp] += 1
            if self.buf[self.bp] == 0xFF:
                self.c &= 0x7FFFFFF
                self.bp += 1
                self._put(self.c >> 20)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                self.bp += 1
                self._put(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct = 8

    def _renorm(self):
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self.byteout()
            if self.a & 0x8000:
                return

    def encode(self, ctx: list, cx: int, d: int):
        st, mps = ctx[cx]
        qe, nmps, nlps, sw = MQ_STATES[st]
        self.a -= qe
        if d == mps:
            if self.a & 0x8000:
                self.c += qe
                return
            if self.a < qe:
                self.a = qe
            else:
                self.c += qe
            ctx[cx] = (nmps, mps)
        else:
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            ctx[cx] = (nlps, mps ^ sw)
        self._renorm()

    def flush(self):
        tempc = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c <<= self.ct
        self.byteout()
        self.c <<= self.ct
        self.byteout()
        if self.buf[self.bp] != 0xFF:
            self.bp += 1

    def erterm(self):
        k = 11 - self.ct + 1
        while k > 0:
            self.c <<= self.ct
            self.ct = 0
            self.byteout()
            k -= self.ct
        if self.buf[self.bp] != 0xFF:
            self.byteout()

    def restart(self):
        self.a, self.c, self.ct = 0x8000, 0, 12
        self.bp -= 1
        if self.buf[self.bp] == 0xFF:
            self.ct = 13

    def bypass_init(self):
        self.c, self.ct = 0, _BYPASS_INIT

    def bypass(self, d: int):
        if self.ct == _BYPASS_INIT:
            self.ct = 8
        self.ct -= 1
        self.c += d << self.ct
        if self.ct == 0:
            self._put(self.c)
            self.ct = 7 if self.buf[self.bp] == 0xFF else 8
            self.bp += 1
            self.c = 0

    def bypass_extra(self, erterm: bool) -> int:
        prev = self.buf[self.bp - 1]
        return 1 if self.ct < 7 or (self.ct == 7 and (erterm or prev != 0xFF)) \
            else 0

    def bypass_flush(self, erterm: bool):
        prev = self.buf[self.bp - 1]
        if self.ct < 7 or (self.ct == 7 and (erterm or prev != 0xFF)):
            bit = 0
            while self.ct > 0:
                self.ct -= 1
                self.c += bit << self.ct
                bit = 1 - bit
            self._put(self.c)
            self.bp += 1
        elif self.ct == 7 and prev == 0xFF:
            self.bp -= 1
        elif self.ct == 8 and not erterm and prev == 0x7F \
                and self.buf[self.bp - 2] == 0xFF:
            self.bp -= 2

    def numbytes(self) -> int:
        return self.bp - 1


def _is_term(numbps: int, cblksty: int, bpno: int, passtype: int) -> bool:
    """opj_t1_enc_is_term_pass."""
    if passtype == 2 and bpno == 0:
        return True
    if cblksty & TERMALL:
        return True
    if cblksty & LAZY:
        if bpno == numbps - 4 and passtype == 2:
            return True
        if bpno < numbps - 4 and passtype > 0:
            return True
    return False


def _t1_enc_plain(coef: np.ndarray, orient: int, cblksty: int = 0):
    """opj_t1_encode_cblk on (h, w) integer coefficients -> (numbps,
    [(cumulative rate, terminated)] a pass, the code-block's bytes); the
    plain version of csrc/j2k_t1.cpp's encode."""
    h, w = coef.shape
    mag = np.abs(coef.astype(np.int64))
    top = int(mag.max()) if mag.size else 0
    numbps = top.bit_length()
    if numbps == 0:
        return 0, [], b""
    pl = _Planes(w, h, bool(cblksty & VSC))
    W = pl.W
    m = [0] * ((h + 2) * W)
    neg = [0] * ((h + 2) * W)
    for y in range(h):
        for x in range(w):
            m[(y + 1) * W + x + 1] = int(mag[y, x])
            neg[(y + 1) * W + x + 1] = 1 if coef[y, x] < 0 else 0
    zc = ZC[orient]
    ctx = _reset_ctx()
    mq = _MQEnc()
    passes = []
    bpno, passtype = numbps - 1, 2
    erterm = bool(cblksty & PTERM)

    def sign(i, y, raw):
        if raw:
            mq.bypass(neg[i])
        else:
            cx, xr = pl.sign_ctx(i, y)
            mq.encode(ctx, cx, neg[i] ^ xr)
        pl.sig[i], pl.neg[i] = 1, neg[i]

    while bpno >= 0:
        raw = bpno < numbps - 4 and passtype < 2 and bool(cblksty & LAZY)
        if passes and passes[-1][1]:
            if raw:
                mq.bypass_init()
            else:
                mq.restart()
        if passtype == 0:
            for _, x, rows in pl.order():
                for y in rows:
                    i = (y + 1) * W + x + 1
                    if pl.sig[i] or pl.pi[i]:
                        continue
                    hh, vv, dd = pl.counts(i, y)
                    if not (hh or vv or dd):
                        continue
                    v = (m[i] >> bpno) & 1
                    if raw:
                        mq.bypass(v)
                    else:
                        mq.encode(ctx, zc[hh][vv][dd], v)
                    if v:
                        sign(i, y, raw)
                    pl.pi[i] = 1
        elif passtype == 1:
            for _, x, rows in pl.order():
                for y in rows:
                    i = (y + 1) * W + x + 1
                    if not pl.sig[i] or pl.pi[i]:
                        continue
                    v = (m[i] >> bpno) & 1
                    if raw:
                        mq.bypass(v)
                    else:
                        mq.encode(ctx, pl.mag_ctx(i, y), v)
                    pl.mu[i] = 1
        else:
            for k, x, rows in pl.order():
                start, agg = 0, False
                if len(rows) == 4 and not _busy(pl, k, x):
                    agg = True
                    start = 4
                    for r, y in enumerate(rows):
                        if (m[(y + 1) * W + x + 1] >> bpno) & 1:
                            start = r
                            break
                    mq.encode(ctx, CTX_AGG, int(start != 4))
                    if start == 4:
                        continue
                    mq.encode(ctx, CTX_UNI, start >> 1)
                    mq.encode(ctx, CTX_UNI, start & 1)
                for r in range(start, len(rows)):
                    y = rows[r]
                    i = (y + 1) * W + x + 1
                    if agg and r == start:
                        sign(i, y, False)
                        continue
                    if pl.sig[i] or pl.pi[i]:
                        continue
                    hh, vv, dd = pl.counts(i, y)
                    v = (m[i] >> bpno) & 1
                    mq.encode(ctx, zc[hh][vv][dd], v)
                    if v:
                        sign(i, y, False)
            pl.pi[:] = bytes(len(pl.pi))
            if cblksty & SEGSYM:
                for b in (1, 0, 1, 0):
                    mq.encode(ctx, CTX_UNI, b)
        if _is_term(numbps, cblksty, bpno, passtype):
            if raw:
                mq.bypass_flush(erterm)
            elif erterm:
                mq.erterm()
            else:
                mq.flush()
            passes.append([mq.numbytes(), True])
        else:
            extra = mq.bypass_extra(erterm) if raw else 3
            passes.append([mq.numbytes() + extra, False])
        passtype += 1
        if passtype == 3:
            passtype = 0
            bpno -= 1
        if cblksty & RESET:
            ctx = _reset_ctx()
    last = mq.numbytes()
    for p in reversed(passes):
        if p[0] > last:
            p[0] = last
        else:
            last = p[0]
    data = bytes(mq.buf[1:1 + mq.numbytes()])
    for p in passes:
        if p[0] > 1 and data[p[0] - 1] == 0xFF:
            p[0] -= 1
    return numbps, [tuple(p) for p in passes], data


# ------------------------------------------------------- the C++ loops ----
_SRC = Path(__file__).resolve().parents[1] / "csrc" / "j2k_t1.cpp"
_LIB = None


def library():
    """Build (once per source hash) and load csrc/j2k_t1.cpp; raises if
    the compiler fails."""
    global _LIB
    if _LIB is None:
        from ..host_build import BUILD_DIR, compile_shared
        info = compile_shared(_SRC, BUILD_DIR, "JPEG 2000 tier-1")
        lib = ctypes.CDLL(info["path"])
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        lib.lrt_j2k_t1_decode.argtypes = [p, p, i64, p, p]
        lib.lrt_j2k_t1_decode.restype = i64
        lib.lrt_j2k_t1_encode.argtypes = [p, i32, i32, i32, i32, p, i64, p,
                                          p]
        lib.lrt_j2k_t1_encode.restype = i64
        _LIB = lib
    return _LIB


def decode_blocks(blocks) -> list:
    """csrc/j2k_t1.cpp's decode on each (w, h, orient, cblksty, numbps,
    bpno_plus_one, [(bytes, passes)]) -> [(h, w) int32]."""
    if not blocks:
        return []
    meta = np.zeros((len(blocks), 8), np.int64)
    segs, chunks, off = [], [], 0
    for k, (w, h, orient, sty, numbps, bpo, sl) in enumerate(blocks):
        meta[k] = (w, h, orient, sty, numbps, bpo, len(segs), len(sl))
        for data, npasses in sl:
            segs.append((off, len(data), npasses))
            chunks.append(data)
            off += len(data)
    data = np.frombuffer(b"".join(chunks) + b"\0", np.uint8)
    seg = np.array(segs or [(0, 0, 0)], np.int64)
    sizes = meta[:, 0] * meta[:, 1]
    out = np.zeros(int(sizes.sum()) + 1, np.int32)
    library().lrt_j2k_t1_decode(data.ctypes.data, meta.ctypes.data,
                                len(blocks), seg.ctypes.data,
                                out.ctypes.data)
    ends = np.cumsum(sizes)
    return [out[e - n:e].reshape(b[1], b[0])
            for e, n, b in zip(ends, sizes, blocks)]


def encode_block(coef: np.ndarray, orient: int, cblksty: int = 0):
    """csrc/j2k_t1.cpp's encode -> what _t1_enc_plain returns."""
    h, w = coef.shape
    c = np.ascontiguousarray(coef, np.int32)
    cap = w * h * 8 + 4096
    while True:
        out = np.zeros(cap, np.uint8)
        passes = np.zeros((96, 2), np.int64)
        info = np.zeros(2, np.int64)
        n = library().lrt_j2k_t1_encode(c.ctypes.data, w, h, orient, cblksty,
                                        out.ctypes.data, cap,
                                        passes.ctypes.data, info.ctypes.data)
        if n >= 0:
            break
        cap = -n
    return int(info[0]), [(int(r), bool(t)) for r, t in
                          passes[:int(info[1])]], out[:n].tobytes()
