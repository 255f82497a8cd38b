"""JPEG and JPEG-in-TIFF files that Pillow cannot write, for the port's
tests (numpy and the port's own JPEG helpers; no JAX, no PIL):

- `arith_jpeg`: a T.81 Annex D arithmetic encoder (libjpeg's jcarith.c
  procedures) for sequential (SOF9) and progressive (SOF10) files, with
  restart intervals and a DAC conditioning segment;
- `lossless_jpeg`: a lossless (SOF3) Huffman encoder, predictors 1-7, the
  point transform and restart intervals;
- `huffman_jpeg`: a baseline Huffman writer for any component count
  (an Adobe YCCK or CMYK file: `adobe=2` or `0`);
- `scans_cut`: a progressive file cut after its first n scans, then EOI;
- `tiff_jpeg` and `tiff_ojpeg`: compression 7 TIFFs (strips or tiles,
  JPEGTables, RGB, grey and YCbCr at 4:2:0 / 4:2:2) and compression 6
  files whose strip is a whole JPEG stream, with or without
  JPEGInterchangeFormat pointing at it;
- `tiff_ycbcr`: an uncompressed, LZW, Deflate or PackBits YCbCr TIFF in
  libtiff's subsampled block layout.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from liverrenderer_tpu_torch.io import jpeg
from liverrenderer_tpu_torch.io.jpeg_arith import ARITAB
import torch_raster_files as rf

ZZ = jpeg.ZIGZAG


# ------------------------------------------------------- coefficients ----
def frame_blocks(planes, sampling, quality=75):
    """Component planes (full size, uint8) and their (h, v) sampling ->
    (qtables, per component (mcuy * v, mcux * h, 64) zig-zag quantized
    coefficients, mcux, mcuy): box-downsampled, edge-padded to whole MCUs,
    islow forward DCT."""
    H, W = planes[0].shape
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    lum, chroma = jpeg.quality_tables(quality)
    qts, coefs = [], []
    for ci, (p, (h, v)) in enumerate(zip(planes, sampling)):
        fh, fv = hmax // h, vmax // v
        p = np.pad(p.astype(np.int64), ((0, mcuy * 8 * vmax - H),
                                        (0, mcux * 8 * hmax - W)), "edge")
        d = p.reshape(p.shape[0] // fv, fv, p.shape[1] // fh, fh) \
            .mean((1, 3)).round().astype(np.int64)
        rows, cols = mcuy * v, mcux * h
        blocks = d.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3) \
            .reshape(-1, 8, 8)
        q = lum if ci == 0 else chroma
        coefs.append(jpeg.fdct_quantize(blocks, q).reshape(rows, cols, 64))
        qts.append(q)
    return qts, coefs, mcux, mcuy


def _own_blocks(coefs, ci, W, H, sampling):
    """A non-interleaved scan's blocks: the component's own extent."""
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    h, v = sampling[ci]
    bw = -(-(-(-W * h // hmax)) // 8)
    bh = -(-(-(-H * v // vmax)) // 8)
    return [coefs[ci][by, bx] for by in range(bh) for bx in range(bw)]


# ---------------------------------------------------- arithmetic coder ----
class ArithEncoder:
    """jcarith.c's arith_encode and finish_pass (T.81 D.1)."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1

    def _emit(self, b):
        self.out.append(b)

    def _flush_zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def _out_byte(self, temp):
        if temp > 0xFF:
            if self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer)
            if self.sc:
                self._flush_zeros()
                while self.sc:
                    self._emit(0xFF)
                    self._emit(0)
                    self.sc -= 1
            self.buffer = temp & 0xFF

    def encode(self, st: bytearray, i: int, val: int):
        sv = st[i]
        qe = int(ARITAB[sv & 0x7F])
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._out_byte(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer)
            if self.sc:
                self._flush_zeros()
                while self.sc:
                    self._emit(0xFF)
                    self._emit(0)
                    self.sc -= 1
        if self.c & 0x7FFF800:
            self._flush_zeros()
            b = (self.c >> 19) & 0xFF
            self._emit(b)
            if b == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self._emit(b)
                if b == 0xFF:
                    self._emit(0)


class _ArithScan:
    """One scan's statistics and encoding procedures (jcarith.c)."""

    def __init__(self, cond, dct, act, prog, ss, ah):
        self.e = ArithEncoder()
        self.cond, self.dct, self.act = cond, dct, act
        self.prog, self.ss, self.ah = prog, ss, ah
        self.fixed = bytearray([113])
        self.reset_stats()

    def reset_stats(self):
        self.dc_stats = [bytearray(64) for _ in range(16)]
        self.ac_stats = [bytearray(256) for _ in range(16)]
        self.last_dc = [0] * 4
        self.dc_ctx = [0] * 4

    def _magnitude(self, stats, st, v, k=None, tbl=0):
        """F.8 and F.9 for |v| - 1 = v (DC when k is None)."""
        e = self.e
        m = 0
        if v:
            e.encode(stats, st, 1)
            m = 1
            v2 = v
            if k is None:
                st = 20
                v2 >>= 1
                while v2:
                    e.encode(stats, st, 1)
                    m <<= 1
                    st += 1
                    v2 >>= 1
            else:
                v2 >>= 1
                if v2:
                    e.encode(stats, st, 1)
                    m <<= 1
                    st = 189 if k <= self.cond[tbl][2] else 217
                    v2 >>= 1
                    while v2:
                        e.encode(stats, st, 1)
                        m <<= 1
                        st += 1
                        v2 >>= 1
        e.encode(stats, st, 0)
        st += 14
        m >>= 1
        while m:
            e.encode(stats, st, 1 if m & v else 0)
            m >>= 1

    def dc(self, ci, value):
        e, tbl = self.e, self.dct[ci]
        stats = self.dc_stats[tbl]
        s0 = self.dc_ctx[ci]
        v = value - self.last_dc[ci]
        if v == 0:
            e.encode(stats, s0, 0)
            self.dc_ctx[ci] = 0
            return
        self.last_dc[ci] = value
        e.encode(stats, s0, 1)
        if v > 0:
            e.encode(stats, s0 + 1, 0)
            st = s0 + 2
            self.dc_ctx[ci] = 4
        else:
            v = -v
            e.encode(stats, s0 + 1, 1)
            st = s0 + 3
            self.dc_ctx[ci] = 8
        v -= 1
        m = 0
        if v:
            m = 1 << (v.bit_length() - 1)
        lo = (1 << self.cond[tbl][0]) >> 1
        hi = (1 << self.cond[tbl][1]) >> 1
        self._magnitude(stats, st, v)
        if m < lo:
            self.dc_ctx[ci] = 0
        elif m > hi:
            self.dc_ctx[ci] += 8

    def ac(self, ci, c, ss, se):
        """F.5 (AC first / sequential) over c[ss..se], already shifted."""
        e, tbl = self.e, self.act[ci]
        stats = self.ac_stats[tbl]
        ke = se
        while ke > 0 and c[ke] == 0:
            ke -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            e.encode(stats, st, 0)
            while c[k] == 0:
                e.encode(stats, st + 1, 0)
                st += 3
                k += 1
            e.encode(stats, st + 1, 1)
            v = int(c[k])
            e.encode(self.fixed, 0, 1 if v < 0 else 0)
            self._magnitude(stats, st + 2, abs(v) - 1, k, tbl)
            k += 1
        if k <= se:
            e.encode(stats, 3 * (k - 1), 1)

    def ac_refine(self, ci, c, ss, se, al):
        """G.10 over the coefficients c (before the point transform)."""
        e, tbl = self.e, self.act[ci]
        stats = self.ac_stats[tbl]
        mag = np.abs(c.astype(np.int64))
        ke = se
        while ke > 0 and (mag[ke] >> al) == 0:
            ke -= 1
        kex = ke
        while kex > 0 and (mag[kex] >> (al + 1)) == 0:
            kex -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            if k > kex:
                e.encode(stats, st, 0)
            while True:
                v = int(mag[k]) >> al
                if v:
                    if v >> 1:
                        e.encode(stats, st + 2, v & 1)
                    else:
                        e.encode(stats, st + 1, 1)
                        e.encode(self.fixed, 0, 1 if c[k] < 0 else 0)
                    break
                e.encode(stats, st + 1, 0)
                st += 3
                k += 1
            k += 1
        if k <= se:
            e.encode(stats, 3 * (k - 1), 1)


def _shift(v, al):
    """A coefficient's point transform: magnitude >> al, sign kept."""
    return -((-v) >> al) if v < 0 else v >> al


def arith_jpeg(planes, sampling=((2, 2), (1, 1), (1, 1)), quality=75,
               progressive=False, restart=0, dac=None, scans=None,
               jfif=True, ids=None):
    """Component planes -> an arithmetic-coded file (SOF9, or SOF10 with
    `scans`: a list of (components, Ss, Se, Ah, Al), default libjpeg's
    jpeg_simple_progression).  dac: {(class, table): value} for a DAC
    segment (class 0 DC: L | U << 4; class 1 AC: Kx)."""
    planes = [np.asarray(p) for p in planes]
    H, W = planes[0].shape
    nc = len(planes)
    sampling = [tuple(s) for s in sampling[:nc]] if nc > 1 else [(1, 1)]
    qts, coefs, mcux, mcuy = frame_blocks(planes, sampling, quality)
    cond = [[0, 1, 5] for _ in range(16)]
    for (cls, tbl), val in (dac or {}).items():
        if cls == 0:
            cond[tbl][:2] = [val & 15, val >> 4]
        else:
            cond[tbl][2] = val
    tq = [0] + [1] * (nc - 1)
    if scans is None:
        scans = [(list(range(nc)), 0, 0, 0, 0)] if not progressive else \
            _simple_progression(nc)
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    for t in sorted(set(tq)):
        out += b"\xff\xdb\x00\x43" + bytes([t]) \
            + bytes(qts[tq.index(t)][ZZ].astype(np.uint8))
    sof = 0xCA if progressive else 0xC9
    out += bytes([0xFF, sof]) + struct.pack(">HBHHB", 8 + 3 * nc, 8, H, W, nc)
    ids = ids or list(range(1, nc + 1))
    for ci in range(nc):
        h, v = sampling[ci]
        out += bytes([ids[ci], (h << 4) | v, tq[ci]])
    if dac:
        body = b"".join(bytes([(cls << 4) | tbl, val])
                        for (cls, tbl), val in dac.items())
        out += b"\xff\xcc" + struct.pack(">H", 2 + len(body)) + body
    if restart:
        out += b"\xff\xdd\x00\x04" + struct.pack(">H", restart)
    for comps, ss, se, ah, al in scans:
        out += b"\xff\xda" + struct.pack(">HB", 6 + 2 * len(comps),
                                         len(comps))
        for ci in comps:
            out += bytes([ids[ci], (tq[ci] << 4) | tq[ci]])
        out += bytes([ss, se, (ah << 4) | al])
        out += _arith_scan(coefs, sampling, mcux, mcuy, comps, ss, se, ah,
                           al, progressive, restart, cond, tq, W, H)
    out += b"\xff\xd9"
    return bytes(out)


def _simple_progression(nc):
    """jcparam.c jpeg_simple_progression for YCbCr (3) or grey (1)."""
    if nc == 3:
        return [([0, 1, 2], 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([2], 1, 63, 0, 1),
                ([1], 1, 63, 0, 1), ([0], 6, 63, 0, 2), ([0], 1, 63, 2, 1),
                ([0, 1, 2], 0, 0, 1, 0), ([2], 1, 63, 1, 0),
                ([1], 1, 63, 1, 0), ([0], 1, 63, 1, 0)]
    scans = [([ci for ci in range(nc)], 0, 0, 0, 1)]
    for ci in range(nc):
        scans += [([ci], 1, 5, 0, 2), ([ci], 6, 63, 0, 2), ([ci], 1, 63, 2, 1)]
    scans.append((list(range(nc)), 0, 0, 1, 0))
    scans += [([ci], 1, 63, 1, 0) for ci in range(nc)]
    return scans


def _arith_scan(coefs, sampling, mcux, mcuy, comps, ss, se, ah, al, prog,
                restart, cond, tq, W, H):
    sc = _ArithScan(cond, {i: tq[c] for i, c in enumerate(comps)},
                    {i: tq[c] for i, c in enumerate(comps)}, prog, ss, ah)
    if len(comps) == 1:
        units = [[(0, b)] for b in _own_blocks(coefs, comps[0], W, H,
                                               sampling)]
    else:
        units = []
        for m in range(mcux * mcuy):
            my, mx = divmod(m, mcux)
            unit = []
            for i, ci in enumerate(comps):
                h, v = sampling[ci]
                unit += [(i, coefs[ci][my * v + vy, mx * h + hx])
                         for vy in range(v) for hx in range(h)]
            units.append(unit)
    data = bytearray()
    to_go, rst = restart, 0
    for unit in units:
        if restart:
            if to_go == 0:
                sc.e.finish()
                data += sc.e.out + bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) & 7
                sc.e.out = bytearray()
                sc.e.reset()
                sc.reset_stats()
                to_go = restart
            to_go -= 1
        for i, c in unit:
            if not prog:
                sc.dc(i, int(c[0]))
                sc.ac(i, c, 1, 63)
            elif ss == 0 and ah == 0:
                sc.dc(i, int(c[0]) >> al)
            elif ss == 0:
                sc.e.encode(sc.fixed, 0, (int(c[0]) >> al) & 1)
            elif ah == 0:
                sc.ac(i, [_shift(int(x), al) for x in c], ss, se)
            else:
                sc.ac_refine(i, c, ss, se, al)
    sc.e.finish()
    return bytes(data + sc.e.out)


# ------------------------------------------------------- Huffman files ----
def _huff(table):
    return jpeg._huff_codes(*table)


def huffman_jpeg(planes, sampling=((1, 1),) * 4, quality=75, adobe=None,
                 jfif=False, ids=None):
    """Component planes -> a baseline Huffman file (libjpeg's standard
    tables; Adobe APP14 with the given transform when `adobe` is not
    None)."""
    planes = [np.asarray(p) for p in planes]
    H, W = planes[0].shape
    nc = len(planes)
    sampling = [tuple(s) for s in sampling[:nc]]
    qts, coefs, mcux, mcuy = frame_blocks(planes, sampling, quality)
    tq = [0] + [1] * (nc - 1)
    huff = {k: _huff(v) for k, v in jpeg.STD_HUFF.items()}
    codes, lens = [], []
    pred = [0] * nc
    for m in range(mcux * mcuy):
        my, mx = divmod(m, mcux)
        for ci in range(nc):
            h, v = sampling[ci]
            for vy in range(v):
                for hx in range(h):
                    blk = coefs[ci][my * v + vy, mx * h + hx]
                    _emit_block(blk, ci, tq[ci], pred, huff, codes, lens)
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    if adobe is not None:
        out += b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" \
            + bytes([adobe])
    out += _tables(qts, tq)
    out += b"\xff\xc0" + struct.pack(">HBHHB", 8 + 3 * nc, 8, H, W, nc)
    ids = ids or list(range(1, nc + 1))
    for ci in range(nc):
        h, v = sampling[ci]
        out += bytes([ids[ci], (h << 4) | v, tq[ci]])
    out += _dht(sorted(set(tq)))
    out += b"\xff\xda" + struct.pack(">HB", 6 + 2 * nc, nc)
    for ci in range(nc):
        out += bytes([ids[ci], (tq[ci] << 4) | tq[ci]])
    out += b"\x00\x3f\x00" + jpeg._bits_of(codes, lens) + b"\xff\xd9"
    return bytes(out)


def _tables(qts, tq):
    out = b""
    for t in sorted(set(tq)):
        out += b"\xff\xdb\x00\x43" + bytes([t]) \
            + bytes(qts[tq.index(t)][ZZ].astype(np.uint8))
    return out


def _dht(tabs, ac=True):
    out = b""
    for t in tabs:
        for tc in ((0, 1) if ac else (0,)):
            counts, vals = jpeg.STD_HUFF[(tc, t)]
            out += b"\xff\xc4" + struct.pack(">H", 3 + 16 + len(vals)) \
                + bytes([(tc << 4) | t]) + bytes(counts) + bytes(vals)
    return out


def _emit_block(blk, ci, t, pred, huff, codes, lens):
    dc_t, ac_t = huff[(0, t)], huff[(1, t)]
    diff = int(blk[0]) - pred[ci]
    pred[ci] = int(blk[0])
    _category(diff, dc_t, codes, lens)
    nz = np.flatnonzero(blk[1:]) + 1
    last = 0
    for k in nz.tolist():
        run = k - last - 1
        while run > 15:
            codes.append(ac_t[0xF0][0])
            lens.append(ac_t[0xF0][1])
            run -= 16
        val = int(blk[k])
        nb = abs(val).bit_length()
        code, ln = ac_t[(run << 4) | nb]
        codes.extend((code, (val - 1 if val < 0 else val) & ((1 << nb) - 1)))
        lens.extend((ln, nb))
        last = k
    if last < 63:
        codes.append(ac_t[0][0])
        lens.append(ac_t[0][1])


def _category(diff, table, codes, lens):
    nb = abs(diff).bit_length()
    codes.append(table[nb][0])
    lens.append(table[nb][1])
    if nb:
        codes.append((diff - 1 if diff < 0 else diff) & ((1 << nb) - 1))
        lens.append(nb)


# ------------------------------------------------------------ lossless ----
def _predict(ra, rb, rc, psv):
    return {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv]


def lossless_jpeg(planes, sampling=None, psv=1, pt=0, restart_rows=0,
                  jfif=True, ids=None):
    """Component planes (each at its own size for its sampling) -> a
    lossless SOF3 file, one interleaved scan, the standard DC luminance
    table; restart_rows: restart interval in MCU rows."""
    planes = [np.asarray(p, np.int64) >> pt for p in planes]
    nc = len(planes)
    sampling = [tuple(s) for s in (sampling or [(1, 1)] * nc)]
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    H = planes[0].shape[0] * vmax // sampling[0][1]
    W = planes[0].shape[1] * hmax // sampling[0][0]
    mcux, mcuy = -(-W // hmax), -(-H // vmax)
    if nc == 1:
        mcux, mcuy = planes[0].shape[1], planes[0].shape[0]
    huff = _huff(jpeg.STD_HUFF[(0, 0)])
    codes, lens = [], []
    diffs = []
    for ci, p in enumerate(planes):
        h, v = sampling[ci]
        rows, cols = (mcuy * v, mcux * h) if nc > 1 else p.shape
        q = np.pad(p, ((0, rows - p.shape[0]), (0, cols - p.shape[1])),
                   "edge")
        d = np.zeros_like(q)
        first = True
        for y in range(q.shape[0]):
            if restart_rows and y % (restart_rows * v) == 0:
                first = True
            for x in range(q.shape[1]):
                if first:
                    pred = (1 << (8 - pt - 1)) if x == 0 else q[y, x - 1]
                elif x == 0:
                    pred = q[y - 1, 0]
                else:
                    pred = _predict(int(q[y, x - 1]), int(q[y - 1, x]),
                                    int(q[y - 1, x - 1]), psv)
                d[y, x] = ((int(q[y, x]) - int(pred) + 0x8000) & 0xFFFF) \
                    - 0x8000
            if y % v == v - 1:
                first = False
        diffs.append(d)
    data = bytearray()
    rst = 0
    mcu_rows = mcuy
    for my in range(mcu_rows):
        if restart_rows and my and my % restart_rows == 0:
            data += jpeg._bits_of(codes, lens) + bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) & 7
            codes, lens = [], []
        for mx in range(mcux):
            for ci in range(nc):
                h, v = sampling[ci] if nc > 1 else (1, 1)
                for vy in range(v):
                    for hx in range(h):
                        _category(int(diffs[ci][my * v + vy, mx * h + hx]),
                                  huff, codes, lens)
    data += jpeg._bits_of(codes, lens)
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    out += b"\xff\xc3" + struct.pack(">HBHHB", 8 + 3 * nc, 8, H, W, nc)
    ids = ids or list(range(1, nc + 1))
    for ci in range(nc):
        h, v = sampling[ci]
        out += bytes([ids[ci], (h << 4) | v, 0])
    out += _dht([0], ac=False)
    if restart_rows:
        out += b"\xff\xdd\x00\x04" + struct.pack(">H", restart_rows * mcux)
    out += b"\xff\xda" + struct.pack(">HB", 6 + 2 * nc, nc)
    for ci in range(nc):
        out += bytes([ids[ci], 0])
    out += bytes([psv, 0, pt]) + data + b"\xff\xd9"
    return bytes(out)


# ------------------------------------------------------ progressive cut ----
def scans_cut(data: bytes, n: int) -> bytes:
    """A progressive file cut after its first n scans, then EOI."""
    pos = -1
    for _ in range(n):
        pos = data.index(b"\xff\xda", pos + 1)
    seg = struct.unpack_from(">H", data, pos + 2)[0]
    return data[:jpeg._segment_end(data, pos + 2 + seg)] + b"\xff\xd9"


# ------------------------------------------------------ JPEG-in-TIFF ----
def _split_tables(stream: bytes):
    """A JPEG stream -> (its DQT and DHT segments, the stream without
    them)."""
    tables, rest = bytearray(), bytearray(stream[:2])
    pos = 2
    while pos < len(stream):
        m = stream[pos + 1]
        if m == 0xDA:
            rest += stream[pos:]
            break
        n = struct.unpack_from(">H", stream, pos + 2)[0]
        seg = stream[pos:pos + 2 + n]
        (tables if m in (0xDB, 0xC4) else rest).extend(seg)
        pos += 2 + n
    return bytes(tables), bytes(rest)


def _strip_jpegs(img, w, h, tiled, sampling, quality):
    """The image cut into strips (rows of h) or tiles (w x h, padded) ->
    one JPEG stream each (the port's encoder, no JFIF marker)."""
    H, W = img.shape[:2]
    out = []
    ys = range(0, H, h)
    xs = range(0, W, w) if tiled else [0]
    for y in ys:
        for x in xs:
            part = img[y:y + h, x:x + w] if tiled else img[y:y + h]
            if tiled:
                pad = [(0, h - part.shape[0]), (0, w - part.shape[1])] \
                    + [(0, 0)] * (img.ndim - 2)
                part = np.pad(part, pad, "edge")
            s = jpeg.encode_jpeg(part, quality, sampling)
            out.append(s[:2] + s[20:])            # drop the JFIF APP0
    return out


def tiff_jpeg(img, photometric=6, sampling=(2, 2), rows=None, tile=None,
              tables=True, quality=75, order="II", extra=None,
              planar=False, lossless=False):
    """(H, W, 3) or (H, W) uint8 -> a compression 7 TIFF.  photometric 6
    (YCbCr, subsampled `sampling`), 2 (RGB, 1 x 1) or 1 (grey); strips of
    `rows` rows, or `tile` (w, h) tiles; tables: the DQT/DHT segments in
    JPEGTables (347) and abbreviated strips; planar: one grey stream per
    sample plane; lossless: one SOF3 stream per strip (no tables)."""
    img = np.asarray(img, np.uint8)
    H, W = img.shape[:2]
    grey = img.ndim == 2
    if grey or photometric != 6:
        samp = ((1, 1),) * 3
    else:
        samp = (tuple(sampling), (1, 1), (1, 1))
    tiled = tile is not None
    w, h = tile if tiled else (W, rows or H)
    if lossless:
        streams = [lossless_jpeg([img[y:y + h]] if grey else
                                 [img[y:y + h, :, k] for k in range(3)],
                                 jfif=False) for y in range(0, H, h)]
        tables = False
    elif planar:
        streams = [s for k in range(3) for s in _strip_jpegs(
            np.ascontiguousarray(img[..., k]), w, h, tiled, samp, quality)]
    else:
        streams = _strip_jpegs(img, w, h, tiled, samp, quality)
    tags = {256: (4, [W]), 257: (4, [H]),
            258: (3, [8] if grey else [8, 8, 8]), 259: (3, [7]),
            262: (3, [photometric]), 277: (3, [1 if grey else 3]),
            284: (3, [2 if planar else 1])}
    if photometric == 6:
        tags[530] = (3, list(sampling))
        tags[532] = (5, [0, 1, 255, 1, 128, 1, 255, 1, 128, 1, 255, 1])
    if tables:
        tabs, _ = _split_tables(streams[0])
        tags[347] = (7, b"\xff\xd8" + tabs + b"\xff\xd9")
        streams = [_split_tables(s)[1] for s in streams]
    tags.update(extra or {})
    return _assemble(tags, streams, tiled, w, h, order)


def tiff_ojpeg(img, sampling=(2, 2), quality=75, photometric=6, jif=True):
    """A compression 6 TIFF whose one strip is a whole JPEG stream, and
    (jif) whose JPEGInterchangeFormat (513) and its length (514) point at
    it too."""
    img = np.asarray(img, np.uint8)
    H, W = img.shape[:2]
    grey = img.ndim == 2
    samp = ((1, 1),) if grey else (tuple(sampling), (1, 1), (1, 1))
    stream = jpeg.encode_jpeg(img, quality, samp)
    tags = {256: (4, [W]), 257: (4, [H]),
            258: (3, [8] if grey else [8, 8, 8]), 259: (3, [6]),
            262: (3, [photometric]), 277: (3, [1 if grey else 3]),
            278: (4, [H]), 284: (3, [1])}
    if not grey:
        tags[530] = (3, list(sampling))
    return _assemble(tags, [stream], False, W, H, "II", jif=jif)


def _assemble(tags, chunks, tiled, w, h, order, jif=False):
    """Tags + strip/tile data -> a classic TIFF (data first, then the
    IFD); jif: 513/514 point at the first chunk."""
    e = "<" if order == "II" else ">"
    body = bytearray((b"II*\x00" if order == "II" else b"MM\x00*")
                     + b"\x00" * 4)
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c
        if len(body) % 2:
            body += b"\x00"
    if tiled:
        tags[322], tags[323] = (3, [w]), (3, [h])
        tags[324], tags[325] = (4, offsets), (4, [len(c) for c in chunks])
    else:
        tags.setdefault(278, (4, [h]))
        tags[273], tags[279] = (4, offsets), (4, [len(c) for c in chunks])
    if jif:
        tags[513], tags[514] = (4, [offsets[0]]), (4, [len(chunks[0])])
    ifd_at = len(body)
    body[4:8] = struct.pack(e + "I", ifd_at)
    extra_at = ifd_at + 2 + 12 * len(tags) + 4
    entries, blobs = b"", b""
    for tag in sorted(tags):
        typ, vals = tags[tag]
        if typ == 7:
            payload, count = bytes(vals), len(vals)
        else:
            code = {3: "H", 4: "I", 5: "I"}[typ]
            payload = struct.pack(e + code * len(vals), *vals)
            count = len(vals) // 2 if typ == 5 else len(vals)
        if len(payload) <= 4:
            field = payload.ljust(4, b"\x00")
        else:
            field = struct.pack(e + "I", extra_at + len(blobs))
            blobs += payload + b"\x00" * (len(payload) & 1)
        entries += struct.pack(e + "HHI", tag, typ, count) + field
    return bytes(body) + struct.pack(e + "H", len(tags)) + entries \
        + b"\x00" * 4 + blobs


# ----------------------------------------------------- YCbCr, no JPEG ----
def ycbcr_blocks(ycc, hs, vs):
    """(H, W, 3) Y, Cb, Cr samples -> libtiff's packed data units: per
    block of hs x vs luma samples (rows padded by replication) the luma
    then one Cb and one Cr (the block's top-left chroma sample)."""
    H, W = ycc.shape[:2]
    Hp, Wp = -(-H // vs) * vs, -(-W // hs) * hs
    p = np.pad(ycc, ((0, Hp - H), (0, Wp - W), (0, 0)), "edge")
    y = p[..., 0].reshape(Hp // vs, vs, Wp // hs, hs).transpose(0, 2, 1, 3) \
        .reshape(Hp // vs, Wp // hs, hs * vs)
    cb = p[::vs, ::hs, 1][..., None]
    cr = p[::vs, ::hs, 2][..., None]
    return np.concatenate([y, cb, cr], -1).astype(np.uint8)


def _difference(raw: bytes, rowsize: int, stride: int) -> bytes:
    """The encode side of predictor 2 over rows of rowsize bytes (left as
    they are where libtiff's decode side would refuse the row size)."""
    if len(raw) % rowsize or rowsize % stride:
        return raw
    a = np.frombuffer(raw, np.uint8).reshape(-1, rowsize // stride,
                                             stride).astype(np.int64)
    d = a.copy()
    d[:, 1:] -= a[:, :-1]
    return (d % 256).astype(np.uint8).tobytes()


def tiff_ycbcr(ycc, sampling=(2, 2), rows=None, compression=1,
               refbw=None, coefficients=None, orientation=None,
               predictor=1, planar=False):
    """(H, W, 3) uint8 Y, Cb, Cr -> a photometric 6 TIFF in libtiff's
    subsampled layout, or (planar) as three planes of samples; strips of
    `rows` rows (a multiple of the vertical subsampling), uncompressed
    (1), LZW (5), Deflate (8) or PackBits (32773), predictor 2 on
    TIFFScanlineSize's rows."""
    ycc = np.asarray(ycc, np.uint8)
    H, W = ycc.shape[:2]
    hs, vs = sampling
    rows = rows or H
    units = -(-W // hs) * (hs * vs + 2)
    parts = []
    for plane in range(3 if planar else 1):
        for y in range(0, H, rows):
            if planar:
                raw = np.ascontiguousarray(ycc[y:y + rows, :, plane])
                raw = raw.tobytes()
            else:
                raw = ycbcr_blocks(ycc[y:y + rows], hs, vs).tobytes()
            if predictor == 2:
                raw = _difference(raw, W if planar else units // vs,
                                  1 if planar else 3)
            parts.append(raw)
    chunks = []
    for raw in parts:
        if compression == 5:
            raw = rf.lzw_encode_tiff(raw)
        elif compression == 8:
            raw = zlib.compress(raw)
        elif compression == 32773:
            raw = rf.packbits(raw)
        chunks.append(raw)
    tags = {256: (4, [W]), 257: (4, [H]), 258: (3, [8, 8, 8]),
            259: (3, [compression]), 262: (3, [6]), 277: (3, [3]),
            284: (3, [2 if planar else 1]), 278: (4, [rows]),
            530: (3, [hs, vs])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if refbw is not None:
        tags[532] = (5, [v for x in refbw for v in (int(x), 1)])
    if coefficients is not None:
        tags[529] = (5, [v for x in coefficients
                         for v in (int(round(x * 10000)), 10000)])
    if orientation is not None:
        tags[274] = (3, [orientation])
    return _assemble(tags, chunks, False, W, rows, "II")


# ------------------------------------------------- the committed files ----
COMMITTED = ["torch_height_arith.jpg", "torch_height32_arith.jpg",
             "torch_height_arith_crop.jpg", "torch_floor_ycc.tif",
             "torch_floor_ycc.png", "torch_cmyk.jpg", "torch_cmyk.png"]


def committed(name: str) -> bytes:
    """The bytes of tests/data/<name> as written here (the PNG twins and
    the CMYK file through Pillow, which the callers pass in as needed):

    - torch_height_arith.jpg: liver_proxy's 1,024^2 height map (BUMP, seed
      0) as a sequential arithmetic-coded grey JPEG, quality 90, restart
      interval 64;
    - torch_height32_arith.jpg: the 32^2 map, progressive arithmetic;
    - torch_height_arith_crop.jpg: the 1,024^2 map's top-left 128^2,
      progressive arithmetic with a restart interval of 5;
    - torch_floor_ycc.tif: floor_texture(256) as a YCbCr 4:2:0
      JPEG-in-TIFF, 64 x 64 tiles with JPEGTables; torch_floor_ycc.png its
      pixels as Pillow decodes them;
    - torch_cmyk.jpg: Pillow's CMYK JPEG of floor_texture(256);
      torch_cmyk.png its pixels as Pillow decodes them."""
    import io
    import os
    import tempfile

    from PIL import Image

    from liverrenderer_tpu_torch.io.png import write_png
    from liverrenderer_tpu_torch.scene.liver_proxy import BUMP, height_map
    from torch_xml_files import floor_texture
    if name.startswith("torch_height"):
        res = 32 if "32" in name else BUMP[0]
        codes = np.round(height_map(res, 0) * 255.0).astype(np.uint8)
        if name == "torch_height_arith.jpg":
            return arith_jpeg([codes], quality=90, restart=64)
        if name == "torch_height_arith_crop.jpg":
            return arith_jpeg([codes[:128, :128]], quality=90,
                              progressive=True, restart=5)
        return arith_jpeg([codes], quality=90, progressive=True)
    floor = floor_texture(256)
    if name.startswith("torch_floor_ycc"):
        data = tiff_jpeg(floor, 6, (2, 2), tile=(64, 64), quality=90)
    else:
        f = io.BytesIO()
        Image.fromarray(floor).convert("CMYK").save(f, "JPEG", quality=90)
        data = f.getvalue()
    if name.endswith(".png"):
        px = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        with tempfile.TemporaryDirectory() as d:
            write_png(os.path.join(d, "twin.png"), px)
            with open(os.path.join(d, "twin.png"), "rb") as fh:
                return fh.read()
    return data
