"""A JPEG decoder (the JAX package reads JPEG files through PIL, whose
libjpeg-turbo decodes them): baseline, extended and progressive files,
Huffman- or arithmetic-coded (io/jpeg_arith.py), and lossless ones
(io/jpeg_lossless.py), of 8-bit precision, with one, three (YCbCr, or RGB
by an Adobe marker or the component ids) or four components (CMYK, or
YCCK under an Adobe marker), any integral sampling factors, restart
intervals, custom Huffman tables and odd sizes -> (H, W, 3) uint8 as
PIL's `Image.open(path).convert("RGB")` returns it.

The decoder computes what libjpeg-turbo computes with its defaults, from
its documented algorithms: the `islow` integer inverse DCT (CONST_BITS 13,
PASS1_BITS 2) with the 16-bit wraps and saturation of its AVX2 version,
"fancy" triangle upsampling for 2h1v, 1h2v
and 2h2v chroma (replication past the component's edges, and for other
integral factors), and the fixed-point YCbCr -> RGB of its rounding
tables.  The entropy decoder runs in C++ (csrc/jpeg_huf.cpp, built at first
use by host_build.compile_shared; a failed build raises); `_scan_plain` is
its plain Python version.  The inverse DCT, upsampling and colour
conversion are vectorised numpy over all blocks.

A progressive file whose scans leave coefficients inexact is smoothed as
libjpeg-turbo 2.1+ smooths it (jdcoefct.c's 5 x 5 DC neighbourhood).
What Pillow refuses is refused with its exception class: at the header
(`check_header`, Pillow's opener) a precision other than 8 bits or a
component count other than 1, 3 or 4 (SyntaxError: the file is passed on
and ends as "cannot identify"); at the decode, hierarchical frames and
arithmetic-coded lossless ones, which libjpeg-turbo does not decode
(OSError "broken data stream").
"""
from __future__ import annotations

import ctypes
import struct
from pathlib import Path

import numpy as np

from . import jpeg_arith

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "jpeg_huf.cpp"
_LIB = None

# zig-zag index -> natural (row-major) index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# islow's constants: FIX(x) = round(x * 2^13)
_C = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433,
      "0_765366865": 6270, "0_899976223": 7373, "1_175875602": 9633,
      "1_501321110": 12299, "1_847759065": 15137, "1_961570560": 16069,
      "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}
CONST_BITS, PASS1_BITS = 13, 2


# ------------------------------------------------------- entropy decode ----
def library():
    """Build (once per source hash) and load csrc/jpeg_huf.cpp; raises if
    the compiler fails."""
    global _LIB
    if _LIB is None:
        from ..host_build import BUILD_DIR, compile_shared
        info = compile_shared(_SRC, BUILD_DIR, "JPEG entropy decode")
        lib = ctypes.CDLL(info["path"])
        p, i32 = ctypes.c_void_p, ctypes.c_int32
        lib.lrt_jpeg_scan.argtypes = [p, ctypes.c_int64, i32, p, p, p, p, p,
                                      i32, i32, i32, i32, i32, i32, i32, i32]
        lib.lrt_jpeg_scan.restype = i32
        _LIB = lib
    return _LIB


def _scan_native(seg: bytes, scan: dict, coefs: list, tables: np.ndarray):
    """One scan through csrc/jpeg_huf.cpp (see its argument list)."""
    comp = np.ascontiguousarray(scan["comp"], np.int32)
    ptrs = (ctypes.c_void_p * len(coefs))(*[c.ctypes.data for c in coefs])
    buf = np.frombuffer(seg, np.uint8) if seg else np.zeros(1, np.uint8)
    dc = np.ascontiguousarray(scan["dc"], np.int32)
    ac = np.ascontiguousarray(scan["ac"], np.int32)
    rc = library().lrt_jpeg_scan(
        buf.ctypes.data, len(seg), len(comp), comp.ctypes.data, ptrs,
        dc.ctypes.data, ac.ctypes.data, tables.ctypes.data, scan["mcux"],
        scan["mcuy"], scan["ss"], scan["se"], scan["ah"], scan["al"],
        int(scan["progressive"]), scan["restart"])
    if rc != 0:
        raise ValueError(f"JPEG: the entropy decode failed ({rc})")


class _Bits:
    """libjpeg's bit reader: 0xFF 0x00 is 0xFF, fill bytes are skipped, and
    from a marker on the stream reads zeros."""

    def __init__(self, data: bytes):
        self.d, self.pos, self.byte, self.cnt = data, 0, 0, 0
        self.marker = False

    def _next(self) -> int:
        d = self.d
        if self.marker or self.pos >= len(d):
            return 0
        c = d[self.pos]
        if c != 0xFF:
            self.pos += 1
            return c
        q = self.pos + 1
        while q < len(d) and d[q] == 0xFF:
            q += 1
        if q < len(d) and d[q] == 0:
            self.pos = q + 1
            return 0xFF
        self.marker = True
        return 0

    def bit(self) -> int:
        if self.cnt == 0:
            self.byte, self.cnt = self._next(), 8
        self.cnt -= 1
        return (self.byte >> self.cnt) & 1

    def get(self, k: int) -> int:
        v = 0
        for _ in range(k):
            v = (v << 1) | self.bit()
        return v

    def restart(self):
        self.cnt, self.marker = 0, False
        d = self.d
        while self.pos < len(d) and d[self.pos] == 0xFF:
            self.pos += 1
        if self.pos < len(d) and 0xD0 <= d[self.pos] <= 0xD7:
            self.pos += 1


def _derive(spec: np.ndarray):
    """16 counts + 256 symbols -> libjpeg's (maxcode, valoffset, symbols)."""
    maxcode, valoff = [-1] * 18, [0] * 18
    code = p = 0
    for ln in range(1, 17):
        n = int(spec[ln - 1])
        if n:
            valoff[ln] = p - code
            code += n
            p += n
            maxcode[ln] = code - 1
        code <<= 1
    maxcode[17] = 1 << 31
    return maxcode, valoff, [int(v) for v in spec[16:]]


def _decode(b: _Bits, t) -> int:
    maxcode, valoff, vals = t
    code, ln = b.bit(), 1
    while code > maxcode[ln]:
        code = (code << 1) | b.bit()
        ln += 1
        if ln > 16:
            return 0
    return vals[(code + valoff[ln]) & 0xFF]


def _extend(r: int, s: int) -> int:
    return r - (1 << s) + 1 if r < (1 << (s - 1)) else r


def _scan_plain(seg: bytes, scan: dict, coefs: list, tables: np.ndarray):
    """The entropy decode loop in Python (the plain version of
    csrc/jpeg_huf.cpp, same arguments)."""
    tabs = [_derive(tables[i]) for i in range(8)]
    b = _Bits(seg)
    ss, se, ah, al = scan["ss"], scan["se"], scan["ah"], scan["al"]
    prog = scan["progressive"]
    pred = [0, 0, 0, 0]
    eob = [0]

    def i16(v):
        return ((v + 0x8000) & 0xFFFF) - 0x8000

    def block(c, ci, dct, act):
        if not prog:
            s = _decode(b, tabs[dct])
            s = _extend(b.get(s), s) if s else 0
            pred[ci] += s
            c[0] = i16(pred[ci])
            k = 1
            while k < 64:
                rs = _decode(b, tabs[4 + act])
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    c[min(k, 63)] = i16(_extend(b.get(s), s))
                elif r != 15:
                    break
                else:
                    k += 15
                k += 1
            return
        if ss == 0:
            if ah == 0:
                s = _decode(b, tabs[dct])
                s = _extend(b.get(s), s) if s else 0
                pred[ci] += s
                c[0] = i16(pred[ci] * (1 << al))
            elif b.bit():
                c[0] = i16(int(c[0]) | (1 << al))
            return
        if ah == 0:
            if eob[0] > 0:
                eob[0] -= 1
                return
            k = ss
            while k <= se:
                rs = _decode(b, tabs[4 + act])
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    c[min(k, 63)] = i16(_extend(b.get(s), s) * (1 << al))
                elif r == 15:
                    k += 15
                else:
                    eob[0] = (1 << r) + (b.get(r) if r else 0) - 1
                    break
                k += 1
            return
        p1, m1 = 1 << al, -(1 << al)

        def refine(k):
            v = int(c[k])
            if b.bit() and (v & p1) == 0:
                c[k] = i16(v + (p1 if v >= 0 else m1))

        k = ss
        if eob[0] == 0:
            while k <= se:
                rs = _decode(b, tabs[4 + act])
                r, s = rs >> 4, rs & 15
                if s:
                    s = p1 if b.bit() else m1
                elif r != 15:
                    eob[0] = (1 << r) + (b.get(r) if r else 0)
                    break
                while True:
                    if c[min(k, 63)] != 0:
                        refine(min(k, 63))
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                    if k > se:
                        break
                if s:
                    c[min(k, 63)] = s
                k += 1
        if eob[0] > 0:
            while k <= se:
                if c[min(k, 63)] != 0:
                    refine(min(k, 63))
                k += 1
            eob[0] -= 1

    comp = scan["comp"]
    n_mcu = comp[0][1] * comp[0][2] if len(comp) == 1 \
        else scan["mcux"] * scan["mcuy"]
    to_go = scan["restart"]
    for m in range(n_mcu):
        if scan["restart"] > 0:
            if to_go == 0:
                b.restart()
                pred[:] = [0, 0, 0, 0]
                eob[0] = 0
                to_go = scan["restart"]
            to_go -= 1
        for ci, (stride, cbw, _, ch, cv, arr) in enumerate(comp):
            co = coefs[arr]
            if len(comp) == 1:
                block(co[m // cbw, m % cbw], ci, scan["dc"][ci],
                      scan["ac"][ci])
                continue
            my, mx = divmod(m, scan["mcux"])
            for vy in range(cv):
                for hx in range(ch):
                    block(co[my * cv + vy, mx * ch + hx], ci, scan["dc"][ci],
                          scan["ac"][ci])


# ------------------------------------------------------------ the IDCT ----
def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _w16(x):
    """Two's-complement wrap to 16 bits (an SSE/AVX word operation)."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _w32(x):
    return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def _idct_1d(d0, d1, d2, d3, d4, d5, d6, d7, first: bool):
    """One islow pass over columns (first) or rows, as libjpeg-turbo's
    AVX2 jsimd_idct_islow computes it on x86-64 (Pillow's build): int16
    inputs, the sums in0 +- in4, in7 + in3 and in5 + in1 wrapped to 16
    bits, the products and the rest in 32 bits, descaled and saturated to
    16 bits.  On data that does not overflow this is jidctint.c's result."""
    C = _C
    tmp3 = d2 * (C["0_541196100"] + C["0_765366865"]) + d6 * C["0_541196100"]
    tmp2 = d2 * C["0_541196100"] + d6 * (C["0_541196100"] - C["1_847759065"])
    tmp0 = _w16(d0 + d4) << CONST_BITS
    tmp1 = _w16(d0 - d4) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    z3, z4 = _w16(d7 + d3), _w16(d5 + d1)
    z3, z4 = (z3 * (C["1_175875602"] - C["1_961570560"])
              + z4 * C["1_175875602"],
              z3 * C["1_175875602"]
              + z4 * (C["1_175875602"] - C["0_390180644"]))
    t0 = d7 * (C["0_298631336"] - C["0_899976223"]) \
        - d1 * C["0_899976223"] + z3
    t1 = d5 * (C["2_053119869"] - C["2_562915447"]) \
        - d3 * C["2_562915447"] + z4
    t2 = -d5 * C["2_562915447"] \
        + d3 * (C["3_072711026"] - C["2_562915447"]) + z3
    t3 = -d7 * C["0_899976223"] \
        + d1 * (C["1_501321110"] - C["0_899976223"]) + z4
    n = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS + 3
    return [np.clip(_w32(v + (1 << (n - 1))) >> n, -0x8000, 0x7FFF)
            for v in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                      tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's islow inverse DCT over blocks, as its AVX2 version
    runs it: (N, 64) zig-zag int16 coefficients, (64,) zig-zag quantizers
    -> (N, 8, 8) uint8 samples.  The dequantized coefficients are 16-bit
    products; a block whose rows 1..7 are all zero takes the column pass's
    shortcut (row 0 << PASS1_BITS in 16 bits); the result saturates to
    -128..127 before the +128."""
    nat = np.zeros((len(coef), 64), np.int64)
    nat[:, ZIGZAG] = _w16(coef.astype(np.int64) * q.astype(np.int64))
    blk = nat.reshape(-1, 8, 8)
    # pass 1: columns (the result keeps PASS1_BITS of extra precision)
    ws = np.stack(_idct_1d(*[blk[:, r, :] for r in range(8)], True), 1)
    flat = ~blk[:, 1:, :].any((1, 2))
    ws[flat] = _w16(blk[flat, :1, :] << PASS1_BITS)
    # pass 2: rows, descaled by another 3 bits, then saturated to a byte
    out = np.stack(_idct_1d(*[ws[:, :, c] for c in range(8)], False), 2)
    return (np.clip(out, -128, 127) + 128).astype(np.uint8)


# ---------------------------------------------------------- upsampling ----
def _fancy_h2(p: np.ndarray) -> np.ndarray:
    """h2v1_fancy_upsample: (H, w) -> (H, 2w), 3/4 nearer + 1/4 further,
    the edge columns kept."""
    p = p.astype(np.int32)
    left = np.concatenate([p[:, :1], p[:, :-1]], 1)
    right = np.concatenate([p[:, 1:], p[:, -1:]], 1)
    out = np.empty((p.shape[0], 2 * p.shape[1]), np.int32)
    out[:, 0::2] = (3 * p + left + 1) >> 2
    out[:, 1::2] = (3 * p + right + 2) >> 2
    out[:, 0] = p[:, 0]
    out[:, -1] = p[:, -1]
    return out.astype(np.uint8)


def _fancy_v2(p: np.ndarray) -> np.ndarray:
    """h1v2_fancy_upsample: (h, W) -> (2h, W), rows beyond the edges
    replicated; biases 1 (above) and 2 (below)."""
    p = p.astype(np.int32)
    up = np.concatenate([p[:1], p[:-1]], 0)
    dn = np.concatenate([p[1:], p[-1:]], 0)
    out = np.empty((2 * p.shape[0], p.shape[1]), np.int32)
    out[0::2] = (3 * p + up + 1) >> 2
    out[1::2] = (3 * p + dn + 2) >> 2
    return out.astype(np.uint8)


def _fancy_h2v2(p: np.ndarray) -> np.ndarray:
    """h2v2_fancy_upsample: column sums 3 * nearer row + further row, then
    3/4 + 1/4 across with biases 8 and 7 (the edge columns * 4)."""
    p = p.astype(np.int32)
    up = np.concatenate([p[:1], p[:-1]], 0)
    dn = np.concatenate([p[1:], p[-1:]], 0)
    out = np.empty((2 * p.shape[0], 2 * p.shape[1]), np.int32)
    for r0, s in ((0, 3 * p + up), (1, 3 * p + dn)):
        last = np.concatenate([s[:, :1], s[:, :-1]], 1)
        nxt = np.concatenate([s[:, 1:], s[:, -1:]], 1)
        row = out[r0::2]
        row[:, 0::2] = (3 * s + last + 8) >> 4
        row[:, 1::2] = (3 * s + nxt + 7) >> 4
        row[:, 0] = (4 * s[:, 0] + 8) >> 4
        row[:, -1] = (4 * s[:, -1] + 7) >> 4
    return out.astype(np.uint8)


def _upsample(p: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """A component plane (cropped to its own size) by integral factors, as
    libjpeg-turbo's jdsample.c chooses its method."""
    if (fh, fv) == (1, 1):
        return p
    if (fh, fv) == (2, 1) and p.shape[1] > 2:
        return _fancy_h2(p)
    if (fh, fv) == (1, 2):
        return _fancy_v2(p)
    if (fh, fv) == (2, 2) and p.shape[1] > 2:
        return _fancy_h2v2(p)
    return np.repeat(np.repeat(p, fv, 0), fh, 1)


# ----------------------------------------------------- colour convert ----
def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15

    def fix(v):
        return int(v * 65536 + 0.5)
    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    return cr_r, cb_b, cr_g, cb_g


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """libjpeg's ycc_rgb_convert (fixed point, 16 fraction bits)."""
    cr_r, cb_b, cr_g, cb_g = _ycc_tables()
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


# --------------------------------------------------------- the decoder ----
BROKEN = "broken data stream when reading image file"

# Pillow's JpegImagePlugin.MARKER: the markers its opener knows, those
# whose segment it reads, and its SOF handler's markers
_PIL_SEGMENT = set(range(0xC0, 0xD0)) - {0xC8} | set(range(0xDA, 0xF0)) \
    | {0xFE}
_PIL_BARE = {0xC8} | set(range(0xD0, 0xDA)) | set(range(0xF0, 0xFE))
_PIL_SOF = set(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC} | {0xDE}
# libjpeg-turbo's frame kinds: SOF marker -> (entropy coding, progressive,
# lossless); the other SOFs (hierarchical 5-7 and 13-15, JPG) it refuses
_SOF_KINDS = {0xC0: ("huffman", False, False),
              0xC1: ("huffman", False, False),
              0xC2: ("huffman", True, False), 0xC3: ("huffman", False, True),
              0xC9: ("arith", False, False), 0xCA: ("arith", True, False),
              0xCB: ("arith", False, True)}
_SOF_REFUSED = {0xC5, 0xC6, 0xC7, 0xC8, 0xCD, 0xCE, 0xCF}


def check_header(data: bytes):
    """JpegImageFile._open: Pillow's walk over the markers up to the first
    SOS.  SyntaxError where its opener gives
    the file up (Image.open then tries the next format: a precision other
    than 8, a component count other than 1, 3 or 4, no frame, an empty
    size, a short table), OSError where a segment runs past the end."""
    if not data.startswith(b"\xff\xd8\xff"):
        raise SyntaxError("not a JPEG file")
    n, pos, s = len(data), 3, 0xFF
    info = {}
    while True:
        if s != 0xFF:                     # junk before a marker
            if pos >= n:
                raise SyntaxError("no marker found")
            s, pos = data[pos], pos + 1
            continue
        if pos >= n:
            raise SyntaxError("no marker found")
        m, pos = data[pos], pos + 1
        if m in _PIL_SEGMENT:
            if pos + 2 > n:
                raise SyntaxError("a short segment length")
            size = ((data[pos] << 8) | data[pos + 1]) - 2
            pos += 2
            if size > n - pos:
                raise OSError("Truncated File Read")
            seg = data[pos:pos + max(size, 0)]
            pos += max(size, 0)
            _pil_segment(m, seg, info)
            if m == 0xDA:
                break
        elif m == 0xFF:                   # a fill byte: the next is read
            continue                      # as a marker again
        elif m == 0x00:                   # an escaped 0xFF: skipped
            pass
        elif m not in _PIL_BARE:
            raise SyntaxError("no marker found")
        if pos >= n:
            raise SyntaxError("no marker found")
        s, pos = data[pos], pos + 1
    if "layers" not in info or min(info["size"]) <= 0:
        raise SyntaxError("no frame, or an empty image")


def _pil_segment(m: int, seg: bytes, info: dict):
    """The checks of Pillow's SOF, DQT and APP handlers that give a file
    up (their struct.error and IndexError become SyntaxError)."""
    if m in _PIL_SOF:
        if len(seg) < 5:
            raise SyntaxError("a short frame header")
        info["size"] = struct.unpack_from(">HH", seg, 1)[::-1]
        if seg[0] != 8:
            raise SyntaxError(f"cannot handle {seg[0]}-bit layers")
        if len(seg) < 6:
            raise SyntaxError("a short frame header")
        if seg[5] not in (1, 3, 4):
            raise SyntaxError(f"cannot handle {seg[5]}-layer images")
        if (len(seg) - 6) % 3:
            raise SyntaxError("a short component list")
        info["layers"] = seg[5]
    elif m == 0xDB:
        while seg:
            qt_length = 1 + 64 * (1 if seg[0] // 16 == 0 else 2)
            if len(seg) < qt_length:
                raise SyntaxError("bad quantization table marker")
            seg = seg[qt_length:]
    elif (m == 0xE0 and seg.startswith(b"JFIF")
          or m == 0xEE and seg.startswith(b"Adobe")) and len(seg) < 7:
        raise SyntaxError("a short APP segment")


def _segment_end(data: bytes, pos: int) -> int:
    """The offset of the marker that ends the entropy-coded data starting
    at pos (RSTn markers and stuffed bytes belong to the data)."""
    buf = np.frombuffer(data, np.uint8)
    ff = np.flatnonzero(buf[pos:-1] == 0xFF) + pos
    nxt = buf[ff + 1]
    stop = ff[(nxt != 0) & (nxt != 0xFF) & ((nxt < 0xD0) | (nxt > 0xD7))]
    return int(stop[0]) if len(stop) else len(data)


def _new_state() -> dict:
    """What libjpeg keeps across the streams of one decompression: the
    quantization and Huffman tables (a JPEG-in-TIFF's JPEGTables stream
    defines them for its strips), and the frame with its coefficients."""
    return {"qt": {}, "tables": np.zeros((8, 272), np.int32), "frame": None,
            "coefs": [], "latched": {}, "coef_bits": None, "samples": [],
            "restart": 0, "jfif": False, "adobe": False, "transform": None,
            "cond": _DAC_DEFAULT.copy(), "avail": None}


# Pillow's read block (ImageFile.MAXBLOCK): its JPEG decoder gets the file
# 64 KiB at a time, and libjpeg's arithmetic decoder cannot wait for more
PIL_BLOCK = 65536


def _need(st: dict, end: int):
    """libjpeg needs the file up to `end`: where it may suspend (markers,
    Huffman data), Pillow reads another block until it has it."""
    if st["avail"] is not None:
        while st["avail"] < end:
            st["avail"] += PIL_BLOCK


# T.81's DAC defaults per table: L = 0, U = 1 (DC), Kx = 5 (AC)
_DAC_DEFAULT = np.tile(np.array([[0, 1, 5]], np.int32), (16, 1))


def _parse(data: bytes, st: dict, scan_fn, arith_fn):
    """libjpeg's marker reader over one stream, each scan decoded as it
    comes.  An SOI resets what T.81 resets there (restart interval, DAC
    conditioning, the JFIF and Adobe markers)."""
    pos = 0
    while pos < len(data):
        if data[pos] != 0xFF:
            pos += 1                   # libjpeg skips garbage to a marker
            continue
        if pos + 1 >= len(data):
            break
        marker = data[pos + 1]
        pos += 2
        if marker == 0xFF:
            pos -= 1
            continue
        if marker == 0xD9:             # EOI
            break
        if marker == 0xD8:             # SOI
            st.update(restart=0, jfif=False, adobe=False, transform=None,
                      cond=_DAC_DEFAULT.copy())
            continue
        if marker == 0x01 or 0xD0 <= marker <= 0xD7 or marker == 0x00:
            continue
        if marker in _SOF_REFUSED:
            raise OSError(BROKEN)
        seg_len = struct.unpack_from(">H", data, pos)[0]
        seg = data[pos + 2:pos + seg_len]
        pos += seg_len
        _need(st, pos)
        if marker == 0xE0 and seg[:5] == b"JFIF\x00" and len(seg) >= 14:
            st["jfif"] = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            st["adobe"], st["transform"] = True, seg[11]
        elif marker == 0xDB:           # DQT
            o = 0
            while o < len(seg):
                pq, tq = seg[o] >> 4, seg[o] & 15
                dt = ">u2" if pq else "u1"
                st["qt"][tq] = np.frombuffer(seg, dt, 64, o + 1) \
                    .astype(np.int64)
                o += 1 + 64 * (2 if pq else 1)
        elif marker == 0xC4:           # DHT
            o = 0
            while o < len(seg):
                tc, th = seg[o] >> 4, seg[o] & 15
                if th > 3 or o + 17 > len(seg):
                    raise OSError(BROKEN)  # JERR_DHT_INDEX, a short table
                counts = np.frombuffer(seg, np.uint8, 16, o + 1)
                k = int(counts.sum())
                if k > 256 or o + 17 + k > len(seg):
                    raise OSError(BROKEN)  # JERR_BAD_HUFF_TABLE
                row = st["tables"][4 * tc + th]
                row[:] = 0
                row[:16] = counts
                row[16:16 + k] = np.frombuffer(seg, np.uint8, k, o + 17)
                o += 17 + k
        elif marker == 0xCC:           # DAC
            for o in range(0, len(seg) - 1, 2):
                idx, val = seg[o], seg[o + 1]
                if idx >= 32:
                    raise OSError(BROKEN)
                if idx >= 16:
                    st["cond"][idx - 16, 2] = val
                else:
                    if (val & 15) > (val >> 4):
                        raise OSError(BROKEN)
                    st["cond"][idx, :2] = (val & 15, val >> 4)
        elif marker == 0xDD:           # DRI
            st["restart"] = struct.unpack_from(">H", seg, 0)[0]
        elif marker in _SOF_KINDS:
            if st["frame"] is not None:
                raise OSError(BROKEN)  # JERR_SOF_DUPLICATE
            st["frame"] = _frame(marker, seg, st)
        elif marker == 0xDA:           # SOS
            pos = _sos(data, pos, seg, st, scan_fn, arith_fn)


def _frame(marker: int, seg: bytes, st: dict) -> dict:
    coding, progressive, lossless = _SOF_KINDS[marker]
    prec, h, w, nc = struct.unpack_from(">BHHB", seg, 0)
    comps = []
    for i in range(nc):
        cid, hv, tq = struct.unpack_from("BBB", seg, 6 + 3 * i)
        comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
    if any(not 1 <= c["h"] <= 4 or not 1 <= c["v"] <= 4 for c in comps):
        raise OSError(BROKEN)          # JERR_BAD_SAMPLING
    frame = {"w": w, "h": h, "comps": comps, "coding": coding,
             "progressive": progressive, "lossless": lossless,
             "hmax": max(c["h"] for c in comps),
             "vmax": max(c["v"] for c in comps), "precision": prec}
    if lossless:
        if coding == "arith":          # libjpeg-turbo has no lossless
            raise OSError(BROKEN)      # arithmetic decoder
        from . import jpeg_lossless
        jpeg_lossless.geometry(frame)
        st["samples"] = [None] * nc
        return frame
    frame["mcux"] = -(-w // (8 * frame["hmax"]))
    frame["mcuy"] = -(-h // (8 * frame["vmax"]))
    for c in comps:
        c["w"] = -(-w * c["h"] // frame["hmax"])
        c["hgt"] = -(-h * c["v"] // frame["vmax"])
        c["bw"], c["bh"] = -(-c["w"] // 8), -(-c["hgt"] // 8)
        c["stride"] = frame["mcux"] * c["h"]
        st["coefs"].append(np.zeros((frame["mcuy"] * c["v"], c["stride"],
                                     64), np.int16))
    st["coef_bits"] = np.full((nc, 64), -1)
    return frame


def _sos(data: bytes, pos: int, seg: bytes, st: dict, scan_fn, arith_fn):
    """One scan: its header, then its entropy-coded data -> the offset of
    the marker that ends it."""
    frame = st["frame"]
    if frame is None:
        raise ValueError("JPEG: a scan before the frame header")
    ns = seg[0]
    ids = {c["id"]: i for i, c in enumerate(frame["comps"])}
    sc_comp, dc, ac = [], [], []
    for i in range(ns):
        cid, td = seg[1 + 2 * i], seg[2 + 2 * i]
        if cid not in ids:
            raise OSError(BROKEN)      # JERR_BAD_COMPONENT_ID
        ci = ids[cid]
        c = frame["comps"][ci]
        if not frame["lossless"]:
            st["latched"].setdefault(ci, st["qt"][c["tq"]])
        sc_comp.append((c["stride"], c["bw"], c["bh"], c["h"], c["v"], ci))
        dc.append(td >> 4)
        ac.append(td & 15)
    ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    ah, al = ahal >> 4, ahal & 15
    scan = {"comp": sc_comp, "dc": dc, "ac": ac, "mcux": frame["mcux"],
            "mcuy": frame["mcuy"], "ss": ss, "se": se, "ah": ah, "al": al,
            "progressive": frame["progressive"], "restart": st["restart"]}
    if frame["coding"] != "arith":
        _check_huff_tables(st["tables"], frame, scan)
    end = _segment_end(data, pos)
    if frame["lossless"]:
        from . import jpeg_lossless
        jpeg_lossless.scan(data[pos:end], scan, frame, st["samples"],
                           st["tables"])
        _need(st, end)
        return end
    if frame["progressive"]:
        bad = se != 0 if ss == 0 else (se < ss or se > 63 or ns != 1)
        if bad or (ah != 0 and ah - 1 != al) or al > 13:
            raise OSError(BROKEN)      # JERR_BAD_PROGRESSION
    if frame["coding"] == "arith":     # the decoder reads the marker
        used = (arith_fn or jpeg_arith._scan_native)(
            data[pos:end + 2], scan, st["coefs"], st["cond"])
        if st["avail"] is not None and pos + used > st["avail"]:
            raise OSError(BROKEN)      # JERR_CANT_SUSPEND under Pillow
    else:
        (scan_fn or _scan_native)(data[pos:end], scan, st["coefs"],
                                  st["tables"])
        _need(st, end)
    for *_, ci in sc_comp:
        if frame["progressive"]:
            st["coef_bits"][ci, ss:se + 1] = al
        else:
            st["coef_bits"][ci, :] = 0
    return end


def _check_huff_tables(tables, frame, scan):
    """jpeg_make_d_derived_tbl on the Huffman tables the scan starts:
    code lengths that overrun 256 symbols or leave no room for their codes
    (a code of all ones), and DC symbols past 15 (16 in lossless), fail
    as JERR_BAD_HUFF_TABLE."""
    ss, ah = scan["ss"], scan["ah"]
    use = []
    if frame["lossless"] or not frame["progressive"] or (ss == 0
                                                         and ah == 0):
        use += [(0, t) for t in scan["dc"]]
    if not frame["lossless"] and (not frame["progressive"] or ss > 0):
        use += [(1, t) for t in scan["ac"]]
    for tc, th in set(use):
        row = tables[4 * tc + th]
        counts = [int(c) for c in row[:16]]
        n = sum(counts)
        sizes = [length for length, c in enumerate(counts, 1)
                 for _ in range(c)]
        code, p = 0, 0
        si = sizes[0] if sizes else 0
        while p < n:
            while p < n and sizes[p] == si:
                code += 1
                p += 1
            if code >= 1 << si:
                raise OSError(BROKEN)
            code <<= 1
            si += 1
        if tc == 0 and any(int(v) > (16 if frame["lossless"] else 15)
                           for v in row[16:16 + n]):
            raise OSError(BROKEN)


# ------------------------------------------------------ block smoothing ----
# jdcoefct.c's decompress_smooth_data (libjpeg-turbo 2.1 and later): per
# zig-zag coefficient 1..9, its weights over the 5 x 5 DC neighbourhood
# (rows of DC01..DC25) with DC interpolation, and without it
_SMOOTH_DC = {
    1: [-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3,
        -3, 13, 0, -13, 3, -1, -1, 0, 1, 1],
    2: [-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0,
        1, -13, -38, -13, 1, 1, 3, 3, 3, 1],
    3: [0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0,
        0, 2, 7, 2, 0, 0, 0, 1, 0, 0],
    4: [-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0,
        0, -9, 0, 9, 0, 1, 0, 0, 0, -1],
    5: [0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1,
        0, 2, -5, 2, 0, 0, 0, 0, 0, 0],
    6: [0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0,
        0, 1, 0, -1, 0, 0, 0, 0, 0, 0],
    7: [0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0,
        0, -1, 3, -1, 0, 0, 0, 0, 0, 0],
    8: [0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0,
        0, 1, 0, -1, 0, 0, 0, 0, 0, 0],
    9: [0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0,
        0, -1, -2, -1, 0, 0, 0, 0, 0, 0],
    0: [-2, -6, -8, -6, -2, -6, 6, 42, 6, -6, -8, 42, 152, 42, -8,
        -6, 6, 42, 6, -6, -2, -6, -8, -6, -2]}
_SMOOTH_AC = {
    1: [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7,
        0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    2: [0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0,
        0, 0, -50, 0, 0, 0, 0, 7, 0, 0],
    3: [0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0,
        0, 0, 13, 0, 0, 0, 0, -1, 0, 0],
    4: [0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0,
        1, -10, 0, 10, -1, 0, 1, 0, -1, 0],
    5: [0] * 10 + [-1, 13, -24, 13, -1] + [0] * 10}


def _smooth(co: np.ndarray, c: dict, frame: dict, q: np.ndarray,
            bits: np.ndarray) -> np.ndarray:
    """decompress_smooth_data's coefficient estimates for one component:
    a copy of its (rows, stride, 64) coefficients where each of the first
    nine AC coefficients not known exactly (its coef_bits nonzero) and
    still zero is predicted from the DCs around (and, when no AC
    coefficient was ever sent, the DC too), with libjpeg's rows at the
    picture's and the last iMCU row's edges."""
    out = co.copy()
    v, bw, bh = c["v"], c["bw"], c["bh"]
    total = frame["mcuy"]
    change_dc = bool((bits[1:10] == -1).all())
    q = q.astype(np.int64)
    kernels = _SMOOTH_DC if change_dc else _SMOOTH_AC
    cols = np.arange(bw)
    dc = co[..., 0].astype(np.int64)
    for imcu in range(total):
        last = imcu == total - 1
        rows = (bh % v or v) if last else v
        for br in range(rows):
            r = imcu * v + br                     # the block row
            ibr, ibrs = imcu * rows + br, rows * total
            prev = r - 1 if ibr > 0 else r
            pprev = r - 2 if ibr > 1 else prev
            nxt = r + 1 if ibr < ibrs - 1 else r
            nnxt = r + 2 if ibr < ibrs - 2 else nxt
            win = np.stack([dc[rr][np.clip(cols[:, None] + np.arange(-2, 3),
                                           0, bw - 1)]
                            for rr in (pprev, prev, r, nxt, nnxt)], 1) \
                .reshape(bw, 25)
            blk = out[r, :bw]
            for k, wts in kernels.items():
                al = int(bits[k]) if k else 0
                if k and (al == 0 or k > 9):
                    continue
                num = q[0] * (win @ np.asarray(wts, np.int64))
                qk = q[k]
                mag = ((qk << 7) + np.abs(num)) // (qk << 8)
                if k and al > 0:
                    mag = np.minimum(mag, (1 << al) - 1)
                pred = np.where(num >= 0, mag, -mag)
                if k:
                    sel = blk[:, k] == 0
                    blk[sel, k] = pred[sel]
                else:
                    blk[:, 0] = pred
    return out


def _smoothing_ok(st: dict) -> bool:
    """jdcoefct.c smoothing_ok: a progressive frame whose every component
    has some DC, with nonzero quantizers 0..9, and some coefficient 1..9
    not known exactly."""
    frame, bits = st["frame"], st["coef_bits"]
    if not frame["progressive"] or (bits[:, 0] < 0).any():
        return False
    for ci, c in enumerate(frame["comps"]):
        q = st["latched"].get(ci)
        if q is None or (q[:10] == 0).any():
            return False
    return bool((bits[:, 1:10] != 0).any())


# ------------------------------------------------------------- read out ----
def decode_jpeg(data: bytes, scan_fn=None, arith_fn=None,
                tables: bytes = b"", upsample: bool = True,
                pillow_feed: bool = False) -> dict:
    """A JPEG stream (after an optional table-spec stream `tables`, as
    JPEG-in-TIFF's JPEGTables) -> {"planes": each component's samples,
    cropped to its own size and upsampled to the frame's unless
    `upsample` is false, "frame", "jfif", "adobe", "transform"}.  Raises
    OSError where libjpeg stops with an error; `pillow_feed`: also where
    an arithmetic-coded scan needs a byte past the blocks Pillow has fed
    to libjpeg by then (libjpeg's arithmetic decoder cannot suspend)."""
    st = _new_state()
    if pillow_feed:
        st["avail"] = PIL_BLOCK
    if tables:
        _parse(tables, st, scan_fn, arith_fn)
    _parse(data, st, scan_fn, arith_fn)
    frame = st["frame"]
    if frame is None:
        raise ValueError("JPEG: no frame header")
    planes = []
    smooth = not frame["lossless"] and _smoothing_ok(st)
    for ci, c in enumerate(frame["comps"]):
        if frame["lossless"]:
            p = st["samples"][ci]
            if p is None:
                p = np.zeros((c["hgt"], c["w"]), np.uint8)
        else:
            co = st["coefs"][ci]
            q = st["latched"].get(ci, st["qt"].get(c["tq"],
                                                   np.ones(64, np.int64)))
            if smooth:
                co = _smooth(co, c, frame, q, st["coef_bits"][ci])
            rows, cols = co.shape[:2]
            px = idct_islow(co.reshape(-1, 64), q) \
                .reshape(rows, cols, 8, 8).transpose(0, 2, 1, 3) \
                .reshape(rows * 8, cols * 8)
            p = px[:c["hgt"], :c["w"]]
        if upsample:
            fh, fv = frame["hmax"] // c["h"], frame["vmax"] // c["v"]
            if frame["lossless"]:        # no fancy upsampling: 1x1 units
                p = np.repeat(np.repeat(p, fv, 0), fh, 1)
            else:
                p = _upsample(p, fh, fv)
            p = p[:frame["h"], :frame["w"]]
        planes.append(p)
    return {"planes": planes, "frame": frame, "jfif": st["jfif"],
            "adobe": st["adobe"], "transform": st["transform"]}


def colour_space(d: dict) -> str:
    """libjpeg's default jpeg_color_space (jdapimin.c): "grey", "rgb",
    "ycc", "cmyk" or "ycck"."""
    n = len(d["planes"])
    if n == 1:
        return "grey"
    if n == 3:
        if d["jfif"]:
            return "ycc"
        if d["adobe"]:
            return "rgb" if d["transform"] == 0 else "ycc"
        ids = tuple(c["id"] for c in d["frame"]["comps"])
        if d["frame"]["lossless"] or ids == (82, 71, 66):
            return "rgb"                 # libjpeg-turbo 3's lossless guess
        return "ycc"
    if n == 4:
        return "ycck" if d["adobe"] and d["transform"] != 0 else "cmyk"
    raise OSError(BROKEN)


def open_jpeg(data: bytes):
    """The JPEG entry of Image.open's registry: Pillow's header checks,
    then a function that decodes the file."""
    check_header(data)
    return lambda: read_jpeg(data)


def read_jpeg(data: bytes, scan_fn=None, arith_fn=None,
              as_cmyk: bool = False) -> np.ndarray:
    """A JPEG file's bytes -> (H, W, 3) uint8 as Pillow's
    `Image.open(...).convert("RGB")`.  scan_fn / arith_fn: the Huffman and
    arithmetic entropy decoders (default the C++ ones; the tests pass the
    plain versions).  A four-component file is read as Pillow reads it,
    "CMYK;I" (Adobe's inverted CMYK) through Pillow's cmyk2rgb; `as_cmyk`
    tells libjpeg its colour space is CMYK whatever its Adobe marker says
    (no YCCK conversion), as Pillow's BLP plugin does."""
    check_header(data)
    d = decode_jpeg(data, scan_fn, arith_fn, pillow_feed=True)
    space = colour_space(d)
    if d["frame"]["lossless"] and space in ("ycc", "ycck") and not as_cmyk:
        raise OSError(BROKEN)            # no colour conversion in lossless
    p = d["planes"]
    if space == "grey":
        return np.repeat(p[0][..., None], 3, -1)
    if space == "rgb":
        return np.stack(p, -1)
    if space == "ycc":
        return ycc_to_rgb(*p)
    from .tiff import cmyk_to_rgb        # Pillow's cmyk2rgb
    if space == "ycck" and not as_cmyk:  # jdcolor.c ycck_cmyk_convert
        cmyk = np.concatenate([255 - ycc_to_rgb(*p[:3]), p[3][..., None]],
                              -1)
    else:
        cmyk = np.stack(p, -1)
    return cmyk_to_rgb(255 - cmyk)       # "CMYK;I": Adobe's inverted CMYK


# ---------------------------------------------------------- the encoder ----
# libjpeg's example tables (jcparam.c), natural order
_STD_LUM = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
            14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
            18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113,
            92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112,
            100, 103, 99]
_STD_CHR = [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
            24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] \
    + [99] * 32
# the standard Huffman tables (ITU T.81 K.3; jstdhuff.c): counts, symbols
_AC_LUM_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9"
    "fa")
_AC_CHR_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
STD_HUFF = {
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], bytes(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
             _AC_LUM_VALS),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], bytes(range(12))),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
             _AC_CHR_VALS),
}


def quality_tables(quality: int = 75):
    """jpeg_set_quality(quality, force_baseline=TRUE): the luminance and
    chrominance quantizers, natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return [np.clip((np.asarray(t, np.int64) * scale + 50) // 100, 1, 255)
            for t in (_STD_LUM, _STD_CHR)]


def _fdct_1d(d, first: bool):
    """One jfdctint (islow) pass; d: the 8 input arrays."""
    C = _C
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if first:
        out[0] = (tmp10 + tmp11) << PASS1_BITS
        out[4] = (tmp10 - tmp11) << PASS1_BITS
        n = CONST_BITS - PASS1_BITS
    else:
        out[0] = _descale(tmp10 + tmp11, PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, PASS1_BITS)
        n = CONST_BITS + PASS1_BITS
    z1 = (tmp12 + tmp13) * C["0_541196100"]
    out[2] = _descale(z1 + tmp13 * C["0_765366865"], n)
    out[6] = _descale(z1 + tmp12 * -C["1_847759065"], n)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * C["1_175875602"]
    tmp4 = tmp4 * C["0_298631336"]
    tmp5 = tmp5 * C["2_053119869"]
    tmp6 = tmp6 * C["3_072711026"]
    tmp7 = tmp7 * C["1_501321110"]
    z1 = z1 * -C["0_899976223"]
    z2 = z2 * -C["2_562915447"]
    z3 = z3 * -C["1_961570560"] + z5
    z4 = z4 * -C["0_390180644"] + z5
    out[7] = _descale(tmp4 + z1 + z3, n)
    out[5] = _descale(tmp5 + z2 + z4, n)
    out[3] = _descale(tmp6 + z2 + z3, n)
    out[1] = _descale(tmp7 + z1 + z4, n)
    return out


def fdct_quantize(blocks: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(N, 8, 8) uint8 samples -> (N, 64) zig-zag quantized coefficients:
    jpeg_fdct_islow, then libjpeg-turbo's reciprocal quantization of the
    8x-scaled coefficients by q << 3."""
    x = blocks.astype(np.int64) - 128
    rows = np.stack(_fdct_1d([x[:, :, c] for c in range(8)], True), 2)
    coef = np.stack(_fdct_1d([rows[:, r, :] for r in range(8)], False), 1)
    coef = coef.reshape(-1, 64)
    div = np.asarray(q, np.int64) << 3
    b = np.floor(np.log2(div)).astype(np.int64)
    r = 16 + b
    fq, fr = (1 << r) // div, (1 << r) % div
    c = div // 2
    pow2 = fr == 0
    fq = np.where(pow2, fq >> 1, np.where(fr > div // 2, fq + 1, fq))
    r = np.where(pow2, r - 1, r)
    c = np.where(~pow2 & (fr <= div // 2), c + 1, c)
    mag = ((np.abs(coef) + c) * fq) >> r
    return (np.sign(coef) * mag)[:, ZIGZAG]


def _rgb_to_ycc(img: np.ndarray):
    """jccolor.c's rgb_ycc_convert (16 fraction bits, Cb/Cr rounded by
    0.5 - epsilon)."""
    def fix(v):
        return int(v * 65536 + 0.5)
    half, off = 1 << 15, 128 << 16
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    y = (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b
         + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b
          + off + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b
          + off + half - 1) >> 16
    return [y, cb, cr]


def _downsample(p: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """jcsample.c: fullsize, h2v1 (biases 0, 1), h2v2 (biases 1, 2) or the
    generic box average with numpix / 2 rounding."""
    h, w = p.shape
    if (fh, fv) == (1, 1):
        return p
    blk = p.reshape(h // fv, fv, w // fh, fh)
    if (fh, fv) == (2, 1):
        bias = np.arange(w // 2) & 1
        return (blk.sum((1, 3)) + bias) >> 1
    if (fh, fv) == (2, 2):
        bias = 1 + (np.arange(w // 2) & 1)
        return (blk.sum((1, 3)) + bias) >> 2
    n = fh * fv
    return (blk.sum((1, 3)) + n // 2) // n


def _bits_of(codes: list, lens: list) -> bytes:
    """Huffman codes and appended bits -> the byte-stuffed entropy data,
    padded with 1 bits (jchuff.c's flush)."""
    codes = np.asarray(codes, np.int64)
    lens = np.asarray(lens, np.int64)
    total = int(lens.sum())
    pad = -total % 8
    idx = np.repeat(np.arange(len(lens)), lens)
    start = np.cumsum(lens) - lens
    j = np.arange(total) - start[idx]
    bits = (codes[idx] >> (lens[idx] - 1 - j)) & 1
    bits = np.concatenate([bits, np.ones(pad, np.int64)]).astype(np.uint8)
    out = np.packbits(bits)
    ff = np.flatnonzero(out == 0xFF)
    return np.insert(out, ff + 1, 0).tobytes()


def _huff_codes(counts, vals):
    """Canonical codes -> {symbol: (code, length)}."""
    table, code, k = {}, 0, 0
    for ln in range(1, 17):
        for _ in range(counts[ln - 1]):
            table[vals[k]] = (code, ln)
            code += 1
            k += 1
        code <<= 1
    return table


def encode_jpeg(img: np.ndarray, quality: int = 75,
                sampling=((2, 2), (1, 1), (1, 1))) -> bytes:
    """(H, W, 3) or (H, W) uint8 -> a baseline JFIF file as libjpeg-turbo
    writes it with PIL's defaults (quality 75, 4:2:0, islow forward DCT,
    the standard Huffman tables); `sampling`: each component's (h, v)."""
    img = np.asarray(img, np.uint8)
    grey = img.ndim == 2
    planes = [img.astype(np.int64)] if grey else _rgb_to_ycc(img)
    samp = [(1, 1)] if grey else [tuple(s) for s in sampling]
    H, W = img.shape[:2]
    hmax = max(s[0] for s in samp)
    vmax = max(s[1] for s in samp)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    if grey:
        mcux, mcuy = -(-W // 8), -(-H // 8)
    lum, chr_ = quality_tables(quality)
    qts = [lum, chr_]
    comps = []
    for ci, (p, (h, v)) in enumerate(zip(planes, samp)):
        fh, fv = hmax // h, vmax // v
        bw, bh = -(-W * h // (hmax * 8)), -(-H * v // (vmax * 8))
        hp = -(-H // vmax) * vmax
        p = np.pad(p, ((0, hp - H), (0, bw * 8 * fh - W)), mode="edge")
        d = _downsample(p, fh, fv)
        rows = mcuy * 8 * v if not grey else bh * 8
        d = np.pad(d, ((0, rows - d.shape[0]), (0, 0)), mode="edge")
        nby, nbx = rows // 8, (mcux * h if not grey else bw)
        blocks = d.reshape(nby, 8, bw, 8).transpose(0, 2, 1, 3) \
            .reshape(-1, 8, 8)
        q = qts[min(ci, 1)]
        co = np.zeros((nby, nbx, 64), np.int64)
        co[:, :bw] = fdct_quantize(blocks, q).reshape(nby, bw, 64)
        if not grey:     # dummy blocks: AC 0, DC of their left neighbour
            for bx in range(bw, nbx):
                co[:, bx, 0] = co[:, bx - 1, 0]
            for by in range(bh, nby):   # rows of the last MCU row past
                co[by] = 0                 # the image: DC of the MCU's
                co[by, :, 0] = np.repeat(co[by - 1, h - 1::h, 0], h)
        comps.append({"id": ci + 1, "h": h, "v": v, "tq": min(ci, 1),
                      "co": co})
    # the entropy-coded data, MCU by MCU
    huff = {k: _huff_codes(*v) for k, v in STD_HUFF.items()}
    codes, lens = [], []
    pred = [0] * len(comps)

    def emit_block(blk, ci, t):
        dc_t, ac_t = huff[(0, t)], huff[(1, t)]
        diff = int(blk[0]) - pred[ci]
        pred[ci] = int(blk[0])
        nb = abs(diff).bit_length()
        codes.append(dc_t[nb][0])
        lens.append(dc_t[nb][1])
        if nb:
            codes.append((diff - 1 if diff < 0 else diff) & ((1 << nb) - 1))
            lens.append(nb)
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
            codes.extend((code, (val - 1 if val < 0 else val)
                          & ((1 << nb) - 1)))
            lens.extend((ln, nb))
            last = k
        if last < 63:
            codes.append(ac_t[0][0])
            lens.append(ac_t[0][1])

    if grey:
        for blk in comps[0]["co"].reshape(-1, 64):
            emit_block(blk, 0, 0)
    else:
        for my in range(mcuy):
            for mx in range(mcux):
                for ci, c in enumerate(comps):
                    for vy in range(c["v"]):
                        for hx in range(c["h"]):
                            emit_block(c["co"][my * c["v"] + vy,
                                               mx * c["h"] + hx], ci,
                                       c["tq"])
    data = _bits_of(codes, lens)
    out = bytearray(b"\xff\xd8")
    out += b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    for t in range(1 if grey else 2):
        out += b"\xff\xdb\x00\x43" + bytes([t]) \
            + bytes(qts[t][ZIGZAG].astype(np.uint8))
    out += b"\xff\xc0" + struct.pack(">HBHHB", 8 + 3 * len(comps), 8, H, W,
                                     len(comps))
    for c in comps:
        out += bytes([c["id"], (c["h"] << 4) | c["v"], c["tq"]])
    for t in range(1 if grey else 2):
        for tc in (0, 1):
            counts, vals = STD_HUFF[(tc, t)]
            out += b"\xff\xc4" + struct.pack(">H", 3 + 16 + len(vals)) \
                + bytes([(tc << 4) | t]) + bytes(counts) + bytes(vals)
    out += b"\xff\xda" + struct.pack(">HB", 6 + 2 * len(comps), len(comps))
    for c in comps:
        out += bytes([c["id"], (c["tq"] << 4) | c["tq"]])
    out += b"\x00\x3f\x00" + data + b"\xff\xd9"
    return bytes(out)
