"""A JPEG decoder (the JAX package reads JPEG files through PIL, whose
libjpeg-turbo decodes them): baseline, extended and progressive
Huffman-coded files of 8-bit precision, grey or three components (YCbCr,
or RGB by an Adobe marker or the component ids), any integral sampling
factors, restart intervals, custom Huffman tables and odd sizes ->
(H, W, 3) uint8 as PIL's `Image.open(path).convert("RGB")` returns it.

The decoder computes what libjpeg-turbo computes with its defaults, from
its documented algorithms: the `islow` integer inverse DCT (CONST_BITS 13,
PASS1_BITS 2, its range limit), "fancy" triangle upsampling for 2h1v, 1h2v
and 2h2v chroma (replication past the component's edges, and for other
integral factors), and the fixed-point YCbCr -> RGB of its rounding
tables.  The entropy decoder runs in C++ (csrc/jpeg_huf.cpp, built at first
use by host_build.compile_shared; a failed build raises); `_scan_plain` is
its plain Python version.  The inverse DCT, upsampling and colour
conversion are vectorised numpy over all blocks.

Arithmetic coding, 12-bit and lossless files, CMYK/YCCK (four
components), and progressive files whose scans stop short of the last bit
(libjpeg's block smoothing then applies) raise (ROADMAP M9).
"""
from __future__ import annotations

import ctypes
import struct
from pathlib import Path

import numpy as np

from ..errors import not_ported

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


def _idct_1d(d0, d1, d2, d3, d4, d5, d6, d7, first: bool):
    """One islow pass over columns (first) or rows; int64 arrays."""
    C = _C
    z1 = (d2 + d6) * C["0_541196100"]
    tmp2 = z1 + d6 * -C["1_847759065"]
    tmp3 = z1 + d2 * C["0_765366865"]
    tmp0 = (d0 + d4) << CONST_BITS
    tmp1 = (d0 - d4) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d7, d5, d3, d1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * C["1_175875602"]
    t0 = t0 * C["0_298631336"]
    t1 = t1 * C["2_053119869"]
    t2 = t2 * C["3_072711026"]
    t3 = t3 * C["1_501321110"]
    z1 = z1 * -C["0_899976223"]
    z2 = z2 * -C["2_562915447"]
    z3 = z3 * -C["1_961570560"] + z5
    z4 = z4 * -C["0_390180644"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    n = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS + 3
    return [_descale(v, n) for v in (tmp10 + t3, tmp11 + t2, tmp12 + t1,
                                     tmp13 + t0, tmp13 - t0, tmp12 - t1,
                                     tmp11 - t2, tmp10 - t3)]


def idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """libjpeg's jpeg_idct_islow over blocks: (N, 64) zig-zag int16
    coefficients, (64,) zig-zag quantizers -> (N, 8, 8) uint8 samples."""
    nat = np.zeros((len(coef), 64), np.int64)
    nat[:, ZIGZAG] = coef.astype(np.int64) * q.astype(np.int64)
    blk = nat.reshape(-1, 8, 8)
    # pass 1: columns (the result keeps PASS1_BITS of extra precision)
    ws = np.stack(_idct_1d(*[blk[:, r, :] for r in range(8)], True), 1)
    # pass 2: rows, descaled by another 3 bits, then the range limit
    out = np.stack(_idct_1d(*[ws[:, :, c] for c in range(8)], False), 2)
    return np.clip(((out + 512) & 1023) - 512 + 128, 0, 255).astype(np.uint8)


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
def _segment_end(data: bytes, pos: int) -> int:
    """The offset of the marker that ends the entropy-coded data starting
    at pos (RSTn markers and stuffed bytes belong to the data)."""
    buf = np.frombuffer(data, np.uint8)
    ff = np.flatnonzero(buf[pos:-1] == 0xFF) + pos
    nxt = buf[ff + 1]
    stop = ff[(nxt != 0) & (nxt != 0xFF) & ((nxt < 0xD0) | (nxt > 0xD7))]
    return int(stop[0]) if len(stop) else len(data)


def read_jpeg(data: bytes, scan_fn=None) -> np.ndarray:
    """A JPEG file's bytes -> (H, W, 3) uint8.  scan_fn: the entropy
    decoder (default the C++ one; the tests pass `_scan_plain`)."""
    scan_fn = scan_fn or _scan_native
    if data[:2] != b"\xff\xd8":
        raise OSError("not a JPEG file")
    pos = 2
    qt = {}
    tables = np.zeros((8, 272), np.int32)
    restart = 0
    frame = None
    jfif = adobe = False
    transform = None
    coefs, latched = [], {}
    coef_bits = None
    while pos < len(data):
        if data[pos] != 0xFF:
            pos += 1                   # libjpeg skips garbage to a marker
            continue
        marker = data[pos + 1]
        pos += 2
        if marker == 0xFF:
            pos -= 1
            continue
        if marker == 0xD9:             # EOI
            break
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        seg_len = struct.unpack_from(">H", data, pos)[0]
        seg = data[pos + 2:pos + seg_len]
        pos += seg_len
        if marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe, transform = True, seg[11]
        elif marker == 0xDB:           # DQT
            o = 0
            while o < len(seg):
                pq, tq = seg[o] >> 4, seg[o] & 15
                dt = ">u2" if pq else "u1"
                qt[tq] = np.frombuffer(seg, dt, 64, o + 1).astype(np.int64)
                o += 1 + 64 * (2 if pq else 1)
        elif marker == 0xC4:           # DHT
            o = 0
            while o < len(seg):
                tc, th = seg[o] >> 4, seg[o] & 15
                counts = np.frombuffer(seg, np.uint8, 16, o + 1)
                n = int(counts.sum())
                row = tables[4 * tc + th]
                row[:] = 0
                row[:16] = counts
                row[16:16 + n] = np.frombuffer(seg, np.uint8, n, o + 17)
                o += 17 + n
        elif marker == 0xDD:           # DRI
            restart = struct.unpack_from(">H", seg, 0)[0]
        elif marker in (0xC0, 0xC1, 0xC2):
            prec, h, w, nc = struct.unpack_from(">BHHB", seg, 0)
            if prec != 8:
                raise not_ported(f"{prec}-bit JPEG files", "Queue 1 M9")
            if nc not in (1, 3):
                raise not_ported(f"{nc}-component (CMYK, YCCK) JPEG files",
                                 "Queue 1 M9")
            comps = []
            for i in range(nc):
                cid, hv, tq = struct.unpack_from("BBB", seg, 6 + 3 * i)
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15,
                              "tq": tq})
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            mcux = -(-w // (8 * hmax))
            mcuy = -(-h // (8 * vmax))
            for c in comps:
                c["w"] = -(-w * c["h"] // hmax)
                c["hgt"] = -(-h * c["v"] // vmax)
                c["bw"], c["bh"] = -(-c["w"] // 8), -(-c["hgt"] // 8)
                c["stride"] = mcux * c["h"]
                coefs.append(np.zeros((mcuy * c["v"], c["stride"], 64),
                                      np.int16))
            frame = {"w": w, "h": h, "comps": comps, "hmax": hmax,
                     "vmax": vmax, "mcux": mcux, "mcuy": mcuy,
                     "progressive": marker == 0xC2}
            coef_bits = np.full((nc, 64), -1)
        elif 0xC3 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise not_ported("arithmetic-coded, lossless or hierarchical "
                             "JPEG files", "Queue 1 M9")
        elif marker == 0xDA:           # SOS
            if frame is None:
                raise ValueError("JPEG: a scan before the frame header")
            ns = seg[0]
            ids = {c["id"]: i for i, c in enumerate(frame["comps"])}
            sc_comp, dc, ac = [], [], []
            for i in range(ns):
                cid, td = seg[1 + 2 * i], seg[2 + 2 * i]
                ci = ids[cid]
                c = frame["comps"][ci]
                latched.setdefault(ci, qt[c["tq"]])
                sc_comp.append((c["stride"], c["bw"], c["bh"], c["h"], c["v"],
                                ci))
                dc.append(td >> 4)
                ac.append(td & 15)
            ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
            scan = {"comp": sc_comp, "dc": dc, "ac": ac,
                    "mcux": frame["mcux"], "mcuy": frame["mcuy"],
                    "ss": ss, "se": se, "ah": ahal >> 4, "al": ahal & 15,
                    "progressive": frame["progressive"], "restart": restart}
            end = _segment_end(data, pos)
            scan_fn(data[pos:end], scan, coefs, tables)
            pos = end
            for *_, ci in sc_comp:
                if frame["progressive"]:
                    coef_bits[ci, ss:se + 1] = ahal & 15
                else:
                    coef_bits[ci, :] = 0
    if frame is None:
        raise ValueError("JPEG: no frame header")
    if frame["progressive"] and (coef_bits[:, 0] >= 0).all() \
            and (coef_bits[:, 1:10] != 0).any():
        raise not_ported("progressive JPEG files whose scans stop before "
                         "the last bit (block smoothing)", "Queue 1 M9")
    planes = []
    for ci, c in enumerate(frame["comps"]):
        co = coefs[ci]
        rows, cols = co.shape[:2]
        q = latched.get(ci, qt.get(c["tq"], np.ones(64, np.int64)))
        px = idct_islow(co.reshape(-1, 64), q).reshape(rows, cols, 8, 8) \
            .transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)
        p = px[:c["hgt"], :c["w"]]
        up = _upsample(p, frame["hmax"] // c["h"], frame["vmax"] // c["v"])
        planes.append(up[:frame["h"], :frame["w"]])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, -1)
    ids = tuple(c["id"] for c in frame["comps"])
    rgb = (not jfif and adobe and transform == 0) or \
        (not jfif and not adobe and ids == (82, 71, 66))
    if rgb:
        return np.stack(planes, -1)
    return ycc_to_rgb(*planes)


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
