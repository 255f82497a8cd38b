"""An OpenEXR codec (counterpart of liverrenderer_tpu/io/exr.py and of the
JAX package's native reader, native/exr_io.cpp, which reads through the
system OpenEXR): flat images, read; ZIP-compressed half or float files,
written.

Read: scanline and tiled files (one level, and level 0 of a mip- or
ripmap), single- or multi-part (part 0, as `Imf::InputFile` reads it), of
half, float and uint channels, with no, RLE, ZIPS, ZIP, PIZ, PXR24, B44 or
B44A compression, written from the OpenEXR file-format specification in
numpy.  PIZ's Huffman decode loop runs in C++ (csrc/exr_huf.cpp, built at
first use; its plain Python version `_huf_decode_plain` is the reference
the tests hold it to); the rest of each codec is vectorised numpy.  Deep
files and DWA compression raise (ROADMAP M9).  Channels with x or y
subsampling raise as well: no file the port reads has them.

`read_exr` returns R, G, B (alpha dropped), as the JAX package's pure
reader does; `read_exr_any` keeps alpha and orders the channels R, G, B(,
A), as the JAX package's reader does with its native library built
(io/image.read_exr_any).  Pixels come back as float32: a uint channel
converts as the native reader's float frame buffer does.
"""
from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

from ..errors import not_ported

MAGIC = 20000630

_PIX_UINT, _PIX_HALF, _PIX_FLOAT = 0, 1, 2
_PIX_SIZE = {_PIX_UINT: 4, _PIX_HALF: 2, _PIX_FLOAT: 4}
_PIX_NP = {_PIX_UINT: np.dtype("<u4"), _PIX_HALF: np.dtype("<f2"),
           _PIX_FLOAT: np.dtype("<f4")}
_NONE, _RLE, _ZIPS, _ZIP, _PIZ, _PXR24, _B44, _B44A = range(8)
_COMPRESSION = {8: "DWAA", 9: "DWAB"}
# scan lines per chunk of a scanline file
_LINES = {_NONE: 1, _RLE: 1, _ZIPS: 1, _ZIP: 16, _PIZ: 32, _PXR24: 16,
          _B44: 32, _B44A: 32}
# version flags
_TILED, _DEEP, _MULTIPART = 0x200, 0x800, 0x1000

# PIZ's Huffman coder: code lengths are 6-bit fields of the packed table,
# where 59..62 stand for runs of 2..5 unused symbols and 63 for a run of
# 6..261 (8 more bits)
_HUF_ENCSIZE = (1 << 16) + 1
_SHORT_ZEROCODE_RUN, _LONG_ZEROCODE_RUN = 59, 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN
_HUF_MAX_LEN = 58
# B44: a block whose third byte is at least this is flat (3 bytes)
_B44_FLAT = 13 << 2

_HUF_SRC = Path(__file__).resolve().parent.parent / "csrc" / "exr_huf.cpp"
_HUF_LIB = None


def _read_cstr(buf, off):
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("latin1"), end + 1


def _reorder_unpredict(data: bytes) -> bytes:
    """Undo the ZIP and RLE codecs' byte predictor, then their
    interleaving."""
    arr = np.frombuffer(data, np.uint8)
    if len(arr) > 1:
        deltas = arr[1:].astype(np.int64) - 128
        cs = np.cumsum(np.concatenate([arr[:1].astype(np.int64), deltas]))
        out = (cs % 256).astype(np.uint8)
    else:
        out = arr
    n = len(out)
    half = (n + 1) // 2
    result = np.empty(n, np.uint8)
    result[0::2] = out[:half]
    result[1::2] = out[half:]
    return result.tobytes()


def _predict_reorder(data: bytes) -> bytes:
    """The ZIP codec's interleaving and byte predictor (for writing)."""
    arr = np.frombuffer(data, np.uint8)
    n = len(arr)
    half = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[:half] = arr[0::2]
    inter[half:] = arr[1::2]
    out = np.empty(n, np.uint8)
    out[0] = inter[0]
    diff = inter[1:].astype(np.int16) - inter[:-1].astype(np.int16) + 128
    out[1:] = (diff % 256).astype(np.uint8)
    return out.tobytes()


# ---------------------------------------------------------------------------
# headers and chunks
# ---------------------------------------------------------------------------
def _parse_header(buf, off):
    """One header's attributes -> (dict, offset past its terminating
    null).  channels: [(name, pixel type, pLinear)] in file order."""
    hdr = {"channels": [], "compression": _NONE}
    while True:
        name, off = _read_cstr(buf, off)
        if not name:
            return hdr, off
        _, off = _read_cstr(buf, off)
        size = struct.unpack_from("<i", buf, off)[0]
        off += 4
        aval = buf[off:off + size]
        off += size
        if name == "channels":
            coff = 0
            while aval[coff] != 0:
                cname, coff = _read_cstr(aval, coff)
                ptype, plinear, xs, ys = struct.unpack_from("<iB3xii", aval,
                                                            coff)
                coff += 16
                if (xs, ys) != (1, 1):
                    raise not_ported("subsampled EXR channels", "Queue 1 M9")
                if ptype not in _PIX_SIZE:
                    raise ValueError(f"EXR pixel type {ptype}")
                hdr["channels"].append((cname, ptype, bool(plinear)))
        elif name == "compression":
            hdr["compression"] = aval[0]
        elif name == "dataWindow":
            hdr["dw"] = struct.unpack("<4i", aval)
        elif name == "tiles":
            hdr["tiles"] = struct.unpack("<IIB", aval[:9])
        elif name == "type":
            hdr["type"] = aval.rstrip(b"\x00").decode("latin1")


def _chunks(buf, path):
    """(part 0's header, [(x0, y0, nx, ny, compressed bytes)] of its level-0
    chunks, relative to its data window)."""
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    if version & _DEEP:
        raise not_ported("deep EXR files", "Queue 1 M9")
    hdr, off = _parse_header(buf, 8)
    multipart = bool(version & _MULTIPART)
    if multipart:       # the other parts' headers, then an empty one
        while buf[off] != 0:
            _, off = _parse_header(buf, off)
        off += 1
    kind = hdr.get("type", "tiledimage" if version & _TILED
                   else "scanlineimage")
    if kind.startswith("deep"):
        raise not_ported("deep EXR files", "Queue 1 M9")
    if "dw" not in hdr:
        raise ValueError(f"EXR file without a dataWindow: {path}")
    comp = hdr["compression"]
    if comp not in _LINES:
        raise not_ported(
            f"{_COMPRESSION.get(comp, comp)}-compressed EXR files",
            "Queue 1 M9")
    xmin, ymin, xmax, ymax = hdr["dw"]
    w, h = xmax - xmin + 1, ymax - ymin + 1
    if kind == "tiledimage":
        tx, ty, _ = hdr["tiles"]
        n = ((w + tx - 1) // tx) * ((h + ty - 1) // ty)  # level 0 first
    else:
        n = (h + _LINES[comp] - 1) // _LINES[comp]
    offsets = struct.unpack_from(f"<{n}Q", buf, off)
    skip = 4 if multipart else 0     # each chunk's part number
    chunks = []
    for c in offsets:
        c += skip
        if kind == "tiledimage":
            dx, dy, lx, ly, size = struct.unpack_from("<5i", buf, c)
            if (lx, ly) != (0, 0):
                raise ValueError(f"EXR tile of level {(lx, ly)} in level "
                                 f"0's offset table: {path}")
            x0, y0 = dx * tx, dy * ty
            nx, ny, c = min(tx, w - x0), min(ty, h - y0), c + 20
        else:
            y, size = struct.unpack_from("<ii", buf, c)
            x0, y0 = 0, y - ymin
            nx, ny, c = w, min(_LINES[comp], h - y0), c + 8
        chunks.append((x0, y0, nx, ny, buf[c:c + size]))
    return hdr, chunks


# ---------------------------------------------------------------------------
# the codecs: compressed chunk -> {channel name: (ny, nx) pixels}
# ---------------------------------------------------------------------------
def _split_lines(data, chans, nx, ny):
    """Uncompressed chunk bytes (each line holds every channel's nx
    samples in turn) -> {name: (ny, nx)}."""
    dt = np.dtype([(c, _PIX_NP[t], (nx,)) for c, t, _ in chans])
    lines = np.frombuffer(data, dt, count=ny)
    return {c: lines[c] for c, _, _ in chans}


def _rle(raw: bytes) -> bytes:
    """OpenEXR's run-length decode: a negative count -n copies n bytes, a
    count n >= 0 repeats the next byte n + 1 times."""
    src = np.frombuffer(raw, np.int8)
    out = []
    i = 0
    while i < len(src):
        n = int(src[i])
        if n < 0:
            out.append(raw[i + 1:i + 1 - n])
            i += 1 - n
        else:
            out.append(raw[i + 1:i + 2] * (n + 1))
            i += 2
    return b"".join(out)


def _words_to(words, ptype):
    """(ny, nx * size) uint16 words, least significant first -> (ny, nx)
    pixels of ptype."""
    if ptype == _PIX_HALF:
        return words.view(np.float16)
    u = words[:, 0::2].astype(np.uint32) | (words[:, 1::2].astype(np.uint32)
                                            << 16)
    return u if ptype == _PIX_UINT else u.view(np.float32)


def _pxr24(data: bytes, chans, nx, ny):
    """PXR24 (after zlib): per line and channel, the bytes of each sample's
    differences, most significant byte plane first; float keeps its top 24
    bits, half and uint are exact."""
    planes = {_PIX_HALF: 2, _PIX_FLOAT: 3, _PIX_UINT: 4}
    dt = np.dtype([(c, np.uint8, (planes[t], nx)) for c, t, _ in chans])
    lines = np.frombuffer(data, dt, count=ny)
    out = {}
    for c, t, _ in chans:
        b = lines[c].astype(np.uint32)                  # (ny, planes, nx)
        k = planes[t]
        diff = sum(b[:, i] << (8 * (k - 1 - i)) for i in range(k))
        if t == _PIX_FLOAT:
            diff = diff << 8
        pix = np.cumsum(diff, axis=1, dtype=np.uint32)  # wraps mod 2^32
        out[c] = (pix.astype(np.uint16).view(np.float16) if t == _PIX_HALF
                  else pix if t == _PIX_UINT else pix.view(np.float32))
    return out


def _b44_log_table() -> np.ndarray:
    """B44's table for pLinear channels, applied on decode: 8 ln(h) as
    half for every half bit pattern h, 0 where h is negative or not
    finite."""
    h = np.arange(1 << 16, dtype=np.uint16).view(np.float16)
    x = h.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        v = (8.0 * np.log(x.astype(np.float32)).astype(np.float64)) \
            .astype(np.float32)
    v = np.where(np.isfinite(x) & (x >= 0), v, np.float32(0.0))
    return v.astype(np.float16).view(np.uint16)


_LOG_TABLE = None


def _b44_unpack(blocks: np.ndarray) -> np.ndarray:
    """(k, 14) or (k, 3) bytes -> (k, 16) uint16 of each 4 x 4 block, row
    major."""
    b = blocks.astype(np.int64)
    s0 = (b[:, 0] << 8) | b[:, 1]
    if b.shape[1] == 3:
        s = np.repeat(s0[:, None], 16, 1)
    else:
        shift = b[:, 2] >> 2
        bias = (0x20 << shift) & 0xFFFF
        d = np.stack([
            ((b[:, 2] << 4) | (b[:, 3] >> 4)) & 0x3F,      # s4 - s0
            ((b[:, 3] << 2) | (b[:, 4] >> 6)) & 0x3F,      # s8 - s4
            b[:, 4] & 0x3F,                                # s12 - s8
            b[:, 5] >> 2,                                  # s1 - s0
            ((b[:, 5] << 4) | (b[:, 6] >> 4)) & 0x3F,      # s5 - s4
            ((b[:, 6] << 2) | (b[:, 7] >> 6)) & 0x3F,      # s9 - s8
            b[:, 7] & 0x3F,                                # s13 - s12
            b[:, 8] >> 2,                                  # s2 - s1
            ((b[:, 8] << 4) | (b[:, 9] >> 4)) & 0x3F,      # s6 - s5
            ((b[:, 9] << 2) | (b[:, 10] >> 6)) & 0x3F,     # s10 - s9
            b[:, 10] & 0x3F,                               # s14 - s13
            b[:, 11] >> 2,                                 # s3 - s2
            ((b[:, 11] << 4) | (b[:, 12] >> 4)) & 0x3F,    # s7 - s6
            ((b[:, 12] << 2) | (b[:, 13] >> 6)) & 0x3F,    # s11 - s10
            b[:, 13] & 0x3F], 1)                           # s15 - s14
        step = (d << shift[:, None]) - bias[:, None]
        s = np.empty((len(b), 16), np.int64)
        s[:, 0] = s0
        # (target, source, difference column), in the codec's order
        for tgt, src, col in ((4, 0, 0), (8, 4, 1), (12, 8, 2), (1, 0, 3),
                              (5, 4, 4), (9, 8, 5), (13, 12, 6), (2, 1, 7),
                              (6, 5, 8), (10, 9, 9), (14, 13, 10),
                              (3, 2, 11), (7, 6, 12), (11, 10, 13),
                              (15, 14, 14)):
            s[:, tgt] = (s[:, src] + step[:, col]) & 0xFFFF
    s &= 0xFFFF
    # the ordered-magnitude encoding back to half bits
    return np.where(s & 0x8000, s & 0x7FFF, ~s & 0xFFFF).astype(np.uint16)


def _b44(raw: bytes, chans, nx, ny):
    """B44 and B44A: channel after channel; a half channel as 4 x 4
    blocks (14 bytes, or 3 for a flat block), float and uint channels
    stored raw."""
    global _LOG_TABLE
    buf = np.frombuffer(raw, np.uint8)
    pos = 0
    out = {}
    for c, t, linear in chans:
        if t != _PIX_HALF:
            n = nx * ny
            out[c] = np.frombuffer(raw, _PIX_NP[t], n, pos).reshape(ny, nx)
            pos += 4 * n
            continue
        bx, by = (nx + 3) // 4, (ny + 3) // 4
        starts = np.empty(bx * by, np.int64)
        flat = np.empty(bx * by, bool)
        for i in range(bx * by):     # each block's size is in its bytes
            starts[i] = pos
            flat[i] = buf[pos + 2] >= _B44_FLAT
            pos += 3 if flat[i] else 14
        s = np.empty((bx * by, 16), np.uint16)
        for is_flat, size in ((True, 3), (False, 14)):
            sel = flat == is_flat
            if sel.any():
                s[sel] = _b44_unpack(buf[starts[sel][:, None]
                                         + np.arange(size)])
        if linear:
            if _LOG_TABLE is None:
                _LOG_TABLE = _b44_log_table()
            s = _LOG_TABLE[s]
        img = s.reshape(by, bx, 4, 4).transpose(0, 2, 1, 3) \
            .reshape(4 * by, 4 * bx)[:ny, :nx]
        out[c] = np.ascontiguousarray(img).view(np.float16)
    return out


# ---- PIZ -------------------------------------------------------------------
def _huf_table(data: bytes, off: int, im: int, iM: int) -> np.ndarray:
    """The packed code-length table of symbols im..iM -> (65537,) code
    lengths (0: no code)."""
    lengths = np.zeros(_HUF_ENCSIZE, np.int64)
    c = lc = 0
    i = im
    def bits(n):
        nonlocal c, lc, off
        while lc < n:
            c = ((c << 8) | data[off]) & 0xFFFFFF
            off += 1
            lc += 8
        lc -= n
        return (c >> lc) & ((1 << n) - 1)

    while i <= iM:
        ln = bits(6)
        if ln == _LONG_ZEROCODE_RUN:
            i += bits(8) + _SHORTEST_LONG_RUN
        elif ln >= _SHORT_ZEROCODE_RUN:
            i += ln - _SHORT_ZEROCODE_RUN + 2
        else:
            lengths[i] = ln
            i += 1
    if i > iM + 1:
        raise ValueError("EXR PIZ: Huffman table runs past its last symbol")
    return lengths


def _huf_canonical(lengths: np.ndarray):
    """OpenEXR's canonical codes of the code lengths -> (first, count,
    start, sym): the codes of length l are first[l] .. first[l] +
    count[l] - 1, of the symbols sym[start[l]:start[l] + count[l]] in
    increasing order."""
    count = np.bincount(lengths, minlength=_HUF_MAX_LEN + 1)[:_HUF_MAX_LEN
                                                              + 1]
    count[0] = 0
    first = np.zeros(_HUF_MAX_LEN + 1, np.int64)
    c = 0
    for ln in range(_HUF_MAX_LEN, 0, -1):    # longest codes lowest
        first[ln] = c
        c = (c + int(count[ln])) >> 1
    order = np.argsort(lengths, kind="stable")
    sym = order[lengths[order] > 0].astype(np.int32)
    start = np.zeros(_HUF_MAX_LEN + 1, np.int64)
    start[1:] = np.cumsum(count)[:-1]
    return first, count.astype(np.int64), start, sym


def _huf_decode_plain(tables, data: bytes, off: int, nbits: int, rlc: int,
                      nraw: int) -> np.ndarray:
    """The Huffman decode loop in Python (the plain version of
    csrc/exr_huf.cpp): codes of up to K bits through one table lookup,
    longer codes length by length."""
    first, count, start, sym = tables
    lens = [ln for ln in range(1, _HUF_MAX_LEN + 1) if count[ln]]
    K = min(max(lens), 12)
    tsym = np.full(1 << K, -1, np.int64)
    tlen = np.zeros(1 << K, np.int64)
    for ln in lens:
        if ln > K:
            continue
        codes = first[ln] + np.arange(count[ln])
        lo = codes << (K - ln)
        idx = (lo[:, None] + np.arange(1 << (K - ln))).reshape(-1)
        tsym[idx] = np.repeat(sym[start[ln]:start[ln] + count[ln]],
                              1 << (K - ln))
        tlen[idx] = ln
    tsym, tlen = tsym.tolist(), tlen.tolist()
    longs = [(ln, int(first[ln]), int(count[ln]), int(start[ln]))
             for ln in lens if ln > K]
    symbols = sym.tolist()
    out = []
    c = lc = used = 0
    end = off + (nbits + 7) // 8
    while used < nbits:
        while lc < _HUF_MAX_LEN + 8 and off < end:
            c = (c << 8) | data[off]
            off += 1
            lc += 8
        w = (c >> (lc - K)) if lc >= K else (c << (K - lc))
        ln = tlen[w & ((1 << K) - 1)]
        if ln:
            s = tsym[w & ((1 << K) - 1)]
        else:
            for ln, f, n, st in longs:
                v = c >> (lc - ln) if lc >= ln else -1
                if f <= v < f + n:
                    s = symbols[st + v - f]
                    break
            else:
                raise ValueError("EXR PIZ: invalid Huffman code")
        if used + ln > nbits:
            raise ValueError("EXR PIZ: a Huffman code runs past the data")
        lc -= ln
        used += ln
        c &= (1 << lc) - 1
        if s == rlc:
            if used + 8 > nbits or not out:
                raise ValueError("EXR PIZ: invalid Huffman run")
            lc -= 8
            used += 8
            out.extend([out[-1]] * (c >> lc))
            c &= (1 << lc) - 1
        else:
            out.append(s)
    if len(out) != nraw:
        raise ValueError(f"EXR PIZ: {len(out)} values decoded, {nraw} "
                         "expected")
    return np.asarray(out, np.uint16)


def huf_library():
    """Build (once per source hash) and load csrc/exr_huf.cpp; raises if
    the compiler fails."""
    global _HUF_LIB
    if _HUF_LIB is None:
        from ..host_build import BUILD_DIR, compile_shared
        info = compile_shared(_HUF_SRC, BUILD_DIR, "EXR PIZ decode")
        lib = ctypes.CDLL(info["path"])
        p = ctypes.c_void_p
        lib.lrt_huf_decode.argtypes = [p, p, p, p, ctypes.c_int32, p,
                                       ctypes.c_int64, ctypes.c_int32, p,
                                       ctypes.c_int64]
        lib.lrt_huf_decode.restype = ctypes.c_int64
        _HUF_LIB = lib
    return _HUF_LIB


def _huf_decode_native(tables, data: bytes, off: int, nbits: int, rlc: int,
                       nraw: int) -> np.ndarray:
    """The Huffman decode loop in C++ (csrc/exr_huf.cpp)."""
    first, count, start, sym = (np.ascontiguousarray(a) for a in tables)
    stream = np.frombuffer(data, np.uint8, (nbits + 7) // 8, off)
    out = np.empty(max(nraw, 1), np.uint16)
    max_len = max(ln for ln in range(_HUF_MAX_LEN + 1) if count[ln])
    rc = huf_library().lrt_huf_decode(
        first.ctypes.data, count.ctypes.data, start.ctypes.data,
        sym.ctypes.data, max_len, stream.ctypes.data, nbits, rlc,
        out.ctypes.data, nraw)
    if rc != nraw:
        raise ValueError(f"EXR PIZ: the Huffman decode failed ({rc})")
    return out[:nraw]


def huf_uncompress(data: bytes, nraw: int) -> np.ndarray:
    """PIZ's Huffman stage -> (nraw,) uint16.  data: the 20-byte header
    (min and max symbol, table bytes, bit count, a reserved word), the
    packed code-length table, then the bit stream, which
    `_huf_decode_native` decodes (a test puts the plain loop in its
    place)."""
    if len(data) < 20:
        if nraw:
            raise ValueError("EXR PIZ: no Huffman data")
        return np.zeros(0, np.uint16)
    im, iM, _, nbits = struct.unpack_from("<4I", data, 0)
    if not (0 <= im < _HUF_ENCSIZE and 0 <= iM < _HUF_ENCSIZE):
        raise ValueError("EXR PIZ: invalid Huffman table bounds")
    lengths = _huf_table(data, 20, im, iM)
    # the bit stream starts after the table's bytes
    off = 20 + struct.unpack_from("<I", data, 8)[0]
    if off + (nbits + 7) // 8 > len(data):
        raise ValueError("EXR PIZ: Huffman data truncated")
    return _huf_decode_native(_huf_canonical(lengths), data, off, nbits, iM,
                              nraw)


def _wdec14(lo, hi):
    """The 14-bit wavelet's inverse pair (signed 16-bit arithmetic)."""
    ls = (lo.astype(np.int32) ^ 0x8000) - 0x8000
    hs = (hi.astype(np.int32) ^ 0x8000) - 0x8000
    ai = ls + (hs & 1) + (hs >> 1)
    return (ai & 0xFFFF).astype(np.uint16), \
        ((ai - hs) & 0xFFFF).astype(np.uint16)


def _wdec16(lo, hi):
    """The 16-bit (modular) wavelet's inverse pair."""
    m = lo.astype(np.int32)
    d = hi.astype(np.int32)
    bb = (m - (d >> 1)) & 0xFFFF
    aa = (d + bb - 0x8000) & 0xFFFF
    return aa.astype(np.uint16), bb.astype(np.uint16)


def wav2_decode(a: np.ndarray, max_value: int) -> None:
    """PIZ's 2-D Haar wavelet decode of (ny, nx) uint16 `a`, in place,
    level by level from the coarsest; 14-bit arithmetic when every value
    is below 2^14, else modular 16-bit."""
    dec = _wdec14 if max_value < (1 << 14) else _wdec16
    ny, nx = a.shape
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        ey, ex = (ny // p2) * p2, (nx // p2) * p2
        if ey and ex:        # 2 x 2 quads at (y, x), (y, x + p), ...
            a00, a01 = a[0:ey:p2, 0:ex:p2], a[0:ey:p2, p:ex:p2]
            a10, a11 = a[p:ey:p2, 0:ex:p2], a[p:ey:p2, p:ex:p2]
            i00, i10 = dec(a00, a10)
            i01, i11 = dec(a01, a11)
            a00[...], a01[...] = dec(i00, i01)
            a10[...], a11[...] = dec(i10, i11)
        if nx & p and ey:    # the odd column, pairs down y
            c0, c1 = a[0:ey:p2, ex], a[p:ey:p2, ex]
            c0[...], c1[...] = dec(c0, c1)
        if ny & p and ex:    # the odd line, pairs along x
            r0, r1 = a[ey, 0:ex:p2], a[ey, p:ex:p2]
            r0[...], r1[...] = dec(r0, r1)
        p2 = p
        p >>= 1


def _piz(raw: bytes, chans, nx, ny):
    """PIZ: the bitmap of the 16-bit words in use, the Huffman-coded words
    (every channel's (ny, nx * size) plane in turn), each plane's wavelet
    decode, then the reverse lookup table of the bitmap."""
    lo, hi = struct.unpack_from("<HH", raw, 0)
    off = 4
    bitmap = np.zeros(8192, np.uint8)
    if lo <= hi:
        if hi >= 8192:
            raise ValueError("EXR PIZ: invalid bitmap range")
        bitmap[lo:hi + 1] = np.frombuffer(raw, np.uint8, hi - lo + 1, off)
        off += hi - lo + 1
    used = np.unpackbits(bitmap, bitorder="little").astype(bool)
    used[0] = True                   # zero is always in the table
    lut = np.flatnonzero(used).astype(np.uint16)
    length = struct.unpack_from("<i", raw, off)[0]
    off += 4
    sizes = [_PIX_SIZE[t] // 2 for _, t, _ in chans]
    words = huf_uncompress(raw[off:off + length], nx * ny * sum(sizes))
    out, pos = {}, 0
    for (c, t, _), k in zip(chans, sizes):
        plane = words[pos:pos + nx * ny * k].reshape(ny, nx * k)
        pos += nx * ny * k
        for j in range(k):     # each 16-bit word of a sample apart
            wav2_decode(plane[:, j::k], len(lut) - 1)
        out[c] = _words_to(lut[plane], t)
    return out


def _decode(comp, raw: bytes, chans, nx, ny):
    """One chunk -> {channel: (ny, nx) pixels}.  A chunk no smaller than
    its pixels is stored raw, whatever the file's compression."""
    if comp == _NONE or len(raw) >= ny * nx * sum(_PIX_SIZE[t]
                                                  for _, t, _ in chans):
        return _split_lines(raw, chans, nx, ny)
    if comp == _RLE:
        return _split_lines(_reorder_unpredict(_rle(raw)), chans, nx, ny)
    if comp in (_ZIPS, _ZIP):
        return _split_lines(_reorder_unpredict(zlib.decompress(raw)), chans,
                            nx, ny)
    if comp == _PIZ:
        return _piz(raw, chans, nx, ny)
    if comp == _PXR24:
        return _pxr24(zlib.decompress(raw), chans, nx, ny)
    return _b44(raw, chans, nx, ny)


def read_channels(path: str):
    """(channel names in file order, {name: (H, W) float32})."""
    with open(path, "rb") as f:
        buf = f.read()
    hdr, chunks = _chunks(buf, path)
    xmin, ymin, xmax, ymax = hdr["dw"]
    w, h = xmax - xmin + 1, ymax - ymin + 1
    # a line holds every channel in name order
    chans = sorted(hdr["channels"])
    out = {c: np.zeros((h, w), np.float32) for c, _, _ in chans}
    for x0, y0, nx, ny, raw in chunks:
        for c, pix in _decode(hdr["compression"], raw, chans, nx,
                              ny).items():
            out[c][y0:y0 + ny, x0:x0 + nx] = pix
    return [c for c, _, _ in hdr["channels"]], out


def read_exr(path: str) -> np.ndarray:
    """(H, W, 3) float32: R, G, B (alpha dropped), or Y, or the first
    channel, as grey."""
    _, out = read_channels(path)
    if all(c in out for c in "RGB"):
        return np.stack([out["R"], out["G"], out["B"]], -1)
    if "Y" in out:
        return np.repeat(out["Y"][..., None], 3, -1)
    first = next(iter(out.values()))
    return np.repeat(first[..., None], 3, -1)


def read_exr_any(path: str) -> np.ndarray:
    """(H, W, C) float32 with alpha kept: R, G, B(, A) when three of them
    are present, Y as grey, else every channel in file order."""
    names, out = read_channels(path)
    order = [n for n in "RGBA" if n in out]
    if len(order) >= 3:
        return np.stack([out[n] for n in order], -1)
    if "Y" in out:
        return np.repeat(out["Y"][..., None], 3, -1)
    return np.stack([out[n] for n in names], -1)


def write_exr(path: str, img: np.ndarray, half: bool = True):
    """Write (H, W), (H, W, 1..4) float pixels (channels R, G, B, A) as a
    ZIP-compressed scanline EXR of half (default) or float channels."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    names = ["R", "G", "B", "A"][:c]
    ptype = _PIX_HALF if half else _PIX_FLOAT
    np_t = _PIX_NP[ptype]

    hdr = bytearray(struct.pack("<ii", MAGIC, 2))

    def attr(name, atype, val):
        hdr.extend(name.encode() + b"\x00" + atype.encode() + b"\x00"
                   + struct.pack("<i", len(val)) + val)

    chan = bytearray()
    for n in sorted(names):
        chan += n.encode() + b"\x00" + struct.pack("<iiii", ptype, 0, 1, 1)
    chan += b"\x00"
    attr("channels", "chlist", bytes(chan))
    attr("compression", "compression", bytes([_ZIP]))
    attr("dataWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
    attr("displayWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
    attr("lineOrder", "lineOrder", bytes([0]))
    attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
    attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    hdr += b"\x00"

    lines_per_block = 16
    n_blocks = (h + lines_per_block - 1) // lines_per_block
    table_off = len(hdr)
    out = hdr + b"\x00" * (8 * n_blocks)
    chan_order = sorted(range(c), key=lambda i: names[i])
    for bi in range(n_blocks):
        y0 = bi * lines_per_block
        block = img[y0:y0 + lines_per_block][..., chan_order]
        # line-major, then channel, then pixel
        raw = block.transpose(0, 2, 1).astype(np_t).tobytes()
        comp = zlib.compress(_predict_reorder(raw))
        if len(comp) >= len(raw):
            comp = raw
        struct.pack_into("<q", out, table_off + 8 * bi, len(out))
        out += struct.pack("<ii", y0, len(comp)) + comp
    with open(path, "wb") as f:
        f.write(bytes(out))
