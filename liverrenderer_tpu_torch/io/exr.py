"""An OpenEXR codec (counterpart of liverrenderer_tpu/io/exr.py and of the
JAX package's native reader, native/exr_io.cpp, which reads through the
system OpenEXR): flat images, read; ZIP-compressed half or float files,
written.

Read: scanline and tiled files (one level, and level 0 of a mip- or
ripmap), single- or multi-part (part 0, as `Imf::InputFile` reads it), of
half, float and uint channels, with no, RLE, ZIPS, ZIP, PIZ, PXR24, B44 or
B44A compression, written from the OpenEXR file-format specification in
numpy, and DWAA/DWAB (lossy 8 x 8 DCT channels in the operation order of
OpenEXR's AVX decoder, with its to-linear table; run-length and zlib
channels), bit for bit as OpenEXR 3.1 decodes them.  PIZ's (and DWAA's AC)
Huffman decode loop runs in C++ (csrc/exr_huf.cpp, built at first use;
its plain Python version `_huf_decode_plain` is the reference the tests
hold it to); the rest of each codec is vectorised numpy.  A deep scanline
part is flattened as Imf::InputFile's compositor flattens it (`_read_deep`);
deep tiled parts, and channels with x or y subsampling, raise OSError, as
the JAX package's native reader does.

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


MAGIC = 20000630

_PIX_UINT, _PIX_HALF, _PIX_FLOAT = 0, 1, 2
_PIX_SIZE = {_PIX_UINT: 4, _PIX_HALF: 2, _PIX_FLOAT: 4}
_PIX_NP = {_PIX_UINT: np.dtype("<u4"), _PIX_HALF: np.dtype("<f2"),
           _PIX_FLOAT: np.dtype("<f4")}
_NONE, _RLE, _ZIPS, _ZIP, _PIZ, _PXR24, _B44, _B44A, _DWAA, _DWAB = \
    range(10)
_COMPRESSION = {_DWAA: "DWAA", _DWAB: "DWAB"}
# scan lines per chunk of a scanline file
_LINES = {_NONE: 1, _RLE: 1, _ZIPS: 1, _ZIP: 16, _PIZ: 32, _PXR24: 16,
          _B44: 32, _B44A: 32, _DWAA: 32, _DWAB: 256}
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
                    hdr["subsampled"] = cname
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
    hdr, off = _parse_header(buf, 8)
    multipart = bool(version & _MULTIPART)
    if multipart:       # the other parts' headers, then an empty one
        while buf[off] != 0:
            _, off = _parse_header(buf, off)
        off += 1
    if version & _DEEP and "type" not in hdr:
        raise OSError(f"EXR: a deep file without a type attribute: {path}")
    kind = hdr.get("type", "tiledimage" if version & _TILED
                   else "scanlineimage")
    hdr["kind"] = kind
    if kind not in ("scanlineimage", "tiledimage", "deepscanline"):
        # Imf::InputFile reads a deep scanline part through its compositor
        # and refuses the other part types
        raise OSError(f"EXR: cannot read parts of type {kind}: {path}")
    if "dw" not in hdr:
        raise ValueError(f"EXR file without a dataWindow: {path}")
    comp = hdr["compression"]
    if comp not in _LINES:
        raise OSError(f"EXR: unknown compression {comp}: {path}")
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
        elif kind == "deepscanline":
            # the packed sample-count table and pixel data, then the
            # data's unpacked size
            y, n_tab, n_dat, n_raw = struct.unpack_from("<iqqq", buf, c)
            c += 28
            chunks.append((0, y - ymin, w, min(_LINES[comp], h - y + ymin),
                           (buf[c:c + n_tab], buf[c + n_tab:c + n_tab + n_dat],
                            n_raw)))
            continue
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


# ---- DWAA / DWAB -------------------------------------------------------------
# a chunk's header: 11 little-endian uint64 (the stream sizes and counts)
(_DWA_VERSION, _DWA_UNKNOWN_RAW, _DWA_UNKNOWN_PACKED, _DWA_AC_PACKED,
 _DWA_DC_PACKED, _DWA_RLE_PACKED, _DWA_RLE_RAW, _DWA_RLE_OUT, _DWA_AC_COUNT,
 _DWA_DC_COUNT, _DWA_AC_CODEC) = range(11)
_DWA_UNKNOWN, _DWA_LOSSY, _DWA_RLE_SCHEME = 0, 1, 2
# the inverse DCT's constants, as OpenEXR's SIMD decoders store them:
# a = .5 cos(pi/4), b, d, e, g = .5 cos(k pi/16) for k = 1, 3, 5, 7,
# c, f = .5 cos(k pi/8) for k = 1, 3 (decimal literals rounded to float32)
_DWA_IDCT = np.array([3.535536e-01, 4.903927e-01, 4.619398e-01,
                      4.157349e-01, 2.777855e-01, 1.913422e-01, 9.754573e-02],
                     np.float32)
# each row pass output j is sum_k x_{2k} M1[k][j] (+/-) sum_k x_{2k+1}
# M2[k][j]
_A, _B, _C, _D, _E, _F, _G = _DWA_IDCT
_DWA_M1 = np.array([[_A, _A, _A, _A], [_C, _F, -_F, -_C], [_A, -_A, -_A, _A],
                    [_F, -_C, _C, -_F]], np.float32)
_DWA_M2 = np.array([[_B, _D, _E, _G], [_D, -_G, -_B, -_E], [_E, -_B, _G, _D],
                    [_G, -_E, _D, -_B]], np.float32)
_DWA_DC_ONLY = np.float32(3.535536e-01)
_TO_LINEAR = None


def dwa_to_linear_table() -> np.ndarray:
    """OpenEXR's dwaCompressorToLinear for every half bit pattern: |h| <= 1
    -> sign * |h|^2.2, else sign * (e^2.2)^(|h| - 1), in float32 rounded to
    half; 0 for zero, infinities and NaNs."""
    global _TO_LINEAR
    if _TO_LINEAR is None:
        bits = np.arange(1 << 16, dtype=np.uint32)
        h = bits.astype(np.uint16).view(np.float16).astype(np.float32)
        with np.errstate(all="ignore"):
            a = np.abs(h).astype(np.float64)
            log_base = np.float64(np.float32(2.7182818 ** 2.2))
            lin = np.where(a <= 1.0, a ** np.float64(np.float32(2.2)),
                           log_base ** (a - 1.0).astype(np.float32)
                           .astype(np.float64)).astype(np.float32)
            v = np.where(h < 0, -lin, lin).astype(np.float16) \
                .view(np.uint16)
        v[(bits & 0x7C00) == 0x7C00] = 0
        v[0] = 0
        _TO_LINEAR = v
    return _TO_LINEAR


# the rules of chunks before version 2, which carry none: (suffix,
# case-insensitive, scheme, csc index, pixel type)
_DWA_LEGACY_RULES = [
    (suf, True, _DWA_LOSSY, csc, t)
    for suf, csc in (("r", 0), ("red", 0), ("g", 1), ("grn", 1),
                     ("green", 1), ("b", 2), ("blu", 2), ("blue", 2),
                     ("y", -1), ("by", -1), ("ry", -1))
    for t in (_PIX_HALF, _PIX_FLOAT)] + [
    ("a", True, _DWA_RLE_SCHEME, -1, t)
    for t in (_PIX_UINT, _PIX_HALF, _PIX_FLOAT)]


def _dwa_rules(raw: bytes, off: int):
    """Version 2's channel rules -> ([(suffix, case-insensitive, scheme,
    csc index, pixel type)], offset past them)."""
    size = struct.unpack_from("<H", raw, off)[0]
    end, off = off + size, off + 2
    rules = []
    while off < end:
        suffix, off = _read_cstr(raw, off)
        val, ptype = raw[off], raw[off + 1]
        off += 2
        rules.append((suffix, bool(val & 1), (val >> 2) & 3, (val >> 4) - 1,
                      ptype))
    return rules, end


def _dwa_classify(chans, rules):
    """Each channel's scheme (the last rule matching its suffix and type)
    and the sets of R, G, B channels (csc 0, 1, 2) sharing a prefix, in
    prefix order -> (schemes, [(r, g, b) channel indices])."""
    schemes, sets = [], {}
    for i, (name, t, _) in enumerate(chans):
        prefix, _, suffix = name.rpartition(".")
        sets.setdefault(prefix, [-1, -1, -1])
        scheme = _DWA_UNKNOWN
        for suf, nocase, sch, csc, rt in rules:
            if rt == t and (suffix.lower() if nocase else suffix) == suf:
                scheme = sch
                if csc >= 0:
                    sets[prefix][csc] = i
        schemes.append(scheme)
    return schemes, [tuple(v) for _, v in sorted(sets.items())
                     if min(v) >= 0]


def _dwa_unpack_ac(ac: np.ndarray, n_blocks: int):
    """The AC stream (0xff00 ends a block, 0xffNN skips NN zeros, any other
    value is the next zig-zag coefficient) -> ((n_blocks, 64) uint16 half
    bits, coefficient 0 left zero, and each block's last position written
    (0: none))."""
    hi = ac >> 8
    adv = np.where(hi != 0xFF, 1, ac & 0xFF).astype(np.int64)
    adv[ac == 0xFF00] = 64
    csum = np.concatenate([[0], np.cumsum(adv)])
    starts = np.empty(n_blocks + 1, np.int64)
    s = 0
    for b in range(n_blocks):    # a block ends once 63 positions are filled
        starts[b] = s
        e = int(np.searchsorted(csum, csum[s] + 63, "left"))
        if e > len(ac):
            raise ValueError("EXR DWA: the AC stream ends inside a block")
        s = e
    starts[n_blocks] = s
    used = s
    blk = np.repeat(np.arange(n_blocks), np.diff(starts))
    idx = np.arange(used)
    pos = 1 + csum[idx] - csum[starts[blk]]
    lit = (hi[:used] != 0xFF) & (pos < 64)
    out = np.zeros((n_blocks, 64), np.uint16)
    out[blk[lit], pos[lit]] = ac[:used][lit]
    last = np.zeros(n_blocks, np.int64)
    np.maximum.at(last, blk[lit], pos[lit])
    return out, last, used


def _dwa_idct(x: np.ndarray) -> np.ndarray:
    """OpenEXR's 8 x 8 float inverse DCT over (N, 8, 8) float32 blocks, in
    the operation order of its AVX decoder (each operation rounded to
    float32): rows as a 4 x 4 matrix product on the even and on the odd
    coefficients (pairwise sums), then columns by the even/odd butterfly."""
    def pairs(t):
        return (t[0] + t[1]) + (t[2] + t[3])

    ev = pairs([x[:, :, 2 * k, None] * _DWA_M1[k] for k in range(4)])
    od = pairs([x[:, :, 2 * k + 1, None] * _DWA_M2[k] for k in range(4)])
    rows = np.concatenate([ev + od, (ev - od)[..., ::-1]], -1)
    v = [rows[:, k, :] for k in range(8)]
    a, b, c, d, e, f, g = _DWA_IDCT
    th0, th3 = a * v[0] + a * v[4], a * v[0] - a * v[4]
    th1, th2 = c * v[2] + f * v[6], f * v[2] - c * v[6]
    ga0, ga3, ga1, ga2 = th0 + th1, th0 - th1, th3 + th2, th3 - th2
    be0 = (b * v[1] + d * v[3]) + (e * v[5] + g * v[7])
    be1 = (d * v[1] - (g * v[3] + b * v[5])) - e * v[7]
    be2 = ((e * v[1] - b * v[3]) + g * v[5]) + d * v[7]
    be3 = (g * v[1] + d * v[5]) - (e * v[3] + b * v[7])
    return np.stack([ga0 + be0, ga1 + be1, ga2 + be2, ga3 + be3,
                     ga3 - be3, ga2 - be2, ga1 - be1, ga0 - be0], 1)


def _dwa_lossy(dc: np.ndarray, ac: np.ndarray, last: np.ndarray, n: int,
               nx: int, ny: int) -> list:
    """One decoder's n components: (n * nb,) DC half bits (plane after
    plane), (nb * n, 64) AC half bits (block after block, its components in
    turn) -> n (ny, nx) planes of float32 still to be colour-converted."""
    bx, by = -(-nx // 8), -(-ny // 8)
    nb = bx * by
    zz = np.zeros((nb, n, 64), np.uint16)
    zz[:] = ac.reshape(nb, n, 64)
    zz[:, :, 0] = dc.reshape(n, nb).T
    coef = zz.view(np.float16).astype(np.float32)
    from .jpeg import ZIGZAG
    nat = np.empty_like(coef)
    nat[..., ZIGZAG] = coef
    out = _dwa_idct(nat.reshape(-1, 8, 8)).reshape(nb, n, 64)
    # a block with no AC value: every sample is DC * c * c
    dc_only = last.reshape(nb, n) == 0
    flat = coef[..., 0] * _DWA_DC_ONLY * _DWA_DC_ONLY
    out = np.where(dc_only[..., None], flat[..., None], out)
    return [out[:, k].reshape(by, bx, 8, 8).transpose(0, 2, 1, 3)
            .reshape(8 * by, 8 * bx)[:ny, :nx] for k in range(n)]


def _dwa(raw: bytes, chans, nx, ny):
    """DWAA and DWAB: lossy 8 x 8 DCT channels (R, G, B sets through
    Y'CbCr), run-length (RLE) channels and zlib (UNKNOWN) channels, each
    stream as the chunk header sizes it."""
    hdr = struct.unpack_from("<11Q", raw, 0)
    if hdr[_DWA_VERSION] > 2:
        raise OSError(f"EXR DWA: chunk version {hdr[_DWA_VERSION]}")
    if hdr[_DWA_VERSION] == 2:
        rules, off = _dwa_rules(raw, 88)
    else:
        rules, off = _DWA_LEGACY_RULES, 88
    sizes = [hdr[_DWA_UNKNOWN_PACKED], hdr[_DWA_AC_PACKED],
             hdr[_DWA_DC_PACKED], hdr[_DWA_RLE_PACKED]]
    bounds = np.cumsum([off] + sizes)
    unknown, ac_raw, dc_raw, rle_raw = (raw[bounds[i]:bounds[i + 1]]
                                        for i in range(4))
    schemes, sets = _dwa_classify(chans, rules)
    out = {}
    # the run-length channels: zlib, the signed-count RLE, then each
    # channel's byte planes in turn
    if hdr[_DWA_RLE_OUT]:
        planes = np.frombuffer(_rle(zlib.decompress(rle_raw)), np.uint8)
        pos = 0
        for (c, t, _), sch in zip(chans, schemes):
            if sch != _DWA_RLE_SCHEME:
                continue
            k = _PIX_SIZE[t]
            bytes_ = planes[pos:pos + k * nx * ny].reshape(k, ny, nx)
            pos += k * nx * ny
            out[c] = np.ascontiguousarray(bytes_.transpose(1, 2, 0)) \
                .view(_PIX_NP[t])[..., 0]
    # the UNKNOWN channels: zlib, each channel's lines in turn
    if hdr[_DWA_UNKNOWN_PACKED]:
        data = zlib.decompress(unknown)
        pos = 0
        for (c, t, _), sch in zip(chans, schemes):
            if sch == _DWA_UNKNOWN:
                n = _PIX_SIZE[t] * nx * ny
                out[c] = np.frombuffer(data, _PIX_NP[t], nx * ny, pos) \
                    .reshape(ny, nx)
                pos += n
    # the lossy channels: the R, G, B sets first, then the rest in order
    groups = [list(st) for st in sets]
    in_sets = {i for st in sets for i in st}
    groups += [[i] for i, sch in enumerate(schemes)
               if sch == _DWA_LOSSY and i not in in_sets]
    if not groups:
        return out
    nb = -(-nx // 8) * -(-ny // 8)
    n_ac = hdr[_DWA_AC_COUNT]
    if hdr[_DWA_AC_CODEC] == 0:
        ac = huf_uncompress(ac_raw, n_ac) if n_ac else \
            np.zeros(0, np.uint16)
    else:
        ac = np.frombuffer(zlib.decompress(ac_raw), "<u2")
    dc = np.frombuffer(_reorder_unpredict(zlib.decompress(dc_raw)), "<u2")
    total = sum(len(gr) for gr in groups) * nb
    ac_blocks, last, _ = _dwa_unpack_ac(ac, total)
    lut = dwa_to_linear_table()
    pos = 0
    for gr in groups:
        n = len(gr)
        planes = _dwa_lossy(dc[pos:pos + n * nb], ac_blocks[pos:pos + n * nb],
                            last[pos:pos + n * nb], n, nx, ny)
        pos += n * nb
        if n == 3:       # Rec. 709 Y'CbCr -> R'G'B'
            y, cb, cr = planes
            planes = [y + np.float32(1.5747) * cr,
                      y - np.float32(0.1873) * cb - np.float32(0.4682) * cr,
                      y + np.float32(1.8556) * cb]
        for i, pl in zip(gr, planes):
            c, t, linear = chans[i]
            bits = pl.astype(np.float16).view(np.uint16)
            if n == 3 or not linear:
                bits = lut[bits]
            half = bits.view(np.float16)
            out[c] = half if t == _PIX_HALF else half.astype(np.float32)
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
    if comp in (_DWAA, _DWAB):
        return _dwa(raw, chans, nx, ny)
    return _b44(raw, chans, nx, ny)


def _unpack_bytes(comp, raw: bytes, n: int) -> bytes:
    """A deep chunk's table or data: n bytes, stored raw unless packing
    made them smaller (none, RLE, ZIPS and ZIP are a deep part's codecs)."""
    if comp == _NONE or len(raw) >= n:
        return raw[:n]
    if comp == _RLE:
        return _reorder_unpredict(_rle(raw))
    if comp in (_ZIPS, _ZIP):
        return _reorder_unpredict(zlib.decompress(raw))
    raise OSError(f"EXR: compression {comp} in a deep part")


def _read_deep(hdr, chunks, chans, w, h):
    """A deep scanline part flattened as Imf::InputFile's compositor does
    it (CompositeDeepScanLine, one source): each pixel's samples in the
    order stored, every channel (Z too) summed as out += (1 - alpha) *
    sample in float32, alpha the composited A before the sample, until
    alpha reaches 1.  It needs Z and A channels."""
    names = [c for c, _, _ in chans]
    for need, what in (("Z", "a Z channel"), ("A", "an alpha channel")):
        if need not in names:
            raise OSError(f"Deep data provided to CompositeDeepScanLine is "
                          f"missing {what}")
    comp = hdr["compression"]
    out = {c: np.zeros((h, w), np.float32) for c in names}
    for _, y0, nx, ny, (tab, dat, n_raw) in chunks:
        cum = np.frombuffer(_unpack_bytes(comp, tab, 4 * nx * ny), "<i4") \
            .reshape(ny, nx).astype(np.int64)
        counts = np.diff(np.concatenate([np.zeros((ny, 1), np.int64), cum],
                                        1), axis=1)
        data = _unpack_bytes(comp, dat, n_raw)
        pos = 0
        samples = {c: [] for c in names}
        # each line holds every channel's samples, pixel by pixel
        for line in range(ny):
            n = int(cum[line, -1]) if nx else 0
            for c, t, _ in chans:
                samples[c].append(np.frombuffer(data, _PIX_NP[t], n, pos)
                                  .astype(np.float32))
                pos += n * _PIX_SIZE[t]
        vals = {c: np.concatenate(v) if v else np.zeros(0, np.float32)
                for c, v in samples.items()}
        cnt = counts.reshape(-1)
        first = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        acc = {c: np.zeros(nx * ny, np.float32) for c in names}
        done = np.zeros(nx * ny, bool)
        for k in range(int(cnt.max()) if cnt.size else 0):
            alpha = acc["A"].copy()
            done |= alpha >= np.float32(1)
            live = (k < cnt) & ~done
            idx = first[live] + k
            for c in names:
                acc[c][live] += (np.float32(1) - alpha[live]) * vals[c][idx]
        for c in names:
            out[c][y0:y0 + ny] = acc[c].reshape(ny, nx)
    return out


def read_channels(path: str):
    """(channel names in file order, {name: (H, W) float32})."""
    with open(path, "rb") as f:
        buf = f.read()
    hdr, chunks = _chunks(buf, path)
    if "subsampled" in hdr:
        # Imf::InputFile refuses the 1 x 1 float frame buffer for it
        raise OSError(f"EXR: the x and/or y subsampling factors of channel "
                      f"{hdr['subsampled']!r} of {path} are not 1")
    xmin, ymin, xmax, ymax = hdr["dw"]
    w, h = xmax - xmin + 1, ymax - ymin + 1
    # a line holds every channel in name order
    chans = sorted(hdr["channels"])
    if hdr["kind"] == "deepscanline":
        return ([c for c, _, _ in hdr["channels"]],
                _read_deep(hdr, chunks, chans, w, h))
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
