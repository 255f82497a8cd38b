"""Zstandard frames (RFC 8878) as libtiff 4.7's ZSTD codec (compression
50000) has libzstd decode them for Pillow, with no zstd package.

- The frame: its header (window, dictionary ID, content size, checksum
  flag), raw, RLE and compressed blocks, the content checksum (XXH64's
  low 32 bits).  A skippable frame, a dictionary, a reserved bit or block
  type is an error.
- A compressed block: literals raw, RLE, Huffman-coded in 1 or 4 streams
  (the tree's weights direct or FSE-coded) or treeless (the frame's last
  tree again); sequences under the predefined, RLE, FSE-coded or repeated
  literal-length, offset and match-length tables, the three repeat
  offsets (1, 4, 8 at the frame's start), matches within what the frame
  has decoded.
- libtiff's ZSTDDecode asks ZSTD_decompressStream for a strip's bytes:
  a frame with its content size, whole in the strip and no larger than the
  strip, is decoded in one pass (any error fails); otherwise block by
  block until the strip is full, libzstd going on to the next block (and
  the checksum) only when a block filled the strip exactly.  Fewer bytes
  than the strip holds fail it (Pillow's "decoder error").

The frame loop runs in C++ (csrc/zstd.cpp, built at first use like
csrc/lzw.cpp; a failed build raises); `_decode_plain` is its plain Python
version with the same contract.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "zstd.cpp"
_LIB = None

MAGIC, SKIP_MAGIC = 0xFD2FB528, 0x184D2A50
BLOCK_MAX = 1 << 17
WINDOWLOG_MAX = 31
# the code tables: literal lengths (baseline, extra bits), match lengths
LL_BASE = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3),
    (48, 4), (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11),
    (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
ML_BASE = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3),
    (67, 4), (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10),
    (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15),
    (65539, 16)]
# the predefined distributions (accuracy log, normalised counts)
LL_DEFAULT = (6, [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
                  2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1])
ML_DEFAULT = (6, [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                  1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1])
OF_DEFAULT = (5, [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                  1, 1, 1, 1, -1, -1, -1, -1, -1])
# (max symbol, max accuracy log) of LL, OF, ML
_LIMITS = ((35, 9), (31, 8), (52, 9))


def library():
    """Build (once per source hash) and load csrc/zstd.cpp; raises if the
    compiler fails."""
    global _LIB
    if _LIB is None:
        from ..host_build import BUILD_DIR, compile_shared
        info = compile_shared(_SRC, BUILD_DIR, "Zstandard decode")
        lib = ctypes.CDLL(info["path"])
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.lrt_zstd_decode.argtypes = [p, i64, p, i64]
        lib.lrt_zstd_decode.restype = i64
        _LIB = lib
    return _LIB


def decode(src: bytes, occ: int) -> bytes | None:
    """The bytes libzstd gives libtiff for a strip or tile of `occ` bytes
    (at most occ), or None where it fails with an error."""
    buf = np.frombuffer(src, np.uint8) if src else np.zeros(1, np.uint8)
    dst = np.zeros(max(occ, 1), np.uint8)
    n = library().lrt_zstd_decode(buf.ctypes.data, len(src), dst.ctypes.data,
                                  occ)
    return None if n < 0 else dst[:n].tobytes()


def decode_tiff(src: bytes, occ: int) -> bytes:
    """libtiff's ZSTDDecode: `occ` bytes, or OSError (Pillow's decoder
    error) on an error or a short strip."""
    out = decode(src, occ)
    if out is None or len(out) < occ:
        raise OSError("decoder error -2")
    return out


# ------------------------------------------------------ plain version ----
class ZstdError(Exception):
    """A stream libzstd refuses."""


_M64 = (1 << 64) - 1
_P1, _P2, _P3, _P4, _P5 = (11400714785074694791, 14029467366897019727,
                           1609587929392839161, 9650029242287828579,
                           2870177450012600261)


def _rotl(x, r):
    return ((x << r) | (x >> (64 - r))) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data`."""
    n = len(data)
    p = 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed,
             (seed - _P1) & _M64]
        while p + 32 <= n:
            for k in range(4):
                lane = int.from_bytes(data[p:p + 8], "little")
                v[k] = (_rotl((v[k] + lane * _P2) & _M64, 31) * _P1) & _M64
                p += 8
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
             + _rotl(v[3], 18)) & _M64
        for k in range(4):
            h ^= (_rotl((v[k] * _P2) & _M64, 31) * _P1) & _M64
            h = (h * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        k1 = (_rotl((int.from_bytes(data[p:p + 8], "little") * _P2) & _M64,
                    31) * _P1) & _M64
        h = (_rotl(h ^ k1, 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h = (_rotl(h ^ (int.from_bytes(data[p:p + 4], "little") * _P1
                        & _M64), 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h = (_rotl(h ^ (data[p] * _P5 & _M64), 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


def _highbit(x: int) -> int:
    return x.bit_length() - 1


class _Back:
    """A backward bit stream (the last byte's highest set bit marks its
    start); bits read past its beginning are zeros."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError("no end mark")
        self.v = int.from_bytes(data, "little")
        self.pos = 8 * len(data) - (8 - _highbit(data[-1]))

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        if self.pos >= 0:
            return (self.v >> self.pos) & ((1 << n) - 1)
        return ((self.v << -self.pos) & ((1 << n) - 1)) if self.pos > -n \
            else 0

    def peek(self, n: int) -> int:
        pos = self.pos - n
        if pos >= 0:
            return (self.v >> pos) & ((1 << n) - 1)
        return (self.v << -pos) & ((1 << n) - 1)


def _read_ncount(data: bytes, max_sym: int):
    """FSE_readNCount -> (accuracy log, normalised counts, bytes used)."""
    buf = data if len(data) >= 8 else data + bytes(8 - len(data))
    v = int.from_bytes(buf, "little")
    pos = 0

    def bits(n):
        nonlocal pos
        r = (v >> pos) & ((1 << n) - 1)
        pos += n
        return r

    log = bits(4) + 5
    if log > 15:
        raise ZstdError("table log too large")
    remaining, threshold, nbits = (1 << log) + 1, 1 << log, log + 1
    counts = []
    prev0 = False
    while True:
        if prev0:
            while True:
                r = bits(2)
                counts += [0] * r
                if r != 3:
                    break
            if len(counts) > max_sym:
                break
        mx = 2 * threshold - 1 - remaining
        low = (v >> pos) & (threshold - 1)
        if low < mx:
            count = low
            pos += nbits - 1
        else:
            count = (v >> pos) & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            pos += nbits
        count -= 1
        remaining -= abs(count)
        counts.append(count)
        prev0 = count == 0
        if remaining < threshold:
            if remaining <= 1:
                break
            nbits = _highbit(remaining) + 1
            threshold = 1 << (nbits - 1)
        if len(counts) > max_sym:
            break
    used = (pos + 7) // 8
    if remaining != 1 or len(counts) > max_sym + 1 or used > len(data):
        raise ZstdError("bad table description")
    return log, counts, used


def _fse_table(log: int, counts):
    """ZSTD_buildFSETable -> [(symbol, nbBits, baseline)] of 2^log
    states."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    nxt = []
    for s, c in enumerate(counts):
        if c == -1:
            sym[high] = s
            high -= 1
            nxt.append(1)
        else:
            nxt.append(c)
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            sym[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        raise ZstdError("bad table spread")
    table = []
    for u in range(size):
        s = sym[u]
        n = nxt[s]
        nxt[s] += 1
        nb = log - _highbit(n)
        table.append((s, nb, (n << nb) - size))
    return table


def _huf_weights(data: bytes, p: int):
    """HUF_readStats -> (weights of every symbol, table log, new p)."""
    if p >= len(data):
        raise ZstdError("no Huffman header")
    head = data[p]
    if head >= 128:
        n = head - 127
        size = (n + 1) // 2
        if p + 1 + size > len(data):
            raise ZstdError("short Huffman header")
        w = []
        for b in data[p + 1:p + 1 + size]:
            w += [b >> 4, b & 15]
        w = w[:n]
        p += 1 + size
    else:
        if p + 1 + head > len(data):
            raise ZstdError("short Huffman header")
        w = _fse_weights(data[p + 1:p + 1 + head])
        p += 1 + head
    if any(x > 12 for x in w):
        raise ZstdError("bad Huffman weight")
    total = sum((1 << x) >> 1 for x in w)
    if total == 0:
        raise ZstdError("no Huffman weights")
    log = _highbit(total) + 1
    if log > 12:
        raise ZstdError("Huffman table log too large")
    rest = (1 << log) - total
    if rest & (rest - 1):
        raise ZstdError("Huffman weights do not sum to a power of two")
    w.append(_highbit(rest) + 1)
    if w.count(1) < 2 or w.count(1) & 1:
        raise ZstdError("bad Huffman tree")
    return w, log, p


def _fse_weights(data: bytes):
    """FSE_decompress of the Huffman weights: two interleaved states."""
    log, counts, used = _read_ncount(data, 255)
    if log > 6:
        raise ZstdError("weight table log too large")
    table = _fse_table(log, counts)
    bs = _Back(data[used:])
    s1, s2 = bs.read(log), bs.read(log)
    out = []
    while True:
        if len(out) > 253:
            raise ZstdError("too many weights")
        e = table[s1]
        out.append(e[0])
        s1 = e[2] + bs.read(e[1])
        if bs.pos < 0:
            out.append(table[s2][0])
            break
        if len(out) > 253:
            raise ZstdError("too many weights")
        e = table[s2]
        out.append(e[0])
        s2 = e[2] + bs.read(e[1])
        if bs.pos < 0:
            out.append(table[s1][0])
            break
    return out


def _huf_table(weights, log):
    """HUF_readDTableX1 -> [(symbol, nbBits)] of 2^log entries."""
    rank = [0] * (log + 2)
    for w in weights:
        rank[w] += 1
    start, nxt = [0] * (log + 2), 0
    for w in range(1, log + 1):
        start[w] = nxt
        nxt += rank[w] << (w - 1)
    table = [(0, 0)] * (1 << log)
    for s, w in enumerate(weights):
        if w:
            n = (1 << w) >> 1
            table[start[w]:start[w] + n] = [(s, log + 1 - w)] * n
            start[w] += n
    return table


def _huf_stream(data: bytes, n: int, table, log) -> bytes:
    bs = _Back(data)
    out = bytearray(n)
    for i in range(n):
        s, nb = table[bs.peek(log)]
        out[i] = s
        bs.pos -= nb
    if bs.pos != 0:
        raise ZstdError("Huffman stream not consumed exactly")
    return bytes(out)


class _Frame:
    def __init__(self):
        self.huf = None
        self.tables = [None, None, None]      # LL, OF, ML
        self.reps = [1, 4, 8]

    def literals(self, b: bytes):
        """The literals section -> (literals, bytes used)."""
        kind, sf = b[0] & 3, (b[0] >> 2) & 3
        if kind in (0, 1):
            if sf in (0, 2):
                size, hs = b[0] >> 3, 1
            elif sf == 1:
                if len(b) < 2:
                    raise ZstdError("short literals header")
                size, hs = (b[0] >> 4) + (b[1] << 4), 2
            else:
                if len(b) < 3:
                    raise ZstdError("short literals header")
                size, hs = (b[0] >> 4) + (b[1] << 4) + (b[2] << 12), 3
            if size > BLOCK_MAX:
                raise ZstdError("literals too large")
            if kind == 0:
                if hs + size > len(b):
                    raise ZstdError("short raw literals")
                return b[hs:hs + size], hs + size
            if hs + 1 > len(b):
                raise ZstdError("short RLE literals")
            return bytes([b[hs]]) * size, hs + 1
        hs = {0: 3, 1: 3, 2: 4, 3: 5}[sf]
        if len(b) < hs:
            raise ZstdError("short literals header")
        v = int.from_bytes(b[:hs], "little") >> 4
        bits = {0: 10, 1: 10, 2: 14, 3: 18}[sf]
        size, csize = v & ((1 << bits) - 1), v >> bits
        if size > BLOCK_MAX:
            raise ZstdError("literals too large")
        if hs + csize > len(b):
            raise ZstdError("short compressed literals")
        data = b[hs:hs + csize]
        p = 0
        if kind == 2:
            w, log, p = _huf_weights(data, 0)
            self.huf = (_huf_table(w, log), log)
        elif self.huf is None:
            raise ZstdError("treeless literals without a tree")
        table, log = self.huf
        if sf == 0:
            return _huf_stream(data[p:], size, table, log), hs + csize
        body = data[p:]
        if len(body) < 10 or size < 6:
            raise ZstdError("bad 4-stream literals")
        l1, l2, l3 = (int.from_bytes(body[k:k + 2], "little")
                      for k in (0, 2, 4))
        l4 = len(body) - 6 - l1 - l2 - l3
        if l4 < 0:
            raise ZstdError("bad jump table")
        seg = (size + 3) // 4
        if 3 * seg > size:
            raise ZstdError("bad 4-stream literals")
        out, q = b"", 6
        for k, length in enumerate((l1, l2, l3, l4)):
            out += _huf_stream(body[q:q + length],
                               seg if k < 3 else size - 3 * seg, table, log)
            q += length
        return out, hs + csize

    def sequences(self, b: bytes, lits: bytes, out: bytearray, limit: int):
        """Append the block's sequences to `out`, which may not grow past
        `limit` (checked before each sequence, as ZSTD_execSequence does)."""
        if not b:
            raise ZstdError("no sequences header")
        n = b[0]
        p = 1
        if n >= 128:
            if n < 255:
                if len(b) < 2:
                    raise ZstdError("short sequences header")
                n, p = ((n - 128) << 8) + b[1], 2
            else:
                if len(b) < 3:
                    raise ZstdError("short sequences header")
                n, p = b[1] + (b[2] << 8) + 0x7F00, 3
        if n == 0:
            if p != len(b):
                raise ZstdError("data after an empty sequences section")
            if len(out) + len(lits) > limit:
                raise ZstdError("block decodes too large")
            out += lits
            return
        if p >= len(b):
            raise ZstdError("no compression modes")
        modes = b[p]
        p += 1
        if modes & 3:
            raise ZstdError("reserved compression mode bits")
        for k, shift, default in ((0, 6, LL_DEFAULT), (1, 4, OF_DEFAULT),
                                  (2, 2, ML_DEFAULT)):
            mode = (modes >> shift) & 3
            max_sym, max_log = _LIMITS[k]
            if mode == 0:
                self.tables[k] = (_fse_table(*default), default[0])
            elif mode == 1:
                if p >= len(b):
                    raise ZstdError("no RLE symbol")
                if b[p] > max_sym:
                    raise ZstdError("RLE symbol out of range")
                self.tables[k] = ([(b[p], 0, 0)], 0)
                p += 1
            elif mode == 2:
                log, counts, used = _read_ncount(b[p:], max_sym)
                if log > max_log:
                    raise ZstdError("table log too large")
                self.tables[k] = (_fse_table(log, counts), log)
                p += used
            elif self.tables[k] is None:
                raise ZstdError("repeated table without one")
        (ll_t, ll_log), (of_t, of_log), (ml_t, ml_log) = self.tables
        bs = _Back(b[p:])
        sl, so, sm = bs.read(ll_log), bs.read(of_log), bs.read(ml_log)
        lp = 0
        reps = self.reps
        for i in range(n):
            of_code, ml_code, ll_code = of_t[so][0], ml_t[sm][0], ll_t[sl][0]
            if of_code > 31:
                raise ZstdError("offset code out of range")
            ll0 = ll_code == 0
            if of_code > 1:
                off = (1 << of_code) + bs.read(of_code) - 3
                reps[2], reps[1], reps[0] = reps[1], reps[0], off
            elif of_code == 0:
                off = reps[1] if ll0 else reps[0]
                reps[1] = reps[0] if ll0 else reps[1]
                reps[0] = off
            else:
                idx = 1 + ll0 + bs.read(1)
                off = reps[0] - 1 if idx == 3 else reps[idx]
                if off == 0:
                    off = -1
                if idx != 1:
                    reps[2] = reps[1]
                reps[1], reps[0] = reps[0], off
            base, nb = ML_BASE[ml_code]
            ml = base + bs.read(nb)
            base, nb = LL_BASE[ll_code]
            ll = base + bs.read(nb)
            if i < n - 1:
                e = ll_t[sl]
                sl = e[2] + bs.read(e[1])
                e = ml_t[sm]
                sm = e[2] + bs.read(e[1])
                e = of_t[so]
                so = e[2] + bs.read(e[1])
            if lp + ll > len(lits):
                raise ZstdError("literal length past the literals")
            if len(out) + ll + ml > limit:
                raise ZstdError("block decodes too large")
            out += lits[lp:lp + ll]
            lp += ll
            if off <= 0 or off > len(out):
                raise ZstdError("offset past the window")
            start = len(out) - off
            if off >= ml:
                out += out[start:start + ml]
            else:
                for k in range(ml):
                    out.append(out[start + k])
        if bs.pos != 0:
            raise ZstdError("sequence bits not consumed exactly")
        if len(out) + len(lits) - lp > limit:
            raise ZstdError("block decodes too large")
        out += lits[lp:]


def _frame_header(src: bytes):
    """-> dict of the frame header's fields and its size, or ZstdError."""
    if len(src) < 4:
        raise ZstdError("short frame")
    magic = int.from_bytes(src[:4], "little")
    if magic & 0xFFFFFFF0 == SKIP_MAGIC:
        raise ZstdError("skippable frame")
    if magic != MAGIC:
        raise ZstdError("unknown magic")
    if len(src) < 5:
        raise ZstdError("short frame header")
    fhd = src[4]
    fcs_flag, single, checksum, did_flag = fhd >> 6, (fhd >> 5) & 1, \
        (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError("reserved frame header bit")
    did_size = (0, 1, 2, 4)[did_flag]
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    hs = 5 + (0 if single else 1) + did_size + fcs_size
    if len(src) < hs:
        raise ZstdError("short frame header")
    p = 5
    window = None
    if not single:
        wd = src[p]
        wlog = 10 + (wd >> 3)
        if wlog > WINDOWLOG_MAX:
            raise ZstdError("window too large")
        base = 1 << wlog
        window = base + (base >> 3) * (wd & 7)
        p += 1
    did = int.from_bytes(src[p:p + did_size], "little")
    p += did_size
    fcs = None
    if fcs_size:
        fcs = int.from_bytes(src[p:p + fcs_size], "little")
        if fcs_size == 2:
            fcs += 256
    if did:
        raise ZstdError("dictionary")
    if single:
        window = fcs
    return dict(size=hs, window=window, fcs=fcs, checksum=checksum)


def _frame_size(src: bytes, h) -> int:
    """ZSTD_findFrameCompressedSize: the frame's bytes, walking its block
    headers (past the end of `src` where they run out)."""
    p = h["size"]
    while True:
        if p + 3 > len(src):
            return len(src) + 1
        bh = int.from_bytes(src[p:p + 3], "little")
        if (bh >> 1) & 3 == 3:
            return len(src) + 1
        p += 3 + (1 if (bh >> 1) & 3 == 1 else bh >> 3)
        if bh & 1:
            return p + 4 * h["checksum"]


def _decode_plain(src: bytes, occ: int) -> bytes | None:
    """decode's plain Python version."""
    try:
        h = _frame_header(src)
    except ZstdError:
        return None
    one_pass = h["fcs"] is not None and h["fcs"] <= occ \
        and _frame_size(src, h) <= len(src)
    if not one_pass and h["window"] > 1 << 27:
        return None                        # ZSTD_WINDOWLOG_LIMIT_DEFAULT
    block_max = min(h["window"], BLOCK_MAX)
    fr = _Frame()
    out = bytearray()
    p = h["size"]
    filled_at = None                  # streaming: the block that filled occ
    try:
        while True:
            if not one_pass and len(out) >= occ:
                if len(out) > occ or filled_at is not None:
                    return bytes(out[:occ])
                filled_at = len(out)
            if p + 3 > len(src):
                if one_pass:
                    raise ZstdError("short block header")
                return bytes(out[:occ])         # libzstd waits for data
            bh = int.from_bytes(src[p:p + 3], "little")
            last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
            p += 3
            if btype == 3:
                raise ZstdError("reserved block type")
            csize = 1 if btype == 1 else bsize
            if p + csize > len(src):
                if one_pass:
                    raise ZstdError("short block")
                return bytes(out[:occ])         # libzstd waits for data
            body = src[p:p + csize]
            p += csize
            if btype == 0:
                out += body
            elif btype == 1:
                out += body * bsize
            else:
                if bsize > block_max:
                    raise ZstdError("block too large")
                if not body:
                    raise ZstdError("empty compressed block")
                lits, used = fr.literals(body)
                limit = len(out) + block_max
                fr.sequences(body[used:], lits, out,
                             min(limit, occ) if one_pass else limit)
            if one_pass and len(out) > occ:
                raise ZstdError("output too large")
            if last:
                break
        if h["fcs"] is not None and len(out) != h["fcs"]:
            raise ZstdError("content size mismatch")
        if h["checksum"] and (one_pass or len(out) <= occ):
            if p + 4 > len(src):
                if one_pass:
                    raise ZstdError("no checksum")
                return bytes(out[:occ])
            if int.from_bytes(src[p:p + 4], "little") != \
                    xxh64(bytes(out)) & 0xFFFFFFFF:
                raise ZstdError("checksum mismatch")
    except ZstdError:
        return None
    return bytes(out[:occ])
