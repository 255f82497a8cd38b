"""The LZW decoders of TIFF (io/tiff.py) and GIF (io/gif.py): the loops run
in C++ (csrc/lzw.cpp, built at first use by host_build.compile_shared; a
failed build raises, and nothing falls back), and `_lzw_tiff_plain` and
`_lzw_gif_plain` are their plain Python versions with the same contract.

TIFF's LZW is libtiff's: codes MSB-first, 9 to 12 bits, the width growing
one code early, or with `compat` its old style (LZWDecodeCompat): codes
LSB-first, the width growing when the next free code reaches 2^bits.
GIF's is Pillow's GifDecode.c with ImageFile.load's feeding around it:
codes LSB-first in sub-blocks, a deferred clear past 4,096 entries, the
KwKwK case, and a stream that ends early (or an end code before the
frame is full, with nothing more in the file) reported as a truncated
file.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "lzw.cpp"
_LIB = None

# the bytes Pillow's ImageFile.load reads at a time (decodermaxblock)
GIF_CHUNK = 65536
# GifDecode.c's error codes -> Pillow's messages
_GIF_ERRORS = {-1: "buffer overrun when reading image file",
               -2: "broken data stream when reading image file",
               -8: "codec configuration error when reading image file"}


def library():
    """Build (once per source hash) and load csrc/lzw.cpp; raises if the
    compiler fails."""
    global _LIB
    if _LIB is None:
        from ..host_build import BUILD_DIR, compile_shared
        info = compile_shared(_SRC, BUILD_DIR, "LZW decode")
        lib = ctypes.CDLL(info["path"])
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.lrt_lzw_tiff.argtypes = [p, i64, p, i64, i32]
        lib.lrt_lzw_tiff.restype = i64
        lib.lrt_lzw_gif.argtypes = [p, i64, i32, i32, p, i32, i32, i64, p]
        lib.lrt_lzw_gif.restype = i64
        _LIB = lib
    return _LIB


# ------------------------------------------------------------------ TIFF ----
def lzw_tiff(src: bytes, occ: int, compat: bool = False) -> bytes:
    """A TIFF LZW strip or tile -> its first `occ` decoded bytes (fewer when
    the data or an EOI ends it first; -1 -> ValueError); `compat`: the old
    style."""
    dst = np.zeros(max(occ, 1), np.uint8)
    buf = np.frombuffer(src, np.uint8) if src else np.zeros(1, np.uint8)
    n = library().lrt_lzw_tiff(buf.ctypes.data, len(src), dst.ctypes.data,
                               occ, int(bool(compat)))
    if n < 0:
        raise ValueError("LZW: a corrupt code table")
    return dst[:n].tobytes()


def _lzw_tiff_plain(src: bytes, occ: int, compat: bool = False) -> bytes:
    """lzw_tiff's plain Python version."""
    # the 256 roots, then Clear and EOI's unused slots
    prev = [-1] * 258
    first = list(range(256)) + [0, 0]
    value = list(range(256)) + [0, 0]
    length = [1] * 258
    out = bytearray()
    pos = bitbuf = bitcount = 0
    nbits, free_ent, old = 9, 258, -1
    n = len(src)
    grow = 1 if compat else 2

    def next_code():
        nonlocal pos, bitbuf, bitcount
        while bitcount < nbits:
            if pos >= n:
                return 257
            if compat:
                bitbuf |= src[pos] << bitcount
            else:
                bitbuf = ((bitbuf << 8) | src[pos]) & 0xFFFFFFFF
            pos += 1
            bitcount += 8
        bitcount -= nbits
        if compat:
            code = bitbuf & ((1 << nbits) - 1)
            bitbuf >>= nbits
            return code
        return (bitbuf >> bitcount) & ((1 << nbits) - 1)

    def string(code):
        s = bytearray(length[code])
        for k in range(length[code] - 1, -1, -1):
            s[k] = value[code]
            code = prev[code]
        return s

    while len(out) < occ:
        code = next_code()
        if code == 257:
            break
        if code == 256:
            free_ent, nbits = 258, 9
            code = next_code()
            while code == 256:
                code = next_code()
            if code == 257:
                break
            if code > 256:
                raise ValueError("LZW: a corrupt code table")
            out.append(code)
            old = code
            continue
        if old < 0 or code > free_ent or free_ent >= 4095 + 1024:
            raise ValueError("LZW: a corrupt code table")
        entry = (old, first[old], length[old] + 1,
                 first[code] if code < free_ent else first[old])
        if free_ent < len(prev):
            (prev[free_ent], first[free_ent], length[free_ent],
             value[free_ent]) = entry
        else:
            prev.append(entry[0])
            first.append(entry[1])
            length.append(entry[2])
            value.append(entry[3])
        free_ent += 1
        if free_ent > (1 << nbits) - grow:
            nbits = min(nbits + 1, 12)
        out += string(code)
        old = code
    return bytes(out[:occ])


# ------------------------------------------------------------------- GIF ----
def lzw_gif(src: bytes, bits: int, interlace: bool, frame: np.ndarray):
    """One GIF frame's LZW data (from its sub-blocks to the end of the file)
    into `frame`, a (ysize, xsize) uint8 array filled beforehand, as
    Pillow decodes it; raises OSError where Pillow's load does."""
    ysize, xsize = frame.shape
    buf = np.frombuffer(src, np.uint8) if src else np.zeros(1, np.uint8)
    state = np.zeros(1, np.int32)
    out = np.ascontiguousarray(frame)
    r = library().lrt_lzw_gif(buf.ctypes.data, len(src), bits,
                              int(bool(interlace)), out.ctypes.data, xsize,
                              ysize, GIF_CHUNK, state.ctypes.data)
    frame[...] = out
    _gif_status(r, int(state[0]), len(src))


def _gif_status(r: int, err: int, n: int):
    if r >= 0:
        raise OSError("image file is truncated "
                      f"({n - r} bytes not processed)")
    if err < 0:
        raise OSError(_GIF_ERRORS.get(err, f"decoder error {err}"))


def _lzw_gif_plain(src: bytes, bits: int, interlace: bool,
                   frame: np.ndarray):
    """lzw_gif's plain Python version."""
    r, err = _gif_plain_run(src, bits, interlace, frame)
    _gif_status(r, err, len(src))


def _gif_plain_run(src, bits, interlace, frame):
    ysize, xsize = frame.shape
    flat = frame.reshape(-1)
    if bits < 0 or bits > 12:
        return -1, -8
    n = len(src)
    clear = 1 << bits
    end = clear + 1
    step, il = (8, 1) if interlace else (1, 0)
    state = 1
    nxt = codesize = codemask = 0
    data = bytearray(4096)
    link = [0] * 4096
    pending = []                    # GifDecode.c's right-filled buffer
    blocksize = bitcount = bitbuffer = lastcode = lastdata = 0
    x = y = ptr = 0
    fed = min(GIF_CHUNK, n)
    while True:
        if state == 1:
            nxt = clear + 2
            codesize = bits + 1
            codemask = (1 << codesize) - 1
            pending = []
            state = 2
        if pending:
            p, pending = pending, []
        else:
            starved = False
            while bitcount < codesize:
                if blocksize > 0:
                    bitbuffer |= src[ptr] << bitcount
                    ptr += 1
                    blocksize -= 1
                    bitcount += 8
                elif fed - ptr < 1 or fed - ptr < src[ptr] + 1:
                    if fed >= n:
                        starved = True
                        break
                    fed = min(fed + GIF_CHUNK, n)
                else:
                    blocksize = src[ptr]
                    ptr += 1
            if starved:
                return ptr, 0
            c = bitbuffer & codemask
            bitbuffer >>= codesize
            bitcount -= codesize
            if c == clear:
                if state != 2:
                    state = 1
                continue
            if c == end:
                if fed >= n:
                    return ptr, 0
                fed = min(fed + GIF_CHUNK, n)
                continue
            if state == 2:
                if c > clear:
                    return -1, -2
                lastdata = lastcode = c
                state = 3
                p = [c]
            else:
                thiscode = c
                if c > nxt:
                    return -1, -2
                rev = []
                if c == nxt:
                    rev.append(lastdata)
                    c = lastcode
                while c >= clear:
                    if len(rev) >= 4096 or c >= 4096:
                        return -1, -2
                    rev.append(data[c])
                    c = link[c]
                lastdata = c
                if nxt < 4096:
                    data[nxt] = c
                    link[nxt] = lastcode
                    if nxt == codemask and codesize < 12:
                        codesize += 1
                        codemask = (1 << codesize) - 1
                    nxt += 1
                lastcode = thiscode
                # the first byte goes out now; the rest from the buffer
                p = [c]
                pending = rev[::-1]
        if y >= ysize:
            return -1, -1
        for v in p:
            flat[y * xsize + x] = v
            x += 1
            if x >= xsize:
                x = 0
                y += step
                while y >= ysize:
                    if il == 1:
                        y, il = 4, 2
                    elif il == 2:
                        step, y, il = 4, 2, 3
                    elif il == 3:
                        step, y, il = 2, 1, 0
                    else:
                        return -1, 0
