"""WebP's lossless bitstream (VP8L, RFC 9649 sections 3-5), as libwebp
1.6's src/dec/vp8l_dec.c decodes it (no PIL, no libwebp).

The header (signature 0x2f, 14-bit width and height, the alpha hint,
version 0) and the transforms are read here: the predictor (14 modes, the
first row from the left, the first column from above, the top-right of
the last column the row's first pixel; modes 14 and 15 as libwebp's
black), cross-colour, subtract-green and colour indexing with the
palette's delta coding, its zero padding to 2^(8 >> bits) entries and
the bundling of 2, 4 or 8 indices to a pixel.  The entropy-coded images
(prefix-code groups, the meta prefix image, the colour cache, LZ77 with
the 120-entry distance map) and the predictor's sequential add run in
C++ (csrc/webp.cpp, built at first use by host_build.compile_shared; a
failed build raises, and nothing falls back); `_entropy_plain` and
`_predictor_plain` are their plain Python versions.  The other
transforms are numpy over whole rows.

An ALPH chunk's lossless alpha is the same stream without the header,
at the frame's size (`decode_alpha`: the green channel).  Every
bitstream error raises OSError, where Pillow's WebP decoder fails.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "webp.cpp"
_LIB = None

# kCodeToPlane: the (dy, 8 - dx) of the 120 short distance codes
PLANE = np.array((
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70),
    np.uint8)
_ALPHABET = (256 + 24, 256, 256, 256, 40)
_CODE_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13,
               14, 15)


def library():
    """Build (once per source hash) and load csrc/webp.cpp; raises if the
    compiler fails."""
    global _LIB
    if _LIB is None:
        from ..host_build import BUILD_DIR, compile_shared
        info = compile_shared(_SRC, BUILD_DIR, "WebP decode")
        lib = ctypes.CDLL(info["path"])
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.lrt_vp8l_entropy.argtypes = [p, i64, i64, i32, i32, i32, p, i32,
                                         i32, p, p]
        lib.lrt_vp8l_entropy.restype = i64
        lib.lrt_vp8l_predictor.argtypes = [p, i32, i32, p, i32]
        lib.lrt_vp8l_predictor.restype = None
        lib.lrt_vp8_frame.argtypes = [p, i64, p, p, p, p, p]
        lib.lrt_vp8_frame.restype = i32
        _LIB = lib
    return _LIB


class _Bits:
    """libwebp's VP8L bit reader: LSB first; consuming more bits than the
    data holds (more than 64 when it holds fewer than 8 bytes) is the end
    of the stream."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos
        self.avail = 8 * len(data) if len(data) >= 8 else 64

    def read(self, n: int) -> int:
        v = 0
        for i in range(n):
            p = self.pos + i
            if p >> 3 < len(self.data):
                v |= ((self.data[p >> 3] >> (p & 7)) & 1) << i
        self.pos += n
        return v

    def check(self):
        if self.pos > self.avail:
            raise OSError("VP8L: the bitstream ends early")


def _sub(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def header(data: bytes):
    """VP8LGetInfo -> (width, height, alpha hint); OSError when libwebp
    refuses it."""
    if len(data) < 5 or data[0] != 0x2F or data[4] >> 5:
        raise OSError("VP8L: not a lossless bitstream")
    br = _Bits(data, 8)
    w, h = br.read(14) + 1, br.read(14) + 1
    alpha = br.read(1)
    if br.read(3):
        raise OSError("VP8L: version is not 0")
    br.check()
    return w, h, alpha


def decode(data: bytes, plain: bool = False) -> np.ndarray:
    """A VP8L chunk's payload -> (H, W) uint32 ARGB."""
    w, h, _ = header(data)
    return _stream(_Bits(data, 40), w, h, True, plain)


def decode_alpha(data: bytes, width: int, height: int,
                 plain: bool = False) -> np.ndarray:
    """An ALPH chunk's lossless payload (after its header byte) -> the
    (H, W) uint8 alpha plane before the ALPH filter."""
    argb = _stream(_Bits(data), width, height, True, plain)
    return ((argb >> 8) & 0xFF).astype(np.uint8)


def _stream(br: _Bits, xsize: int, ysize: int, level0: bool,
            plain: bool) -> np.ndarray:
    """DecodeImageStream: transforms (level 0 only), colour cache, meta
    prefix image (level 0 only), then the entropy-coded pixels; inverse
    transforms in reverse order."""
    transforms = []
    seen = set()
    while level0 and br.read(1):
        kind = br.read(2)
        if kind in seen:
            raise OSError("VP8L: a transform repeats")
        seen.add(kind)
        if kind in (0, 1):
            bits = br.read(3) + 2
            sub = _stream(br, _sub(xsize, bits), _sub(ysize, bits), False,
                          plain)
            transforms.append((kind, bits, sub, xsize))
        elif kind == 3:
            ncol = br.read(8) + 1
            bits = 0 if ncol > 16 else 1 if ncol > 4 else 2 if ncol > 2 else 3
            pal = _stream(br, ncol, 1, False, plain).reshape(-1)
            # delta-coded per byte, padded with transparent black
            full = np.zeros((1 << (8 >> bits), 4), np.uint8)
            full[:ncol] = np.cumsum(pal.view(np.uint8).reshape(-1, 4),
                                    axis=0, dtype=np.uint8)
            transforms.append((3, bits, full.view(np.uint32)[:, 0], xsize))
            xsize = _sub(xsize, bits)
        else:
            transforms.append((2, 0, None, xsize))
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise OSError("VP8L: a colour cache of an invalid size")
    groups, meta_bits, ngroups = None, 0, 1
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        meta = _stream(br, _sub(xsize, meta_bits), _sub(ysize, meta_bits),
                       False, plain)
        groups = np.ascontiguousarray((meta >> 8) & 0xFFFF, np.int32)
        ngroups = int(groups.max()) + 1
    br.check()
    fn = _entropy_plain if plain else _entropy
    argb, br.pos = fn(br.data, br.pos, xsize, ysize, cache_bits, groups,
                      meta_bits, ngroups)
    argb = argb.reshape(ysize, xsize)
    for kind, bits, sub, width in reversed(transforms):
        if kind == 0:
            (_predictor_plain if plain else _predictor)(argb, sub, bits)
        elif kind == 1:
            argb = _cross_colour(argb, sub, bits)
        elif kind == 2:
            g = (argb >> 8) & 0xFF
            argb = (argb & 0xFF00FF00) | (((argb >> 16) + g) & 0xFF) << 16 \
                | ((argb + g) & 0xFF)
        else:
            argb = _colour_index(argb, sub, bits, width)
    return np.ascontiguousarray(argb, np.uint32)


def _entropy(data, pos, xsize, ysize, cache_bits, groups, meta_bits,
             ngroups):
    out = np.zeros(xsize * ysize, np.uint32)
    buf = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
    r = library().lrt_vp8l_entropy(
        buf.ctypes.data, len(data), pos, xsize, ysize, cache_bits,
        None if groups is None else groups.ctypes.data, meta_bits, ngroups,
        PLANE.ctypes.data, out.ctypes.data)
    if r < 0:
        raise OSError(f"failed to read next frame (VP8L error {r})")
    return out, r


def _predictor(argb, modes, bits):
    m = np.ascontiguousarray(modes, np.uint32)
    library().lrt_vp8l_predictor(argb.ctypes.data, argb.shape[1],
                                 argb.shape[0], m.ctypes.data, bits)


def _cross_colour(argb, mults, bits):
    """TransformColorInverse over the image, the multipliers of each
    pixel's tile (int8 products >> 5; red-to-blue on the new red)."""
    h, w = argb.shape
    m = mults[np.arange(h)[:, None] >> bits, np.arange(w)[None] >> bits]
    s8 = lambda v: ((v.astype(np.int32) & 0xFF) ^ 0x80) - 0x80  # noqa: E731
    g2r, g2b, r2b = s8(m), s8(m >> 8), s8(m >> 16)
    green = s8(argb >> 8)
    red = (s8(argb >> 16) + ((g2r * green) >> 5)) & 0xFF
    blue = (argb.astype(np.int32) & 0xFF) + ((g2b * green) >> 5) \
        + ((r2b * (((red ^ 0x80) - 0x80))) >> 5)
    return (argb & 0xFF00FF00) | (red.astype(np.uint32) << 16) \
        | (blue & 0xFF).astype(np.uint32)


def _colour_index(argb, pal, bits, width):
    """The palette of each index; 2^bits indices bundled in one green."""
    green = (argb >> 8) & 0xFF
    x = np.arange(width)
    bpp = 8 >> bits
    idx = (green[:, x >> bits] >> ((x & ((1 << bits) - 1)) * bpp)) \
        & ((1 << bpp) - 1)
    return pal[idx]


# ---------------------------------------------------- the plain loops ----
class _PlainCode:
    """A canonical prefix code decoded bit by bit (puff's method)."""

    def __init__(self, lengths):
        if any(v > 15 for v in lengths) or not any(lengths):
            raise OSError("VP8L: an invalid prefix code")
        self.count = [0] * 16
        for v in lengths:
            self.count[v] += 1
        self.count[0] = 0
        self.symbols = [s for n in range(1, 16)
                        for s, v in enumerate(lengths) if v == n]
        if len(self.symbols) == 1:
            return
        left = 1
        for n in range(1, 16):
            left = 2 * left - self.count[n]
            if left < 0:
                raise OSError("VP8L: an oversubscribed prefix code")
        if left:
            raise OSError("VP8L: an incomplete prefix code")

    def read(self, br: _Bits) -> int:
        if len(self.symbols) == 1:
            return self.symbols[0]
        code = first = index = 0
        for n in range(1, 16):
            code |= br.read(1)
            count = self.count[n]
            if code - count < first:
                return self.symbols[index + code - first]
            index += count
            first = (first + count) << 1
            code <<= 1
        return 0


def _read_code(br: _Bits, alphabet: int) -> _PlainCode:
    lengths = [0] * max(alphabet, 256)
    if br.read(1):
        nsym = br.read(1) + 1
        lengths[br.read(8 if br.read(1) else 1)] = 1
        if nsym == 2:
            lengths[br.read(8)] = 1
    else:
        cl = [0] * 19
        for i in range(br.read(4) + 4):
            cl[_CODE_ORDER[i]] = br.read(3)
        lc = _PlainCode(cl)
        max_symbol = alphabet
        if br.read(1):
            max_symbol = 2 + br.read(2 + 2 * br.read(3))
            if max_symbol > alphabet:
                raise OSError("VP8L: a code-length count past the alphabet")
        prev, s = 8, 0
        while s < alphabet:
            if max_symbol == 0:
                break
            max_symbol -= 1
            n = lc.read(br)
            if n < 16:
                lengths[s] = n
                s += 1
                prev = n or prev
            else:
                rep = br.read((2, 3, 7)[n - 16]) + (3, 3, 11)[n - 16]
                if s + rep > alphabet:
                    raise OSError("VP8L: a code-length repeat past the end")
                lengths[s:s + rep] = [prev if n == 16 else 0] * rep
                s += rep
    br.check()
    return _PlainCode(lengths[:alphabet])


def _copy(sym: int, br: _Bits) -> int:
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _entropy_plain(data, pos, xsize, ysize, cache_bits, groups, meta_bits,
                   ngroups):
    """lrt_vp8l_entropy's plain Python version."""
    br = _Bits(data, pos)
    csize = (1 << cache_bits) if cache_bits else 0
    codes = [[_read_code(br, _ALPHABET[j] + (csize if j == 0 else 0))
              for j in range(5)] for _ in range(ngroups)]
    cache = [0] * max(csize, 1)
    total = xsize * ysize
    out = [0] * total
    gw = _sub(xsize, meta_bits) if groups is not None else 0
    flat = groups.reshape(-1).tolist() if groups is not None else None
    i = cached = 0
    while i < total:
        y, x = divmod(i, xsize)
        c = codes[flat[(y >> meta_bits) * gw + (x >> meta_bits)]] \
            if flat is not None else codes[0]
        code = c[0].read(br)
        br.check()
        if code < 256:
            red, blue, alpha = c[1].read(br), c[2].read(br), c[3].read(br)
            br.check()
            out[i] = (alpha << 24) | (red << 16) | (code << 8) | blue
            i += 1
        elif code < 280:
            length = _copy(code - 256, br)
            dcode = _copy(c[4].read(br), br)
            if dcode > 120:
                dist = dcode - 120
            else:
                d = int(PLANE[dcode - 1])
                dist = max((d >> 4) * xsize + 8 - (d & 15), 1)
            br.check()
            if i < dist or total - i < length:
                raise OSError("VP8L: a backward reference out of the image")
            for _ in range(length):
                out[i] = out[i - dist]
                i += 1
        else:
            while cached < i:
                cache[((0x1E35A7BD * out[cached]) & 0xFFFFFFFF)
                      >> (32 - cache_bits)] = out[cached]
                cached += 1
            out[i] = cache[code - 280]
            i += 1
        while csize and cached < i:
            cache[((0x1E35A7BD * out[cached]) & 0xFFFFFFFF)
                  >> (32 - cache_bits)] = out[cached]
            cached += 1
    br.check()
    return np.array(out, np.uint32), br.pos


def _avg(a, b):
    return [(x + y) >> 1 for x, y in zip(a, b)]


def _clip(v):
    return 0 if v < 0 else 255 if v > 255 else v


def _predict(mode, L, T, TR, TL):
    if mode == 1:
        return L
    if mode == 2:
        return T
    if mode == 3:
        return TR
    if mode == 4:
        return TL
    if mode == 5:
        return _avg(_avg(L, TR), T)
    if mode == 6:
        return _avg(L, TL)
    if mode == 7:
        return _avg(L, T)
    if mode == 8:
        return _avg(TL, T)
    if mode == 9:
        return _avg(T, TR)
    if mode == 10:
        return _avg(_avg(L, TL), _avg(T, TR))
    if mode == 11:
        d = sum(abs(l - tl) - abs(t - tl) for l, t, tl in zip(L, T, TL))
        return T if d <= 0 else L
    if mode == 12:
        return [_clip(l + t - tl) for l, t, tl in zip(L, T, TL)]
    if mode == 13:
        return [_clip(a + int((a - tl) / 2)) for a, tl in zip(_avg(L, T), TL)]
    return [0, 0, 0, 255]


def _predictor_plain(argb, modes, bits):
    """lrt_vp8l_predictor's plain Python version (in place)."""
    h, w = argb.shape
    px = argb.view(np.uint8).reshape(h * w, 4).astype(np.int64).tolist()
    flat = modes.reshape(-1).tolist()
    tw = _sub(w, bits)
    for i in range(h * w):
        y, x = divmod(i, w)
        if y == 0:
            p = px[i - 1] if x else [0, 0, 0, 255]
        elif x == 0:
            p = px[i - w]
        else:
            mode = (flat[(y >> bits) * tw + (x >> bits)] >> 8) & 15
            p = _predict(mode, px[i - 1], px[i - w], px[i - w + 1],
                         px[i - w - 1])
        px[i] = [(a + b) & 0xFF for a, b in zip(px[i], p)]
    argb[...] = np.array(px, np.uint8).view(np.uint32).reshape(h, w)
