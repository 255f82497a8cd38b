"""A small PNG codec on zlib and numpy, for machines without PIL.

Reads grey, grey+alpha, RGB, RGBA and palette images at every bit depth
(1, 2, 4, 8 and 16), plain or Adam7-interlaced, with every row filter
(None, Sub, Up, Average, Paeth), and returns them as the JAX package's
reader, PIL's `Image.open(p).convert("RGB")`, does: (H, W, 3) uint8, grey
repeated, alpha dropped, palettes looked up, low-bit grey scaled to
0..255.  PIL keeps the high byte of a 16-bit sample, but a 16-bit grey
image opens as "I;16", whose conversion to RGB clips every value above
255 to 255 (ROADMAP Queue 3); the port does the same.  Writes 8-bit grey,
RGB and RGBA images, every row Paeth-filtered.

Sub and Up decode a whole row in numpy.  Average and Paeth carry a
dependence along the row (each byte predicts from the decoded byte to its
left), so they decode byte by byte in plain Python over bytearrays, which
is faster than per-pixel numpy calls.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
# colour type -> channels per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7's passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(buf: bytes):
    if buf[:8] != _SIG:
        raise ValueError("not a PNG file")
    off = 8
    while off + 8 <= len(buf):
        n, kind = struct.unpack_from(">I4s", buf, off)
        yield kind, buf[off + 8:off + 8 + n]
        off += 12 + n
        if kind == b"IEND":
            return


def _unfilter_average(row: bytearray, prev: bytes, bpp: int):
    for i in range(bpp):
        row[i] = (row[i] + (prev[i] >> 1)) & 0xFF
    for i in range(bpp, len(row)):
        row[i] = (row[i] + ((row[i - bpp] + prev[i]) >> 1)) & 0xFF


def _unfilter_paeth(row: bytearray, prev: bytes, bpp: int):
    for i in range(bpp):                  # left and up-left are 0
        row[i] = (row[i] + prev[i]) & 0xFF
    for i in range(bpp, len(row)):
        a, b, c = row[i - bpp], prev[i], prev[i - bpp]
        pa = b - c if b > c else c - b    # |p - a|, p = a + b - c
        pb = a - c if a > c else c - a    # |p - b|
        pc = a + b - c - c
        pc = pc if pc > 0 else -pc        # |p - c|
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        row[i] = (row[i] + pred) & 0xFF


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """(h, stride) uint8 of the decoded scanlines."""
    if len(data) < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = np.frombuffer(data, np.uint8, h * (stride + 1)) \
        .reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, raw = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = raw
        elif ftype == 1:                  # Sub: running sums per channel
            cur = (np.cumsum(raw.reshape(-1, bpp), 0, dtype=np.int64)
                   .reshape(-1) & 0xFF).astype(np.uint8)
        elif ftype == 2:                  # Up
            cur = raw + prev
        elif ftype in (3, 4):             # Average, Paeth
            row = bytearray(raw.tobytes())
            (_unfilter_average if ftype == 3 else _unfilter_paeth)(
                row, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"PNG row filter {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def _samples(data: bytes, w: int, h: int, nch: int, depth: int):
    """One (sub)image's filtered scanlines -> ((h, w, nch) samples, bytes
    used): 1-, 2- and 4-bit samples unpacked from the most significant
    bits, 16-bit ones big-endian."""
    stride = (w * nch * depth + 7) // 8
    bpp = max(1, nch * depth // 8)
    rows = _unfilter(data, h, stride, bpp)
    if depth == 16:
        px = rows.view(">u2")[:, :w * nch]
    elif depth == 8:
        px = rows[:, :w * nch]
    else:
        bits = np.unpackbits(rows, axis=1)[:, :w * nch * depth]
        px = np.zeros((h, w * nch), np.uint8)
        for k in range(depth):
            px = (px << 1) | bits[:, k::depth]
    return px.reshape(h, w, nch), h * (stride + 1)


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8, as PIL's convert("RGB")."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def decode_png(buf: bytes) -> np.ndarray:
    """PNG file bytes -> (H, W, 3) uint8, as PIL's convert("RGB")."""
    idat, palette, hdr = [], None, None
    for kind, body in _chunks(buf):
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if hdr is None:
        raise ValueError(f"PNG without IHDR: {path}")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype}")
    if depth not in (1, 2, 4, 8, 16) or (depth < 8 and ctype not in (0, 3)) \
            or (depth == 16 and ctype == 3):
        raise ValueError(f"PNG bit depth {depth} of colour type {ctype}")
    nch = _CHANNELS[ctype]
    data = zlib.decompress(b"".join(idat))
    if not interlace:
        px, _ = _samples(data, w, h, nch, depth)
    else:
        # each pass a small image of its own, filtered from a zero row
        px = np.zeros((h, w, nch), np.uint16 if depth == 16 else np.uint8)
        off = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = max(0, (w - x0 + dx - 1) // dx), \
                max(0, (h - y0 + dy - 1) // dy)
            if pw and ph:
                sub, used = _samples(data[off:], pw, ph, nch, depth)
                px[y0::dy, x0::dx] = sub
                off += used
    if ctype == 3:
        if palette is None:
            raise ValueError(f"palette PNG without PLTE: {path}")
        # indices past the palette read black, as PIL's do
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[px[..., 0]]
    if depth == 16:
        # PIL: "I;16" grey clips to 255; the other modes keep the high
        # byte
        px = np.minimum(px, 255) if ctype == 0 else px >> 8
    elif depth < 8:
        px = px * (255 // ((1 << depth) - 1))
    px = px.astype(np.uint8)
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, -1)
    return np.ascontiguousarray(px[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray):
    """Write (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) uint8 pixels as
    grey, RGB or RGBA, every row Paeth-filtered."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def encode_png(img: np.ndarray) -> bytes:
    """write_png's file bytes."""
    px = np.asarray(img, np.uint8)
    if px.ndim == 2:
        px = px[..., None]
    h, w, c = px.shape
    ctype = {1: 0, 3: 2, 4: 6}[c]
    cur = px.reshape(h, w * c).astype(np.int16)
    a = np.zeros_like(cur)
    a[:, c:] = cur[:, :-c]                     # left
    b = np.zeros_like(cur)
    b[1:] = cur[:-1]                           # up
    cc = np.zeros_like(cur)
    cc[1:, c:] = cur[:-1, :-c]                 # up-left
    p = a + b - cc
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    filt = ((cur - pred) & 0xFF).astype(np.uint8)
    raw = np.concatenate([np.full((h, 1), 4, np.uint8), filt], 1)
    return (_SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                               0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))
