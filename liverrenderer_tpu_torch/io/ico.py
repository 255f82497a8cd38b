"""Windows icons and cursors (ICO, CUR) read as the JAX package reads them
through Pillow: the entry Pillow's IcoImagePlugin loads (the entries
sorted by colour depth, then stably by area, largest first: the first
one), or for CUR the entry CurImagePlugin picks (the first, replaced by
any later one larger in both sides), then `convert("RGB")`.  PNG entries
decode through io/png.py; bitmap entries through raster.read_dib at half
their stored height, the XOR rows only (the AND mask sets alpha, which
convert("RGB") drops).

Writing follows IcoImagePlugin._save with its defaults: each of Pillow's
sizes from 16 to 256 that fits inside the image becomes a Lanczos
thumbnail (io/resample.py, the aspect kept), stored as a PNG entry
(io/png.encode_png: Pillow's PNG entries hold the same pixels in other
deflate bytes), 32 bits and no colour count in the directory.
"""
from __future__ import annotations

import math
import struct

import numpy as np

from . import raster, resample
from .png import decode_png, encode_png

# IcoImagePlugin._save's default sizes
SIZES = [(16, 16), (24, 24), (32, 32), (48, 48), (64, 64), (128, 128),
         (256, 256)]

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def open_ico(data: bytes):
    if not data.startswith(b"\0\0\1\0"):
        raise SyntaxError("not an ICO file")
    n = struct.unpack_from("<H", data, 4)[0]
    entries = []
    for i in range(n):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise SyntaxError("truncated icon directory")  # an IndexError
        w, h, ncol = s[0] or 256, s[1] or 256, s[2]
        bpp = struct.unpack_from("<H", s, 6)[0]
        depth = bpp or (ncol != 0 and math.ceil(math.log(ncol, 2))) or 256
        entries.append((w * h, depth, struct.unpack_from("<I", s, 12)[0]))
    entries.sort(key=lambda e: e[1])
    entries.sort(key=lambda e: e[0], reverse=True)
    if not entries:
        raise SyntaxError("no icons")                      # an IndexError
    offset = entries[0][2]
    # Pillow loads the icon while it opens the file
    img = _entry(data, offset)
    return lambda: img


def _entry(data: bytes, offset: int):
    if data[offset:offset + 8] == _PNG_SIG:
        return decode_png(data[offset:])
    return raster.read_dib(data, offset, 0, halve=True)


def open_cur(data: bytes):
    if not data.startswith(b"\0\0\2\0"):
        raise SyntaxError("not a CUR file")
    n = struct.unpack_from("<H", data, 4)[0]
    m = b""
    for i in range(n):
        s = data[6 + 16 * i:22 + 16 * i]
        if not m:
            m = s
        elif len(s) < 2:
            raise SyntaxError("truncated cursor directory")  # IndexError
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if not m:
        raise SyntaxError("No cursors were found")         # a TypeError
    if len(m) < 16:
        raise SyntaxError("truncated cursor entry")        # struct.error
    header = struct.unpack_from("<I", m, 12)[0]
    return lambda: raster.read_dib(data, header, 0, halve=True)


def encode_ico(px: np.ndarray) -> bytes:
    """(H, W), (H, W, 3) or (H, W, 4) uint8 -> Pillow 12.1's ICO file for
    Image.fromarray(px) (its PNG entries as io/png writes them)."""
    px = np.asarray(px, np.uint8)
    height, width = px.shape[:2]
    frames = [resample.thumbnail(px, size)
              for size in SIZES if size[0] <= width and size[1] <= height]
    entries = [encode_png(f) for f in frames]
    out = bytearray(b"\0\0\1\0" + struct.pack("<H", len(frames)))
    offset = len(out) + 16 * len(frames)
    for frame, data in zip(frames, entries):
        h, w = frame.shape[:2]
        out += bytes([w if w < 256 else 0, h if h < 256 else 0, 0, 0])
        out += struct.pack("<HHII", 0, 32, len(data), offset)
        offset += len(data)
    return bytes(out + b"".join(entries))
