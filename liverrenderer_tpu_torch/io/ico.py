"""Windows icons and cursors (ICO, CUR) read as the JAX package reads them
through Pillow: the entry Pillow's IcoImagePlugin loads (the entries
sorted by colour depth, then stably by area, largest first: the first
one), or for CUR the entry CurImagePlugin picks (the first, replaced by
any later one larger in both sides), then `convert("RGB")`.  PNG entries
decode through io/png.py; bitmap entries through raster.read_dib at half
their stored height, the XOR rows only (the AND mask sets alpha, which
convert("RGB") drops).  Pillow's ICO writer resamples to its own list of
sizes, so writing ICO raises (ROADMAP M9).
"""
from __future__ import annotations

import math
import struct

from . import raster
from .png import decode_png

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
