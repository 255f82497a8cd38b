"""GIF images (GIF87a and GIF89a) read as the JAX package reads them
through Pillow 12: the first frame, composed as GifImagePlugin composes
it, then `convert("RGB")`.

The logical screen grows to hold a frame that runs past it; outside the
frame the canvas holds the transparency index of the frame's graphic
control extension, else index 0.  The frame's colour table (its local
one, else the global one) gives the colours; a table that is the grey
ramp i -> (i, i, i) counts as none (Pillow's mode "L"), and with no
table an index is its own grey level.  Interlaced frames come in GIF's four
passes.  The LZW loop is io/lzw.py's (C++, with its plain Python
version).  Writing GIF needs Pillow's adaptive median-cut quantiser and
raises (ROADMAP M9).

`open_gif` raises SyntaxError where Pillow's plugin gives the file up
and OSError where Pillow's load raises.
"""
from __future__ import annotations

import numpy as np

from . import lzw


def _accept(prefix: bytes) -> bool:
    return prefix.startswith((b"GIF87a", b"GIF89a"))


def _palette_needed(p: bytes) -> bool:
    """GifImageFile._is_palette_needed: False for the grey ramp."""
    for i in range(0, len(p), 3):
        if not (i // 3 == p[i] == p[i + 1] == p[i + 2]):
            return True
    return False


class _Reader:
    def __init__(self, data: bytes):
        self.d, self.pos = data, 0

    def read(self, n: int) -> bytes:
        out = self.d[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def block(self):
        s = self.read(1)
        if s and s[0]:
            return self.read(s[0])
        return None


def open_gif(data: bytes):
    """GifImageFile._open and _seek(0) -> a function that decodes the
    first frame to (H, W, 3) uint8."""
    f = _Reader(data)
    s = f.read(13)
    if not _accept(s):
        raise SyntaxError("not a GIF file")
    size = [int.from_bytes(s[6:8], "little"),
            int.from_bytes(s[8:10], "little")]
    flags = s[10]
    global_palette = None
    if flags & 128:
        p = f.read(3 << ((flags & 7) + 1))
        try:
            if _palette_needed(p):
                global_palette = p
        except IndexError as err:             # a short table
            raise SyntaxError(str(err)) from err
    s = f.read(1)
    if not s or s == b";":
        raise SyntaxError("no more images in GIF file")    # an EOFError
    palette = None
    transparency = None
    interlace = None
    while True:
        if not s:
            s = f.read(1)
        if not s or s == b";":
            break
        if s == b"!":
            s = f.read(1)
            if not s:
                raise SyntaxError("truncated extension")   # an IndexError
            block = f.block()
            if s[0] == 249 and block is not None:
                if block[0] & 1:
                    if len(block) < 4:
                        raise SyntaxError("short graphic control block")
                    transparency = block[3]
                if len(block) < 3:
                    raise SyntaxError("short graphic control block")
            elif s[0] == 254:
                while block:
                    block = f.block()
                s = b""
                continue
            while f.block():
                pass
        elif s == b",":
            s = f.read(9)
            if len(s) < 9:
                raise SyntaxError("truncated image descriptor")
            x0 = int.from_bytes(s[0:2], "little")
            y0 = int.from_bytes(s[2:4], "little")
            x1 = x0 + int.from_bytes(s[4:6], "little")
            y1 = y0 + int.from_bytes(s[6:8], "little")
            if x1 > size[0] or y1 > size[1]:
                size = [max(x1, size[0]), max(y1, size[1])]
            lflags = s[8]
            interlace = (lflags & 64) != 0
            if lflags & 128:
                p = f.read(3 << ((lflags & 7) + 1))
                try:
                    palette = p if _palette_needed(p) else False
                except IndexError as err:
                    raise SyntaxError(str(err)) from err
            bits = f.read(1)
            if not bits:
                raise SyntaxError("no LZW code size")  # an IndexError
            bits = bits[0]
            offset = f.pos
            break
        s = b""
    if interlace is None:
        raise SyntaxError("image not found in GIF frame")  # an EOFError
    # a local grey ramp reads as mode "L", but Pillow's load then puts the
    # global table on the image: the colours come from the local table
    # when it is a real one, else from the global one
    frame_palette = palette or global_palette
    extent = (x0, y0, x1, y1)

    def load():
        return _load(data, offset, bits, interlace, size, extent,
                     frame_palette, transparency)
    return load


def read_gif(data: bytes) -> np.ndarray:
    """A GIF file -> (H, W, 3) uint8 as Pillow's convert("RGB")."""
    return open_gif(data)()


def _load(data, offset, bits, interlace, size, extent, palette,
          transparency) -> np.ndarray:
    w, h = size
    x0, y0, x1, y1 = extent
    canvas = np.full((h, w), transparency or 0, np.uint8)
    frame = np.ascontiguousarray(canvas[y0:y1, x0:x1])
    lzw.lzw_gif(data[offset:], bits, interlace, frame)
    canvas[y0:y1, x0:x1] = frame
    if not palette:
        return np.repeat(canvas[..., None], 3, -1)
    lut = np.zeros((256, 3), np.uint8)
    n = min(len(palette) // 3, 256)
    lut[:n] = np.frombuffer(palette, np.uint8, 3 * n).reshape(n, 3)
    return lut[canvas]
