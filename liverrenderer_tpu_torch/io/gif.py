"""GIF images (GIF87a and GIF89a) read as the JAX package reads them
through Pillow 12: the first frame, composed as GifImagePlugin composes
it, then `convert("RGB")`; and written as Pillow saves an L, RGB or RGBA
image (`encode_gif`).

The logical screen grows to hold a frame that runs past it; outside the
frame the canvas holds the transparency index of the frame's graphic
control extension, else index 0.  The frame's colour table (its local
one, else the global one) gives the colours; a table that is the grey
ramp i -> (i, i, i) counts as none (Pillow's mode "L"), and with no
table an index is its own grey level.  Interlaced frames come in GIF's four
passes.  The LZW loop is io/lzw.py's (C++, with its plain Python
version).

Writing follows GifImagePlugin._save for one frame with its defaults: RGB
quantised by median cut and RGBA by fast octree (io/quantize.py; an
octree colour of alpha 0 becomes the transparency), L on the grey ramp;
unused palette entries dropped (`_get_optimize`, for images under 512^2
pixels and always for L), the colour table padded to a power of two,
GIF89a only with a transparency, rows interlaced unless a side is under
16, and Pillow's LZW encoder (io/lzw.py).

`open_gif` raises SyntaxError where Pillow's plugin gives the file up
and OSError where Pillow's load raises.
"""
from __future__ import annotations

import math
import struct

import numpy as np

from . import lzw, quantize


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


# ---------------------------------------------------------------- writing ----
def _table_size(palette: bytes) -> int:
    """_get_color_table_size."""
    if not palette:
        return 0
    if len(palette) < 9:
        return 1
    return math.ceil(math.log(len(palette) // 3, 2)) - 1


def _normalize(px: np.ndarray):
    """_normalize_mode and _normalize_palette -> (indices, palette bytes
    in RGB, transparency index or None)."""
    h, w = px.shape[:2]
    transparency = None
    if px.ndim == 2:                                    # L
        idx, bands = px, 3
        source = bytes(i // 3 for i in range(768))
        optimise = True
    else:
        pal, idx = quantize.quantize(px)
        bands = pal.shape[1]
        source = pal.tobytes()
        if bands == 4:                         # the palette's mode RGBA
            clear = np.nonzero(pal[:, 3] == 0)[0]
            if len(clear):
                transparency = int(clear[0])
        optimise = False
    used = None
    if optimise or w * h < 512 * 512:
        used = np.nonzero(np.bincount(idx.reshape(-1), minlength=256))[0]
        if not optimise and used.max() < len(used):
            n = len(source) // bands
            current = 1 << (n - 1).bit_length()
            if not (len(used) <= current // 2 and current > 2):
                used = None
    if used is not None:
        pos = np.zeros(256, np.uint8)
        pos[used] = np.arange(len(used))
        idx = pos[idx]
        source = b"".join(source[i * bands:(i + 1) * bands] for i in used)
        if transparency is not None:
            hit = np.nonzero(used == transparency)[0]
            transparency = int(hit[0]) if len(hit) else None
    if bands == 4:
        source = b"".join(source[i:i + 3] for i in range(0, len(source), 4))
    return idx, source, transparency


def encode_gif(px: np.ndarray) -> bytes:
    """(H, W), (H, W, 3) or (H, W, 4) uint8 -> the bytes Pillow 12.1 saves
    for Image.fromarray(px) as GIF with its defaults."""
    px = np.asarray(px, np.uint8)
    h, w = px.shape[:2]
    idx, palette, transparency = _normalize(px)
    size = _table_size(palette)
    table = palette + bytes(3 * max((2 << size) - len(palette) // 3, 0))
    version = b"89a" if transparency is not None else b"87a"
    out = bytearray(b"GIF" + version + struct.pack("<HH", w, h))
    out += bytes([size + 128, 0, 0]) + table
    if transparency is not None:
        out += b"!\xf9\x04\x01" + struct.pack("<H", 0) \
            + bytes([transparency, 0])
    interlace = min(w, h) >= 16
    out += b"," + struct.pack("<HHHH", 0, 0, w, h)
    out += bytes([64 if interlace else 0, 8])
    out += lzw.lzw_gif_encode(idx, interlace) + b"\0;"
    return bytes(out)
