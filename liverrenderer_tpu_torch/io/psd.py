"""Photoshop files (PSD) read as the JAX package reads them through
Pillow: the composite image that PsdImagePlugin opens as frame 0, raw or
PackBits, then `convert("RGB")`.  Pillow's modes: bitmap (1 bit), grey,
duotone and multichannel (their first channel), indexed (the 768-byte
colour table; without one Pillow's empty palette: black), RGB (RGBA with
a fourth channel), CMYK (stored inverted) and CIELab at 8 bits.  Pillow
gives up on other depths, 16-bit ones included (its mode table has no
entry, so Image.open goes on to the next format).
"""
from __future__ import annotations

import struct

import numpy as np

from . import cielab
from .rawmode import cmyk_to_rgb, to_rgb

_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
          (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
          (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


def open_psd(data: bytes):
    s = data[:26]
    if not s.startswith(b"8BPS") or len(s) < 26 \
            or struct.unpack_from(">H", s, 4)[0] != 1:
        raise SyntaxError("not a PSD file")
    channels_in = struct.unpack_from(">H", s, 12)[0]
    h, w = struct.unpack_from(">II", s, 14)
    bits, pmode = struct.unpack_from(">HH", s, 22)
    if (pmode, bits) not in _MODES:
        raise SyntaxError("unknown PSD mode")              # a KeyError
    mode, channels = _MODES[(pmode, bits)]
    if channels > channels_in:
        raise OSError("not enough channels")
    if mode == "RGB" and channels_in == 4:
        mode, channels = "RGBA", 4
    pos = 26

    def block():
        nonlocal pos
        size = struct.unpack_from(">I", data, pos)[0]
        body = data[pos + 4:pos + 4 + size]
        pos += 4 + size
        return body

    try:
        cmap = block()
        block()                                  # image resources
        block()                                  # layer and mask data
        comp = struct.unpack_from(">H", data, pos)[0]
    except struct.error as err:
        raise SyntaxError(str(err)) from err
    pos += 2
    palette = None
    if mode == "P" and len(cmap) == 768:
        palette = np.frombuffer(cmap, np.uint8).reshape(3, 256).T
    if w <= 0 or h <= 0:
        raise SyntaxError("an empty image")

    def load():
        return _load(data, pos, comp, mode, channels, w, h, palette)
    return load


def _packbits(data: bytes, pos: int, row: int, rows: int) -> bytes:
    """Pillow's PackbitsDecode.c: each packet goes whole into the line
    buffer, and a full line drops what ran past its end."""
    out = bytearray()
    line = bytearray()
    n = len(data)
    while len(out) < row * rows:
        if pos >= n:
            raise OSError("image file is truncated")
        c = data[pos]
        if c == 0x80:
            pos += 1
            continue
        if c & 0x80:
            if pos + 1 >= n:
                raise OSError("image file is truncated")
            line += data[pos + 1:pos + 2] * (257 - c)
            pos += 2
        else:
            if pos + c + 2 > n:
                raise OSError("image file is truncated")
            line += data[pos + 1:pos + c + 2]
            pos += c + 2
        if len(line) >= row:
            out += line[:row]
            line = bytearray()
    return bytes(out)


def _load(data, pos, comp, mode, channels, w, h, palette):
    row = (w + 7) // 8 if mode == "1" else w
    planes = []
    if comp == 0:
        for c in range(channels):
            raw = data[pos:pos + row * h]
            if len(raw) < row * h:
                raise OSError("image file is truncated")
            planes.append(np.frombuffer(raw, np.uint8).reshape(h, row))
            pos += w * h
    elif comp == 1:
        counts = struct.unpack_from(">%dH" % (channels * h), data, pos)
        pos += 2 * channels * h
        for c in range(channels):
            planes.append(np.frombuffer(_packbits(data, pos, row, h),
                                        np.uint8).reshape(h, row))
            pos += sum(counts[c * h:(c + 1) * h])
    else:
        raise OSError("cannot load this image")          # no tile
    if mode == "1":
        v = np.unpackbits(planes[0], axis=1)[:, :w] * 255
        return np.repeat(v[..., None].astype(np.uint8), 3, -1)
    if mode == "L":
        return np.repeat(planes[0][..., None], 3, -1)
    if mode == "P":                    # without a table: Pillow's empty one
        return to_rgb(planes[0], "P", palette)
    px = np.stack(planes, -1)
    if mode == "CMYK":
        return cmyk_to_rgb(255 - px)
    if mode == "LAB":                  # a and b already offset by 128
        return cielab.lab_to_rgb(np.ascontiguousarray(px[..., :3]))
    return np.ascontiguousarray(px[..., :3])
