"""DirectDraw Surface files, as Pillow 12.1's DdsImagePlugin opens and
saves them (no PIL).

The header walk of DdsImageFile._open with each of its refusals: a header
size other than 124 and a short header raise OSError, an unknown pixel
format flag, FourCC or DXGI format NotImplementedError, a luminance bit
count other than 8 (or 16 with alpha) OSError, and a file too short for
the DX10 header is given up (struct.error in Pillow).  Uncompressed RGB(A)
with any channel masks decodes as DdsRgbDecoder does (each mask's
trailing zeros shifted out, the rest scaled by 255 / (mask >> shift) in
double precision and truncated; a short file reads zeros); L, LA and P
(with its 1,024-byte RGBA palette) and DX10 R8G8B8A8 as raw rows; the
FourCC formats DXT1/3/5, BC4U/ATI1, BC5U/BC5S/ATI2 and DX10's BC1-BC7
through io/bcn.py.  The pixels start where the header ends (load_seek is
a no-op in Pillow, so the tile offsets are not used).

`encode_dds` is Pillow's _save with no pixel_format: raw rows under a
DDSD.PITCH header with the RGB(A) or luminance masks.
"""
from __future__ import annotations

import struct

import numpy as np

from . import bcn

# DDPF
_ALPHAPIXELS, _FOURCC, _PAL8, _RGB, _LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000


def _cc(s: bytes) -> int:
    return struct.unpack("<I", s)[0]


_FOURCCS = {_cc(b"DXT1"): (1, "DXT1"), _cc(b"DXT3"): (2, "DXT3"),
            _cc(b"DXT5"): (3, "DXT5"), _cc(b"BC4U"): (4, "BC4"),
            _cc(b"ATI1"): (4, "BC4"), _cc(b"BC5S"): (5, "BC5S"),
            _cc(b"BC5U"): (5, "BC5"), _cc(b"ATI2"): (5, "BC5")}
_DX10 = _cc(b"DX10")
_DXGI = {70: (1, "BC1"), 71: (1, "BC1"), 73: (2, "BC2"), 74: (2, "BC2"),
         76: (3, "BC3"), 77: (3, "BC3"), 79: (4, "BC4"), 80: (4, "BC4"),
         82: (5, "BC5"), 83: (5, "BC5"), 84: (5, "BC5S"), 95: (6, "BC6H"),
         96: (6, "BC6HS"), 97: (7, "BC7"), 98: (7, "BC7"), 99: (7, "BC7"),
         27: (0, "RGBA"), 28: (0, "RGBA"), 29: (0, "RGBA")}


def open_dds(data: bytes):
    """DdsImageFile._open -> a function that decodes the file to (H, W, 3)
    uint8 as Pillow's convert("RGB") returns it."""
    if len(data) < 8:
        raise SyntaxError("not a DDS file")          # struct.error in Pillow
    size = _cc(data[4:8])
    if size != 124:
        raise OSError(f"Unsupported header size {size!r}")
    header = data[8:8 + size - 4]
    if len(header) != 120:
        raise OSError(f"Incomplete header: {len(header)} bytes")
    _, height, width = struct.unpack("<3I", header[:12])
    pfflags, fourcc, bitcount = struct.unpack("<3I", header[72:84])
    pos = 4 + size
    if pfflags & _RGB:
        n = 4 if pfflags & _ALPHAPIXELS else 3
        masks = struct.unpack(f"<{n}I", header[84:84 + 4 * n])
        return lambda: _rgb(data[pos:], width, height, bitcount, masks)
    if pfflags & _LUMINANCE:
        if bitcount == 8:
            return lambda: _grey3(_raw(data, pos, width, height, 1))
        if bitcount == 16 and pfflags & _ALPHAPIXELS:
            return lambda: _grey3(_raw(data, pos, width, height, 2)[..., 0])
        raise OSError(f"Unsupported bitcount {bitcount} for {pfflags}")
    if pfflags & _PAL8:
        pal = np.zeros((256, 4), np.uint8)
        raw = np.frombuffer(data[pos:pos + 1024], np.uint8)
        pal.reshape(-1)[:len(raw)] = raw
        return lambda: pal[_raw(data, pos + 1024, width, height, 1), :3]
    if pfflags & _FOURCC:
        if fourcc in _FOURCCS:
            n, fmt = _FOURCCS[fourcc]
        elif fourcc == _DX10:
            if len(data) < pos + 20:
                raise SyntaxError("a short DX10 header")  # struct.error
            dxgi = _cc(data[pos:pos + 4])
            pos += 20
            if dxgi not in _DXGI:
                raise NotImplementedError(f"Unimplemented DXGI format {dxgi}")
            n, fmt = _DXGI[dxgi]
            if n == 0:
                return lambda: _raw(data, pos, width, height, 4)[..., :3]
        else:
            raise NotImplementedError(
                f"Unimplemented pixel format {fourcc!r}")
        return lambda: to_rgb(bcn.decode(data[pos:], width, height, n, fmt))
    raise NotImplementedError(f"Unknown pixel format flags {pfflags}")


def to_rgb(px: np.ndarray) -> np.ndarray:
    """An L (H, W, 1), RGB or RGBA image -> convert("RGB")."""
    return _grey3(px[..., 0]) if px.shape[-1] == 1 else \
        np.ascontiguousarray(px[..., :3])


def _grey3(v: np.ndarray) -> np.ndarray:
    return np.repeat(v[..., None], 3, axis=-1)


def _raw(data: bytes, pos: int, w: int, h: int, bpp: int) -> np.ndarray:
    """Pillow's raw decoder on the bytes from `pos`: too few raise
    OSError as ImageFile.load's truncated-file error."""
    n = w * h * bpp
    if len(data) - pos < n:
        raise OSError("image file is truncated")
    px = np.frombuffer(data, np.uint8, n, pos).reshape(h, w, bpp)
    return px[..., 0] if bpp == 1 else px


def _rgb(body: bytes, w: int, h: int, bitcount: int, masks) -> np.ndarray:
    """DdsRgbDecoder: one little-endian value of bitcount // 8 bytes per
    pixel (zeros past the end of the file), each mask's field scaled to
    8 bits."""
    nbytes = bitcount // 8
    npx = w * h
    raw = np.zeros(npx * nbytes, np.uint8)
    got = np.frombuffer(body[:npx * nbytes], np.uint8)
    raw[:len(got)] = got
    value = np.zeros(npx, np.uint64)
    for k in range(nbytes):
        value |= raw[k::nbytes].astype(np.uint64) << np.uint64(8 * k)
    out = np.zeros((npx, len(masks)), np.uint8)
    for i, mask in enumerate(masks):
        if not mask:
            continue
        shift = (mask & -mask).bit_length() - 1
        total = mask >> shift
        field = (value & np.uint64(mask)) >> np.uint64(shift)
        out[:, i] = (field.astype(np.float64) / total * 255).astype(np.uint8)
    return out.reshape(h, w, -1)[..., :3]


def encode_dds(px: np.ndarray) -> bytes:
    """DdsImagePlugin._save with no pixel_format for Image.fromarray(px)
    (mode L, RGB or RGBA)."""
    h, w = px.shape[:2]
    c = 1 if px.ndim == 2 else px.shape[2]
    if c == 1:
        flags, masks, body = _LUMINANCE, [0xFF000000] * 3 + [0], px
    else:
        flags = _RGB | (_ALPHAPIXELS if c == 4 else 0)
        masks = [0xFF0000, 0xFF00, 0xFF, 0xFF000000 if c == 4 else 0]
        body = px[..., [2, 1, 0, 3][:c]]
    bitcount = 8 * c
    head = b"DDS " + struct.pack("<7I", 124, 0x100F, h, w,
                                 (w * bitcount + 7) // 8, 0, 0)
    head += bytes(44) + struct.pack("<4I", 32, flags, 0, bitcount)
    head += struct.pack("<4I", *masks) + struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    return head + np.ascontiguousarray(body, np.uint8).tobytes()
