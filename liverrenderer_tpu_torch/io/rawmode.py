"""Pillow 12.1's "raw" decoder and `convert("RGB")`, for the plugins whose
pixels are stored as they lie in memory: FITS, SPIDER, McIdas, PIXAR, XV
thumbnails, IMT, GBR, IM and the PPM extensions.

`raw_tile` reads one raw tile as ImageFile.load does: rows of the
rawmode's bytes from the tile's offset, `stride` bytes apart (0: packed),
bottom-up where `ystep` < 0; a tile that runs past the end of the file is
"image file is truncated" (OSError).  A file Image.open was handed by its
path, with one raw tile whose rawmode is its mode and one of Pillow's
mappable modes, is memory-mapped instead: the same pixels, but a short
file is map_buffer's ValueError.  `FROM_PATH` says which (io/image.py's
read_8bit sets it; identify alone reads as Image.open of a stream).

`to_rgb` is Pillow's convert("RGB") from each mode, on the arrays
`raw_tile` returns: L, P and "1" (H, W) uint8 ("1" as 0 / 255), I and
I;16* (H, W) int64, F (H, W) float32, LA, PA, RGB, RGBA, CMYK and YCbCr
(H, W, bands) uint8.  A P image without a palette has Pillow's empty one:
every index reads black.
"""
from __future__ import annotations

import contextvars

import numpy as np

FROM_PATH = contextvars.ContextVar("FROM_PATH", default=False)

# Image._MAPMODES, and map_buffer's row bytes for each
MAPMODES = ("L", "P", "RGBX", "RGBA", "CMYK", "I;16", "I;16L", "I;16B")

# rawmode -> (mode, bits a pixel); the unpackers Unpack.c has for these
# modes and the plugins use
BITS = {
    "1": ("1", 1), "L": ("L", 8), "P": ("P", 8), "P;2": ("P", 2),
    "P;4": ("P", 4), "RGB": ("RGB", 24), "RGB;L": ("RGB", 24),
    "RGBX": ("RGB", 32), "RGBX;L": ("RGB", 32), "RGBA": ("RGBA", 32),
    "RGBA;L": ("RGBA", 32), "CMYK": ("CMYK", 32), "CMYK;L": ("CMYK", 32),
    "LA;L": ("LA", 16), "PA;L": ("PA", 16), "YCbCr;L": ("YCbCr", 24),
    "R": ("RGB", 8), "G": ("RGB", 8), "B": ("RGB", 8),
    "I;16": ("I;16", 16), "I;16L": ("I;16L", 16), "I;16B": ("I;16B", 16),
    "I": ("I", 32), "I;32": ("I", 32), "I;32S": ("I", 32),
    "I;32B": ("I", 32), "F": ("F", 32), "F;8": ("F", 8), "F;8S": ("F", 8),
    "F;16": ("F", 16), "F;16S": ("F", 16), "F;32": ("F", 32),
    "F;32S": ("F", 32), "F;32F": ("F", 32), "F;32BF": ("F", 32)}
# the sample type of the one-band rawmodes of 16 and 32 bits
_DTYPES = {"I;16": "<u2", "I;16L": "<u2", "I;16B": ">u2", "I": "<i4",
           "I;32": "<i4", "I;32S": "<i4", "I;32B": ">i4", "F": "<f4",
           "F;16": "<u2", "F;16S": "<i2", "F;32": "<u4", "F;32S": "<i4",
           "F;32F": "<f4", "F;32BF": ">f4"}


def _linesize(mode: str, w: int) -> int:
    """map_buffer's row bytes for a mapped mode."""
    return w if mode in ("L", "P") else 2 * w if mode.startswith("I;16") \
        else 4 * w


def tile_rows(data: bytes, offset: int, w: int, h: int, bits: int,
              stride: int = 0, ystep: int = 1, mapped_mode: str = None):
    """The (h, row bytes) uint8 rows of a raw tile, top row first, as
    ImageFile.load feeds RawDecode.c (or map_buffer maps them when
    `mapped_mode` names the mode of a mapped file)."""
    if mapped_mode is not None:
        if offset < 0:
            raise ValueError("Tile offset cannot be negative")
        if offset + h * stride <= len(data):        # else: not mapped
            step = stride if stride > 0 else _linesize(mapped_mode, w)
            nbytes = (w * bits + 7) // 8
            # (a stride shorter than a row maps rows past the buffer's
            # end in Pillow; refused here)
            if offset + h * step > len(data) \
                    or offset + (h - 1) * step + nbytes > len(data):
                raise ValueError("buffer is not large enough")
            rows = np.lib.stride_tricks.as_strided(
                np.frombuffer(data, np.uint8, offset=offset), (h, nbytes),
                (step, 1))
            return np.ascontiguousarray(rows[::-1] if ystep < 0 else rows)
    check_seek(offset)
    nbytes = (w * bits + 7) // 8
    skip = stride - nbytes if stride else 0
    if offset >= len(data):
        raise OSError("image file is truncated (0 bytes not processed)")
    if skip < 0:
        raise OSError("decoder error -8 when reading image file")
    need = offset + (h - 1) * (nbytes + skip) + nbytes
    if need > len(data):
        raise OSError("image file is truncated")
    rows = np.lib.stride_tricks.as_strided(
        np.frombuffer(data, np.uint8, offset=offset), (h, nbytes),
        (nbytes + skip, 1))
    return np.ascontiguousarray(rows[::-1] if ystep < 0 else rows)


def check_seek(offset: int):
    """ImageFile.load's seek to a tile: a negative offset is a file's
    OSError, a stream's ValueError."""
    if offset < 0:
        raise (OSError if FROM_PATH.get() else ValueError)(
            f"negative seek value {offset}")


def unpack(rows: np.ndarray, rawmode: str, w: int) -> np.ndarray:
    """(h, row bytes) uint8 -> the pixels of the rawmode's mode."""
    mode, bits = BITS[rawmode]
    h = rows.shape[0]
    if bits < 8:
        v = np.unpackbits(rows, axis=1).reshape(h, -1, bits)
        v = (v * (1 << np.arange(bits - 1, -1, -1, dtype=np.uint8))) \
            .sum(-1, dtype=np.uint8)[:, :w]
        return v * 255 if mode == "1" else v
    if rawmode in _DTYPES:
        v = rows.view(_DTYPES[rawmode]).reshape(h, w)
        return v.astype(np.float32) if mode == "F" else v.astype(np.int64)
    if rawmode in ("F;8", "F;8S"):
        return rows.view(np.int8 if rawmode == "F;8S" else np.uint8) \
            .astype(np.float32)
    if bits == 8:                                  # L, P and the bands
        return rows
    bands = bits // 8
    if rawmode.endswith(";L"):                     # line-interleaved
        px = rows.reshape(h, bands, w).transpose(0, 2, 1)
    else:
        px = rows.reshape(h, w, bands)
    if rawmode.startswith("RGBX"):
        px = px[..., :3]
    return np.ascontiguousarray(px)


def raw_tile(data: bytes, offset: int, size, mode: str, rawmode: str,
             stride: int = 0, ystep: int = 1,
             mappable: bool = True) -> np.ndarray:
    """One raw tile (ImageFile._Tile("raw", (0, 0) + size, offset,
    (rawmode, stride, ystep))) of an image of `mode` -> its pixels;
    `mappable`: False where Pillow would not map the file whatever the
    mode (an image of several tiles, or a rawmode Pillow names otherwise
    than the unpacker used here)."""
    if rawmode not in BITS or BITS[rawmode][0] != mode \
            and not (mode == "RGB" and rawmode in ("R", "G", "B")):
        raise ValueError("unknown raw mode for given image mode")
    w, h = size
    mapped = FROM_PATH.get() and mappable and rawmode == mode \
        and mode in MAPMODES
    rows = tile_rows(data, offset, w, h, BITS[rawmode][1], stride, ystep,
                     mode if mapped else None)
    return unpack(rows, rawmode, w)


def float_to_grey(v: np.ndarray) -> np.ndarray:
    """Pillow's F -> L conversion: truncate, clip to 0..255, NaN -> 0."""
    f = np.asarray(v, np.float32)
    grey = np.zeros(f.shape, np.uint8)
    mid = (f > 0) & (f < 255)
    grey[mid] = f[mid].astype(np.uint8)
    grey[f >= 255] = 255
    return grey


def cmyk_to_rgb(c: np.ndarray) -> np.ndarray:
    """Pillow's cmyk2rgb on (..., 4) uint8."""
    c = c.astype(np.int64)
    nk = 255 - c[..., 3:4]
    t = c[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def _table(k: float, c: int, scale: int = 1) -> np.ndarray:
    """A conversion table as Pillow's were generated: (int)(x + 0.5)."""
    return np.trunc(k * scale * (np.arange(256) - c) + 0.5).astype(np.int64)


# ConvertYCbCr.c: JPEG's YCbCr, 6 fraction bits
_R_CR, _G_CB, _G_CR, _B_CB = (_table(1.402, 128, 64),
                              _table(-0.34414, 128, 64),
                              _table(-0.71414, 128, 64),
                              _table(1.772, 128, 64))
# UnpackYCC.c: Kodak's PhotoYCC (the "YCC;P" unpacker of PCD)
_YCC_L, _YCC_CB, _YCC_CR = (_table(1.3584, 0), _table(2.2179, 156),
                            _table(1.8215, 137))
_YCC_GB, _YCC_GR = _table(-0.194 * 2.2179, 156), _table(-0.509 * 1.8215, 137)


def ycbcr_to_rgb(p: np.ndarray) -> np.ndarray:
    """Pillow's ImagingConvertYCbCr2RGB on (..., 3) uint8."""
    y, cb, cr = (p[..., i].astype(np.int64) for i in range(3))
    rgb = np.stack([y + (_R_CR[cr] >> 6), y + ((_G_CB[cb] + _G_CR[cr]) >> 6),
                    y + (_B_CB[cb] >> 6)], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def photoycc_to_rgb(p: np.ndarray) -> np.ndarray:
    """Pillow's ImagingUnpackYCC (PhotoYCC -> RGB) on (..., 3) uint8."""
    lum = _YCC_L[p[..., 0]]
    cb, cr = p[..., 1], p[..., 2]
    rgb = np.stack([lum + _YCC_CR[cr], lum + _YCC_GR[cr] + _YCC_GB[cb],
                    lum + _YCC_CB[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def to_rgb(px: np.ndarray, mode: str, palette=None) -> np.ndarray:
    """Pillow's convert("RGB") from `mode` -> (H, W, 3) uint8; `palette`:
    (n, 3) uint8 of a P or PA image (None: Pillow's empty palette)."""
    if mode in ("P", "PA"):
        idx = px if mode == "P" else px[..., 0]
        if palette is None:
            return np.zeros(idx.shape + (3,), np.uint8)
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(palette)] = palette[:256]
        return pal[idx]
    if mode == "F":
        grey = float_to_grey(px)
    elif mode == "I" or mode.startswith("I;16"):
        grey = np.clip(px, 0, 255).astype(np.uint8)
    elif mode in ("1", "L"):
        grey = px
    elif mode == "LA":
        grey = px[..., 0]
    elif mode == "CMYK":
        return cmyk_to_rgb(px)
    elif mode == "YCbCr":
        return ycbcr_to_rgb(px)
    else:                                            # RGB, RGBA
        return np.ascontiguousarray(px[..., :3], dtype=np.uint8)
    return np.repeat(np.asarray(grey, np.uint8)[..., None], 3, -1)


def frombytes(data: bytes, size, mode: str, rawmode: str = None):
    """Image.frombytes / ImageFile.set_as_raw: top-down, packed ->
    pixels; short data is ValueError("not enough image data")."""
    w, h = size
    bits = BITS[rawmode or mode][1]
    nbytes = (w * bits + 7) // 8
    if len(data) < nbytes * h:
        raise ValueError("not enough image data")
    rows = np.frombuffer(data, np.uint8, nbytes * h).reshape(h, nbytes)
    return unpack(rows, rawmode or mode, w)
