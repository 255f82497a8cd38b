"""Blizzard Mipmap (BLP1, BLP2) files, as Pillow 12.1's BlpImagePlugin
opens them (no PIL): the first mipmap.

BLP1: JPEG (the shared header before the mipmap's bytes, opened with the
JPEG plugin's header checks, whose SyntaxError here reaches the caller,
decoded by io/jpeg.py, a four-component stream with libjpeg told that it
is CMYK (the plugin's "CMYK" jpegmode: a YCCK stream is not converted),
then the plugin's "BGR" raw read that swaps red and blue) and palette
(encodings 4 and 5, the indices right after the palette).  BLP2: palette
and DXT1/3/5 at the mipmap's offset, through the plugin's own Python
decode_dxt1/3/5 (`dxt1`, `dxt3`, `dxt5` here, vectorised): 5:6:5 colours
shifted without bit replication, DXT3 alpha x 17, DXT1's transparent
black only with alpha.  Their rows are ceil(w / 4) * 4 pixels wide and
are read back as rows of w pixels, as Pillow's set_as_raw reads them.
Pillow's refusals keep their classes: BLPFormatError is a
NotImplementedError, a short read an OSError, too little pixel data a
ValueError ("not enough image data"), and a header cut short gives the
file up (struct.error).
"""
from __future__ import annotations

import struct

import numpy as np

from .jpeg import read_jpeg


class BLPFormatError(NotImplementedError):
    """Pillow's BlpImagePlugin.BLPFormatError."""


def open_blp(data: bytes):
    """BlpImageFile._open -> a function that decodes the file."""
    try:
        magic = data[:4]
        compression = struct.unpack_from("<i", data, 4)[0]
        if magic == b"BLP1":
            alpha = struct.unpack_from("<I", data, 8)[0] != 0
            w, h = struct.unpack_from("<II", data, 12)
            encoding = struct.unpack_from("<i", data, 20)[0]
        else:
            encoding, alpha, alpha_enc = struct.unpack_from("<3b", data, 8)
            alpha = alpha != 0
            w, h = struct.unpack_from("<II", data, 12)
    except struct.error:
        raise SyntaxError("a short BLP header") from None
    if magic == b"BLP1":
        return lambda: _blp1(data, w, h, compression, encoding, alpha)
    return lambda: _blp2(data, w, h, compression, encoding, alpha, alpha_enc)


class _Reader:
    """ImageFile._safe_read over the file's bytes."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        if n <= 0:
            return b""
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        if len(out) < n:
            raise OSError("Truncated File Read")
        return out


def _tables(r: _Reader):
    offsets = struct.unpack("<16I", r.read(64))
    lengths = struct.unpack("<16I", r.read(64))
    return offsets, lengths


def _palette(r: _Reader) -> np.ndarray:
    """256 BGRA entries -> (256, 4) RGBA."""
    bgra = np.frombuffer(r.read(1024), np.uint8).reshape(256, 4)
    return bgra[:, [2, 1, 0, 3]]


def _indexed(r: _Reader, n: int, pal: np.ndarray, alpha: bool) -> bytes:
    idx = np.frombuffer(r.read(n), np.uint8)
    return pal[idx, :4 if alpha else 3].tobytes()


def _as_raw(buf: bytes, w: int, h: int, alpha: bool) -> np.ndarray:
    """set_as_raw(data) in mode RGB or RGBA -> (H, W, 3)."""
    c = 4 if alpha else 3
    if len(buf) < w * h * c:
        raise ValueError("not enough image data")
    px = np.frombuffer(buf, np.uint8, w * h * c).reshape(h, w, c)
    return np.ascontiguousarray(px[..., :3])


def _blp1(data, w, h, compression, encoding, alpha):
    r = _Reader(data, 28)
    offsets, lengths = _tables(r)
    if compression == 0:
        (size,) = struct.unpack("<I", r.read(4))
        header = r.read(size)
        r.read(offsets[0] - r.pos)
        rgb = read_jpeg(header + r.read(lengths[0]), as_cmyk=True)
        return np.ascontiguousarray(rgb[..., ::-1])      # read as "BGR"
    if compression == 1:
        if encoding not in (4, 5):
            raise BLPFormatError(
                f"Unsupported BLP encoding {encoding!r}")
        pal = _palette(r)
        return _as_raw(_indexed(r, lengths[0], pal, alpha), w, h, alpha)
    raise BLPFormatError(f"Unsupported BLP compression {encoding!r}")


def _blp2(data, w, h, compression, encoding, alpha, alpha_enc):
    r = _Reader(data, 20)
    offsets, lengths = _tables(r)
    pal = _palette(r)
    r.pos = offsets[0]
    if compression != 1:
        raise BLPFormatError(
            f"Unknown BLP compression {compression!r}")
    if encoding == 1:
        buf = _indexed(r, lengths[0], pal, alpha)
    elif encoding == 2:
        if alpha_enc not in (0, 1, 7):
            raise BLPFormatError(
                f"Unsupported alpha encoding {alpha_enc!r}")
        size = 8 if alpha_enc == 0 else 16
        bw, bh = (w + 3) // 4, (h + 3) // 4
        rows = [r.read(bw * size) for _ in range(bh)]
        blocks = np.frombuffer(b"".join(rows), np.uint8).reshape(-1, size)
        px = dxt1(blocks, alpha) if alpha_enc == 0 else \
            dxt3(blocks) if alpha_enc == 1 else dxt5(blocks)
        c = px.shape[-1]
        buf = px.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4).tobytes()
    else:
        raise BLPFormatError(f"Unknown BLP encoding {encoding!r}")
    return _as_raw(buf, w, h, alpha)


# ------------------------------------ BlpImagePlugin's DXT decoders ----
def _565(c):
    return ((c >> 11) & 0x1F) << 3, ((c >> 5) & 0x3F) << 2, (c & 0x1F) << 3


def _colours(blocks, three):
    """The four colours of each block's 8-byte colour half -> (nb, 4, 3),
    and the (nb, 16) colour codes."""
    w = blocks.astype(np.int64)
    c0 = w[:, 0] | (w[:, 1] << 8)
    c1 = w[:, 2] | (w[:, 3] << 8)
    code = w[:, 4] | (w[:, 5] << 8) | (w[:, 6] << 16) | (w[:, 7] << 24)
    e0, e1 = np.stack(_565(c0), -1), np.stack(_565(c1), -1)
    four = (c0 > c1)[:, None] if three else True
    p = np.stack([e0, e1,
                  np.where(four, (2 * e0 + e1) // 3, (e0 + e1) // 2),
                  np.where(four, (2 * e1 + e0) // 3, 0)], 1)
    return p, (code[:, None] >> (2 * np.arange(16))) & 3, c0 > c1


def dxt1(blocks: np.ndarray, alpha: bool) -> np.ndarray:
    """decode_dxt1 over (nb, 8) blocks -> (nb, 16, 3 or 4)."""
    p, code, four = _colours(blocks, True)
    rgb = np.take_along_axis(p, code[..., None], 1)
    if not alpha:
        return rgb.astype(np.uint8)
    a = np.where((code == 3) & ~four[:, None], 0, 255)
    return np.concatenate([rgb, a[..., None]], -1).astype(np.uint8)


def dxt3(blocks: np.ndarray) -> np.ndarray:
    """decode_dxt3 over (nb, 16) blocks -> (nb, 16, 4)."""
    p, code, _ = _colours(blocks[:, 8:], False)
    rgb = np.take_along_axis(p, code[..., None], 1)
    nib = np.stack([blocks[:, :8] & 15, blocks[:, :8] >> 4], -1)
    a = nib.reshape(-1, 16).astype(np.int64) * 17
    return np.concatenate([rgb, a[..., None]], -1).astype(np.uint8)


def dxt5(blocks: np.ndarray) -> np.ndarray:
    """decode_dxt5 over (nb, 16) blocks -> (nb, 16, 4)."""
    p, code, _ = _colours(blocks[:, 8:], False)
    rgb = np.take_along_axis(p, code[..., None], 1)
    w = blocks.astype(np.int64)
    a0, a1 = w[:, :1], w[:, 1:2]
    bits = np.zeros(len(w), np.int64)
    for k in range(6):
        bits |= w[:, 2 + k] << (8 * k)
    c = (bits[:, None] >> (3 * np.arange(16))) & 7
    seven = ((8 - c) * a0 + (c - 1) * a1) // 7
    five = np.where(c == 6, 0, np.where(c == 7, 255,
                                        ((6 - c) * a0 + (c - 1) * a1) // 5))
    a = np.where(c == 0, a0, np.where(c == 1, a1,
                                      np.where(a0 > a1, seven, five)))
    return np.concatenate([rgb, a[..., None]], -1).astype(np.uint8)
