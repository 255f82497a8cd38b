"""Apple icon files (ICNS) read as Pillow 12.1's IcnsImagePlugin reads
them: the largest size that has an entry Pillow reads.

Every entry of that size is read, in IcnsFile.SIZES' order: PNG entries
through io/png.py (read from the entry's start to the PNG's end), the
32-bit RGB entries (`is32`, `il32`, `ih32`, and `it32` after its four zero
bytes) raw when they hold exactly three planes, else as Pillow's
PackBits-like run lengths read plane by plane from the file (not bounded
by the entry), and the 8-bit masks (`s8mk`, `l8mk`, `h8mk`, `t8mk`).  A
PNG (or JPEG 2000) entry's image wins over the RGB planes; the mask only
becomes alpha, which convert("RGB") drops.  A JPEG 2000 entry (a
codestream, or JP2 boxes) opens as Jpeg2KImageFile opens the entry's
bytes (io/pil_open.py), the decompression-bomb test on its size, and
decodes through io/jpeg2000.py.  The
loaded image's size must be one the file allows (IcnsImageFile.size's
setter), else ValueError.

Writing follows IcnsImagePlugin._save: the image resized bicubically
(io/resample.py; RGBA through premultiplied RGBa) to each of the six
sizes of `WRITE_SIZES`, each stored as a PNG (io/png.encode_png: Pillow's
PNG entries hold the same pixels in other deflate bytes), the 256 and 512
streams twice, after a table of contents.
"""
from __future__ import annotations

import struct

import numpy as np

from . import resample
from .pil_open import MAX_IMAGE_PIXELS, DecompressionBombError, \
    _pillow_open, open_jpeg2000
from .png import encode_png

# IcnsFile.SIZES: (width, height, scale) -> its entries, in order
SIZES = {
    (512, 512, 2): ((b"ic10", "png"),), (512, 512, 1): ((b"ic09", "png"),),
    (256, 256, 2): ((b"ic14", "png"),), (256, 256, 1): ((b"ic08", "png"),),
    (128, 128, 2): ((b"ic13", "png"),),
    (128, 128, 1): ((b"ic07", "png"), (b"it32", "rgb_t"), (b"t8mk", "mask")),
    (64, 64, 1): ((b"icp6", "png"),), (32, 32, 2): ((b"ic12", "png"),),
    (48, 48, 1): ((b"ih32", "rgb"), (b"h8mk", "mask")),
    (32, 32, 1): ((b"icp5", "png"), (b"il32", "rgb"), (b"l8mk", "mask")),
    (16, 16, 2): ((b"ic11", "png"),),
    (16, 16, 1): ((b"icp4", "png"), (b"is32", "rgb"), (b"s8mk", "mask"))}


# IcnsImagePlugin._save's entries, in the order written
WRITE_SIZES = {b"ic07": 128, b"ic08": 256, b"ic09": 512, b"ic10": 1024,
               b"ic11": 32, b"ic12": 64, b"ic13": 256, b"ic14": 512}


def encode_icns(px: np.ndarray) -> bytes:
    """(H, W), (H, W, 3) or (H, W, 4) uint8 -> Pillow 12.1's ICNS file for
    Image.fromarray(px) (its PNG entries as io/png writes them)."""
    streams = {s: encode_png(resample.resize(px, (s, s), resample.BICUBIC))
               for s in sorted(set(WRITE_SIZES.values()))}
    toc = b"TOC " + struct.pack(">i", 8 + 8 * len(WRITE_SIZES))
    body = b""
    for code, s in WRITE_SIZES.items():
        toc += code + struct.pack(">i", 8 + len(streams[s]))
        body += code + struct.pack(">i", 8 + len(streams[s])) + streams[s]
    return b"icns" + struct.pack(">i", 8 + len(toc) + len(body)) + toc + body


@_pillow_open
def open_icns(fp):
    """IcnsImageFile._open (IcnsFile's walk over the entries, bestsize)."""
    sig, filesize = struct.unpack(">4sI", fp.read(8))
    if not sig.startswith(b"icns"):
        raise SyntaxError("not an icns file")
    entries = {}
    i = 8
    while i < filesize:
        sig, blocksize = struct.unpack(">4sI", fp.read(8))
        if blocksize <= 0:
            raise SyntaxError("invalid block header")
        i += 8
        blocksize -= 8
        entries[sig] = (i, blocksize)
        fp.seek(blocksize, 1)
        i += blocksize
    sizes = [s for s, kinds in SIZES.items()
             if any(k in entries for k, _ in kinds)]
    if not sizes:
        raise SyntaxError("No 32bit icon resources found")
    best = max(sizes)
    data = fp.getvalue()
    return "RGBA", (best[0] * best[2], best[1] * best[2]), \
        lambda: _load(data, entries, sizes, best)


def _load(data, entries, sizes, best) -> np.ndarray:
    """IcnsImageFile.load: IcnsFile.getimage(best), then the size test."""
    from .png import decode_png
    channels = {}
    w, h = best[0] * best[2], best[1] * best[2]
    for code, kind in SIZES[best]:
        if code not in entries:
            continue
        start, length = entries[code]
        if kind == "png":
            sig = data[start:start + 12]
            if sig.startswith(b"\x89PNG\r\n\x1a\n"):
                png_w, png_h = struct.unpack_from(">II", data, start + 16)
                if png_w * png_h > 2 * MAX_IMAGE_PIXELS:
                    raise DecompressionBombError(
                        f"Image size ({png_w * png_h} pixels) exceeds limit")
                channels["RGBA"] = lambda s=start: decode_png(data[s:])
            elif sig.startswith((b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")) \
                    or sig == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a":
                channels["RGBA"] = open_jpeg2000(data[start:start + length])
            else:
                raise ValueError("Unsupported icon subimage format")
        elif kind == "mask":
            channels["A"] = _band(data[start:start + w * h], w, h)
        else:
            if kind == "rgb_t":
                if data[start:start + 4] != b"\x00" * 4:
                    raise SyntaxError("Unknown signature, expecting "
                                      "0x00000000")
                start, length = start + 4, length - 4
            channels["RGB"] = _read_32(data, start, length, w, h)
    if "RGBA" in channels:
        img = channels["RGBA"]()
    else:
        img = channels["RGB"]
    ih, iw = img.shape[:2]
    for s in sizes:                        # IcnsImageFile.size's setter
        sw, sh = s[0] * s[2], s[1] * s[2]
        if sh / ih == sw // iw:
            return img
    raise ValueError("This is not one of the allowed sizes of this image")


def _band(raw: bytes, w: int, h: int) -> np.ndarray:
    """Image.frombuffer("L", ...) of a mapped band: short is ValueError."""
    if len(raw) < w * h:
        raise ValueError("buffer is not large enough")
    return np.frombuffer(raw, np.uint8, w * h).reshape(h, w)


def _read_32(data, start, length, w, h) -> np.ndarray:
    """read_32: three raw planes, or three run-length planes."""
    n = w * h
    if length == n * 3:
        raw = data[start:start + length]
        if len(raw) < length:
            raise ValueError("not enough image data")
        return np.frombuffer(raw, np.uint8).reshape(h, w, 3).copy()
    out = np.zeros((h, w, 3), np.uint8)
    pos = start
    for band in range(3):
        chunks = []
        left = n
        while left > 0:
            if pos >= len(data):
                break
            b = data[pos]
            pos += 1
            if b & 0x80:
                count = b - 125
                chunks.append(data[pos:pos + 1] * count)
                pos += 1
            else:
                count = b + 1
                chunks.append(data[pos:pos + count])
                pos += count
            left -= count
        if left != 0:
            raise SyntaxError(f"Error reading channel [{left!r} left]")
        out[..., band] = _band(b"".join(chunks), w, h)
    return out
