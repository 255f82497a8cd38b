"""FITS images read as Pillow 12.1's FitsImagePlugin reads them.

The 80-byte header cards up to the first header unit with an image (its
NAXIS and BITPIX, or a GZIP_1-compressed BINTABLE extension's ZNAXIS and
ZBITPIX), then one tile:

- raw: the data unit as Pillow's raw decoder unpacks it, bottom-up, with
  the image's mode as the rawmode.  So BITPIX 16 and 32 read their
  big-endian samples as little-endian "I;16" and "I", -32 reads as
  little-endian floats and -64 as the first half of the doubles' bytes
  taken as little-endian floats: Pillow's quirk, mirrored.
- fits_gzip (FitsGzipDecoder): everything after the table's rows through
  the standard gzip, each 4-byte word's last min(ZBITPIX / 8, 4) bytes
  kept (none for negative ZBITPIX: "not enough image data"), rows in
  reverse order, then the mode's raw unpacker.
"""
from __future__ import annotations

import gzip
import math

import numpy as np

from .pil_open import _pillow_open
from .rawmode import check_seek, frombytes, raw_tile, to_rgb


@_pillow_open
def open_fits(fp):
    """FitsImageFile._open: header cards to the first header with an
    image."""
    headers = {}
    in_progress = False
    found = None
    while True:
        header = fp.read(80)
        if not header:
            raise OSError("Truncated FITS file")
        keyword = header[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break
        elif keyword == b"END":
            fp.seek(math.ceil(fp.tell() / 2880) * 2880)
            if not found:
                found = _parse_headers(headers)
            in_progress = False
            continue
        if found:
            continue
        value = header[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE")
                            or value != b"T"):
            raise SyntaxError("Not a FITS file")
        headers[keyword] = value
    if not found:
        raise ValueError("No image data")
    mode, size, gzip_bits, offset = found
    offset += fp.tell() - 80
    data = fp.getvalue()
    if gzip_bits is None:
        return mode, size, lambda: to_rgb(
            raw_tile(data, offset, size, mode, mode, 0, -1), mode)

    def load():
        check_seek(offset)
        return to_rgb(_gzip_tile(data[offset:], size, mode, gzip_bits), mode)
    return mode, size, load


def _parse_headers(headers):
    """FitsImageFile._parse_headers -> (mode, size, ZBITPIX or None for a
    raw tile, the tile's offset past the data unit's start), or None."""
    def get_size(prefix):
        naxis = int(headers[prefix + b"NAXIS"])
        if naxis == 0:
            return None
        if naxis == 1:
            return 1, int(headers[prefix + b"NAXIS1"])
        return (int(headers[prefix + b"NAXIS1"]),
                int(headers[prefix + b"NAXIS2"]))

    prefix = b""
    offset = 0
    compressed = headers.get(b"XTENSION") == b"'BINTABLE'" \
        and headers.get(b"ZIMAGE") == b"T" \
        and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"
    if compressed:
        rows = get_size(prefix) or (0, 0)
        offset = rows[0] * rows[1] * (int(headers[b"BITPIX"]) // 8)
        prefix = b"Z"
    size = get_size(prefix)
    if not size:
        return None
    bits = int(headers[prefix + b"BITPIX"])
    mode = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}.get(bits, "")
    return mode, size, bits if compressed else None, offset


def _gzip_tile(rest: bytes, size, mode: str, bits: int) -> np.ndarray:
    """FitsGzipDecoder.decode on the file's bytes after the tile offset."""
    value = gzip.decompress(rest)
    w, h = size
    nb = min(bits // 8, 4)
    if nb <= 0 or len(value) < 4 * w * h:
        raise ValueError("not enough image data")
    words = np.frombuffer(value, np.uint8, 4 * w * h).reshape(h, w, 4)
    rows = words[::-1, :, 4 - nb:]
    return frombytes(rows.tobytes(), size, mode)
