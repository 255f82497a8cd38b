"""FTEX texture files (IW2:EOC), as Pillow 12.1's FtexImagePlugin opens
them (no PIL): the first mipmap of the one format, DXT1 through
io/bcn.py or uncompressed RGB rows.  Pillow's refusals: a format count
other than 1 fails its assert (AssertionError), an unknown format is a
ValueError, a negative data offset fails the seek (OSError), and a
header cut short is given up (struct.error)."""
from __future__ import annotations

import struct

from . import bcn
from .dds import _raw, to_rgb


def open_ftex(data: bytes):
    """FtexImageFile._open -> a function that decodes the file."""
    try:
        w, h, _, count = struct.unpack_from("<4i", data, 8)
        assert count == 1
        fmt, where = struct.unpack_from("<2i", data, 24)
        if where < 0:
            raise OSError("[Errno 22] Invalid argument")    # fp.seek
        (size,) = struct.unpack_from("<i", data, where)
    except struct.error:
        raise SyntaxError("a short FTEX header") from None
    # fp.read(size) with a negative size reads to the end of the file
    body = data[where + 4:] if size < 0 else data[where + 4:where + 4 + size]
    if fmt == 0:
        return lambda: to_rgb(bcn.decode(body, w, h, 1))
    if fmt == 1:
        return lambda: _raw(body, 0, w, h, 3)
    raise ValueError(f"Invalid texture compression format: {fmt!r}")
