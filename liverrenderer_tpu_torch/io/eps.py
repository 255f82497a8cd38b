"""Encapsulated PostScript as Pillow 12.1's EpsImagePlugin._save writes an
L or RGB image: the `%%Creator: PIL 0.1 EpsEncode` header, the image
operator (`image` for L, `false 3 colorimage` for RGB) and the pixels in
lowercase hex; Pillow's "%ImageData" and "%%%%EndBinary" lines as it
writes them (EpsEncode.c: 39 bytes, 78 digits, to a line, the lines
running on across rows, no newline after the last), then the trailer.
Another mode raises ValueError, as Pillow's writer does.  `read_eps_hex`
reads such a file's pixels back.
"""
from __future__ import annotations

import numpy as np

_BYTES_PER_LINE = 79 // 2


def encode_eps(px: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3) uint8 -> the bytes Pillow saves as EPS."""
    px = np.asarray(px, np.uint8)
    if px.ndim == 2:
        bands, op = 1, b"image"
    elif px.shape[2] == 3:
        bands, op = 3, b"false 3 colorimage"
    else:
        raise ValueError("image mode is not supported")
    h, w = px.shape[:2]
    head = (b"%!PS-Adobe-3.0 EPSF-3.0\n%%Creator: PIL 0.1 EpsEncode\n"
            + b"%%%%BoundingBox: 0 0 %d %d\n" % (w, h)
            + b"%%Pages: 1\n%%EndComments\n%%Page: 1 1\n"
            + b"%%ImageData: %d %d " % (w, h)
            + b'%d %d 0 1 1 "%s"\n' % (8, bands, op)
            + b"gsave\n10 dict begin\n"
            + b"/buf %d string def\n" % (w * bands)
            + b"%d %d scale\n" % (w, h) + b"%d %d 8\n" % (w, h)
            + b"[%d 0 0 -%d 0 %d]\n" % (w, h, h)
            + b"{ currentfile buf readhexstring pop } bind\n" + op + b"\n")
    digits = px.tobytes().hex().encode()
    step = 2 * _BYTES_PER_LINE
    body = b"\n".join(digits[i:i + step] for i in range(0, len(digits), step))
    return head + body + b"\n%%%%EndBinary\ngrestore end\n"


def read_eps_hex(data: bytes) -> np.ndarray:
    """An EPS file as encode_eps writes it -> its (H, W) or (H, W, 3)
    pixels, from the hex body."""
    lines = data.split(b"\n")
    w, h, _, bands = (int(v) for v in lines[6].split()[1:5])
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith(b"{ currentfile")) + 2
    stop = lines.index(b"%%%%EndBinary")
    raw = bytes.fromhex(b"".join(lines[start:stop]).decode())
    px = np.frombuffer(raw, np.uint8)
    return px.reshape(h, w) if bands == 1 else px.reshape(h, w, bands)
