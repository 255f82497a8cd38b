"""One-page PDF files as Pillow 12.1's PdfImagePlugin._save writes an L,
RGB or RGBA image through its PdfParser: the header and comment, the
catalog (object 4) and page tree (5), the image XObject (1), the page (2)
and its content stream (3), the document information (6: the title from
the file name, the creation and modification dates in UTC from the clock
at the call), the cross-reference table and the trailer.  L and RGB are
embedded as DCTDecode (io/jpeg.encode_jpeg, Pillow's JPEG writer), RGBA
as JPXDecode (io/jpeg2000.encode_jpeg2000 given the .pdf name, so a JP2
file) with /SMaskInData.  `embedded_stream` reads the image stream back.
"""
from __future__ import annotations

import os
import re
import time

import numpy as np

from .jpeg import encode_jpeg
from .jpeg2000 import encode_jpeg2000


def _name(n: str) -> bytes:
    return b"/" + n.encode()


def _value(v) -> bytes:
    """PdfParser.pdf_repr of the values this writer uses."""
    if isinstance(v, bytes):
        return v                                 # a name, ref or dict
    if isinstance(v, list):
        return b"[ " + b" ".join(_value(x) for x in v) + b" ]"
    if isinstance(v, time.struct_time):
        return b"(D:" + time.strftime("%Y%m%d%H%M%SZ", v).encode() + b")"
    if isinstance(v, str):
        text = b"\xfe\xff" + v.encode("utf_16_be")
        for a, b in ((b"\\", b"\\\\"), (b"(", b"\\("), (b")", b"\\)")):
            text = text.replace(a, b)
        return b"(" + text + b")"
    return str(v).encode()


def _dict(items) -> bytes:
    out = b"<<"
    for k, v in items:
        if v is not None:
            out += b"\n" + _name(k) + b" " + _value(v)
    return out + b"\n>>"


def _ref(n: int) -> bytes:
    return b"%d 0 R" % n


def encode_pdf(px: np.ndarray, path: str = "") -> bytes:
    """(H, W), (H, W, 3) or (H, W, 4) uint8 -> the bytes Pillow saves as
    PDF to `path`, dated time.gmtime() at the call."""
    px = np.asarray(px, np.uint8)
    h, w = px.shape[:2]
    now = time.gmtime()
    if px.ndim == 2:
        filt, procset = "DCTDecode", "ImageB"
        extra = [("BitsPerComponent", 8), ("ColorSpace", _name("DeviceGray"))]
        stream = encode_jpeg(px)
    elif px.shape[2] == 3:
        filt, procset = "DCTDecode", "ImageC"
        extra = [("BitsPerComponent", 8), ("ColorSpace", _name("DeviceRGB"))]
        stream = encode_jpeg(px)
    else:
        filt, procset = "JPXDecode", "ImageC"
        extra = [("SMaskInData", 1)]
        stream = encode_jpeg2000(px, path)
    offsets = {}
    out = bytearray(b"%PDF-1.4\n% created by Pillow PDF driver\n")

    def obj(n, items, data=None):
        offsets[n] = len(out)
        if data is not None:
            items = items + [("Length", len(data))]
        out.extend(b"%d 0 obj" % n + _dict(items))
        if data is not None:
            out.extend(b"stream\n" + data + b"\nendstream\n")
        out.extend(b"endobj\n")

    obj(4, [("Type", _name("Catalog")), ("Pages", _ref(5))])
    obj(5, [("Type", _name("Pages")), ("Count", 1), ("Kids", [_ref(2)])])
    obj(1, [("Type", _name("XObject")), ("Subtype", _name("Image")),
            ("Width", w), ("Height", h), ("Filter", _name(filt))] + extra,
        stream)
    resources = _dict([("ProcSet", [_name("PDF"), _name(procset)]),
                       ("XObject", _dict([("image", _ref(1))]))])
    sw, sh = w * 72.0 / 72.0, h * 72.0 / 72.0
    obj(2, [("Resources", resources), ("MediaBox", [0, 0, sw, sh]),
            ("Contents", _ref(3)), ("Type", _name("Page")),
            ("Parent", _ref(5))])
    obj(3, [], b"q %f 0 0 %f 0 0 cm /image Do Q\n" % (sw, sh))
    title = os.path.splitext(os.path.basename(path))[0]
    obj(6, [("Title", title or None), ("CreationDate", now),
            ("ModDate", now)])
    start = len(out)
    out.extend(b"xref\n0 7\n0000000000 65536 f \n")
    for n in range(1, 7):
        out.extend(b"%010d %05d n \n" % (offsets[n], 0))
    out.extend(b"trailer\n" + _dict([("Root", _ref(4)), ("Size", 7),
                                     ("Info", _ref(6))])
               + b"\nstartxref\n%d\n%%%%EOF" % start)
    return bytes(out)


def embedded_stream(data: bytes) -> tuple:
    """A PDF file as encode_pdf writes it -> (its image's filter name, the
    stream's bytes)."""
    m = re.search(rb"/Filter /(\w+)\n.*?/Length (\d+)\n>>stream\n", data,
                  re.S)
    start = m.end()
    return m.group(1).decode(), data[start:start + int(m.group(2))]
