"""TIFF files that Pillow cannot save, for the port's TIFF tests (numpy
and the standard library, plus libtiff through ctypes where a codec has
an encoder there).

- `write_libtiff`: any layout libtiff writes, through the libtiff that
  Pillow bundles (its own copy, which Pillow reads with): CCITT fax
  (compression 2, 3, 4 and 32771 under T4Options, T6Options and the fax
  mode), LZMA, ZSTD and Deflate with predictors, SGILog.
"""
from __future__ import annotations

import ctypes
import glob
import os
import struct
import tempfile

import numpy as np

# libtiff's pseudo-tags (tiff.h)
FAXMODE, ZSTD_LEVEL, LZMAPRESET = 65536, 65564, 65562
SGILOGDATAFMT, SGILOGENCODE = 65560, 65561
_LIBTIFF = None


def libtiff():
    """Pillow's own libtiff (pillow.libs), loaded once."""
    global _LIBTIFF
    if _LIBTIFF is None:
        import PIL
        from PIL import Image  # noqa: F401 - loads the libraries it needs
        libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                            "pillow.libs")
        lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libtiff*.so*"))[0])
        lib.TIFFOpen.restype = ctypes.c_void_p
        lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.TIFFClose.argtypes = [ctypes.c_void_p]
        lib.TIFFWriteEncodedStrip.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
            ctypes.c_ssize_t]
        lib.TIFFWriteEncodedStrip.restype = ctypes.c_ssize_t
        lib.TIFFWriteEncodedTile.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                             ctypes.c_void_p, ctypes.c_ssize_t]
        lib.TIFFWriteEncodedTile.restype = ctypes.c_ssize_t
        lib.TIFFSetErrorHandler.argtypes = [ctypes.c_void_p]
        lib.TIFFSetWarningHandler.argtypes = [ctypes.c_void_p]
        lib.TIFFSetWarningHandler(None)
        _LIBTIFF = lib
    return _LIBTIFF


def write_libtiff(samples, compression, photometric, tags=None,
                  rows_per_strip=None, tile=None, order="II",
                  planar=1) -> bytes:
    """(H, W[, S]) samples (uint8 / uint16 / float32; bilevel as 0/1
    uint8 with bits=1 in `tags`) -> the file libtiff writes with
    `compression`; `tags` maps a tag (or a pseudo-tag) to an int, a float
    or a sequence of uint16."""
    lib = libtiff()
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    H, W, S = s.shape
    tags = dict(tags or {})
    bits = tags.pop(258, s.dtype.itemsize * 8)
    fd, path = tempfile.mkstemp(suffix=".tif")
    os.close(fd)
    try:
        tif = lib.TIFFOpen(path.encode(), b"wl" if order == "II" else b"wb")
        assert tif, "TIFFOpen failed"

        def put(tag, *vals):
            args = []
            for v in vals:
                if isinstance(v, float):
                    args.append(ctypes.c_double(v))
                elif isinstance(v, (bytes, bytearray)):
                    args.append(ctypes.c_char_p(bytes(v)))
                elif isinstance(v, np.ndarray):
                    args.append(v.ctypes.data_as(ctypes.c_void_p))
                else:
                    args.append(ctypes.c_int(int(v)))
            assert lib.TIFFSetField(ctypes.c_void_p(tif), ctypes.c_uint32(tag),
                                    *args) == 1, f"TIFFSetField {tag}"

        keep = []
        put(256, W)
        put(257, H)
        put(258, bits)
        put(277, S)
        put(259, compression)
        put(262, photometric)
        put(284, planar)
        if s.dtype == np.float32:
            put(339, 3)
        if tile:
            put(322, tile[0])
            put(323, tile[1])
        else:
            put(278, rows_per_strip or H)
        for tag, v in tags.items():
            if isinstance(v, (tuple, list)):
                arr = np.asarray(v, np.uint16)
                keep.append(arr)
                put(tag, len(arr), arr)
            else:
                put(tag, v)

        def pack(a):
            if bits == 1:
                return np.packbits(a.reshape(a.shape[0], -1).astype(np.uint8),
                                   axis=1).tobytes()
            if bits < 8:
                v = a.reshape(a.shape[0], -1).astype(np.uint8)
                b = (v[..., None] >> np.arange(bits - 1, -1, -1)) & 1
                flat = b.reshape(a.shape[0], -1)
                flat = np.pad(flat, ((0, 0), (0, (-flat.shape[1]) % 8)))
                return np.packbits(flat.astype(np.uint8), axis=1).tobytes()
            return np.ascontiguousarray(a).tobytes()

        planes = [s] if planar == 1 else [s[..., k:k + 1] for k in range(S)]
        k = 0
        for p in planes:
            if tile:
                tw, th = tile
                for y in range(0, H, th):
                    for x in range(0, W, tw):
                        t = np.zeros((th, tw, p.shape[2]), s.dtype)
                        part = p[y:y + th, x:x + tw]
                        t[:part.shape[0], :part.shape[1]] = part
                        buf = pack(t)
                        assert lib.TIFFWriteEncodedTile(
                            ctypes.c_void_p(tif), k, buf, len(buf)) >= 0
                        k += 1
            else:
                rps = rows_per_strip or H
                for y in range(0, H, rps):
                    buf = pack(p[y:y + rps])
                    assert lib.TIFFWriteEncodedStrip(
                        ctypes.c_void_p(tif), k, buf, len(buf)) >= 0
                    k += 1
        lib.TIFFClose(ctypes.c_void_p(tif))
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.unlink(path)


# ------------------------------------------- old-style JPEG, tag tables ----
def _segments(stream: bytes):
    """A JPEG stream -> [(marker, payload)] up to SOS, and the entropy-coded
    data after it (without EOI)."""
    out, pos = [], 2
    while True:
        m = stream[pos + 1]
        n = struct.unpack_from(">H", stream, pos + 2)[0]
        out.append((m, stream[pos + 4:pos + 2 + n]))
        pos += 2 + n
        if m == 0xDA:
            end = stream.rfind(b"\xff\xd9")
            return out, stream[pos:end]


def ojpeg_tags_tiff(img, sampling=(2, 2), quality=75, photometric=6,
                    proc=1, rows=None, restart=None, tables=None,
                    extra=None) -> bytes:
    """A compression 6 TIFF whose strips hold only entropy-coded data, the
    tables in JPEGProc (512), JPEGQTables (519), JPEGDCTables (520) and
    JPEGACTables (521), as old-style JPEG writers laid them out: component
    m uses quantisation table m and Huffman tables m.  rows: strips of
    that many rows, each coded on its own (JPEGRestartInterval (515), the
    MCUs of a strip, unless `restart` says otherwise); tables(q, dc, ac)
    may rewrite the per-component tables; extra: more tags."""
    from liverrenderer_tpu_torch.io import jpeg
    img = np.asarray(img, np.uint8)
    H, W = img.shape[:2]
    grey = img.ndim == 2
    n = 1 if grey else 3
    samp = ((1, 1),) if grey else (tuple(sampling), (1, 1), (1, 1))
    rows = rows or H
    strips, q, dc, ac = [], {}, {}, {}
    for y in range(0, H, rows):
        segs, data = _segments(jpeg.encode_jpeg(img[y:y + rows], quality,
                                                samp))
        strips.append(data)
    for m, p in segs:
        if m == 0xDB:
            k = 0
            while k < len(p):
                q[p[k] & 15] = p[k + 1:k + 65]
                k += 65
        elif m == 0xC4:
            k = 0
            while k < len(p):
                cnt = sum(p[k + 1:k + 17])
                (ac if p[k] >> 4 else dc)[p[k] & 15] = p[k + 1:k + 17 + cnt]
                k += 17 + cnt
        elif m == 0xC0:
            tq = [p[6 + 3 * c + 2] for c in range(p[5])]
        elif m == 0xDA:
            sel = [p[1 + 2 * c + 1] for c in range(p[0])]
    qt = [q[tq[c]] for c in range(n)]
    dct = [dc[sel[c] >> 4] for c in range(n)]
    act = [ac[sel[c] & 15] for c in range(n)]
    if tables is not None:
        qt, dct, act = tables(qt, dct, act)
    hs, vs = samp[0]
    mcus = -(-W // (8 * hs)) * (rows // (8 * vs))
    tags = {256: ("I", [W]), 257: ("I", [H]), 258: ("H", [8] * n),
            259: ("H", [6]), 262: ("H", [photometric]), 277: ("H", [n]),
            278: ("I", [rows]), 284: ("H", [1]), 512: ("H", [proc])}
    if not grey:
        tags[530] = ("H", list(sampling))
    if len(strips) > 1 or restart:
        tags[515] = ("H", [restart if restart is not None else mcus])
    body = bytearray(b"II*\x00\x00\x00\x00\x00")
    at = {}
    for name, blobs in (("strips", strips), ("q", qt), ("dc", dct),
                        ("ac", act)):
        at[name] = []
        for b in blobs:
            at[name].append(len(body))
            body += b + b"\x00" * (len(b) & 1)
    tags[273] = ("I", at["strips"])
    tags[279] = ("I", [len(c) for c in strips])
    tags[519], tags[520], tags[521] = (("I", at[k]) for k in ("q", "dc",
                                                              "ac"))
    tags.update(extra or {})
    return ifd_file(body, tags)


def ifd_file(body: bytearray, tags) -> bytes:
    """`body` (its first 8 bytes the little-endian header) + an IFD of
    `tags` ({tag: (struct code, values)}) at its end."""
    types = {"B": 1, "H": 3, "I": 4}
    ifd_at = len(body)
    struct.pack_into("<I", body, 4, ifd_at)
    extra_at = ifd_at + 2 + 12 * len(tags) + 4
    entries, blobs = b"", b""
    for tag in sorted(tags):
        code, vals = tags[tag]
        payload = struct.pack("<" + code * len(vals), *vals)
        if len(payload) <= 4:
            field = payload.ljust(4, b"\x00")
        else:
            field = struct.pack("<I", extra_at + len(blobs))
            blobs += payload + b"\x00" * (len(payload) & 1)
        entries += struct.pack("<HHI", tag, types[code], len(vals)) + field
    return bytes(body) + struct.pack("<H", len(tags)) + entries \
        + b"\x00" * 4 + blobs


# ------------------------------------------------------------ LZW, old ----
def lzw_encode(data: bytes, compat: bool = True) -> bytes:
    """TIFF LZW of `data`: libtiff's old style (codes LSB-first, the width
    growing when the decoder's next free code reaches 2^bits) or the new
    one (MSB-first, one code earlier); Clear first, EOI last, a Clear
    again before the decoder's table would pass 4,093 entries."""
    grow = 1 if compat else 2
    out = bytearray()
    acc = nacc = 0

    def put(code, bits):
        nonlocal acc, nacc
        if compat:
            acc |= code << nacc
            nacc += bits
            while nacc >= 8:
                out.append(acc & 255)
                acc >>= 8
                nacc -= 8
        else:
            acc = (acc << bits) | code
            nacc += bits
            while nacc >= 8:
                out.append((acc >> (nacc - 8)) & 255)
                nacc -= 8
                acc &= (1 << nacc) - 1

    def clear():
        return {bytes([i]): i for i in range(256)}, 258, 9, 258, True

    table, free, bits, dec_free, first = clear()
    put(256, 9)
    w = b""
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        put(table[w], bits)
        if first:
            first = False
        else:
            dec_free += 1
            if dec_free > (1 << bits) - grow:
                bits = min(bits + 1, 12)
        table[wc] = free
        free += 1
        w = bytes([b])
        if dec_free >= 4093:
            put(256, bits)
            table, free, bits, dec_free, first = clear()
    if w:
        put(table[w], bits)
        if not first:
            dec_free += 1
            if dec_free > (1 << bits) - grow:
                bits = min(bits + 1, 12)
    put(257, bits)
    if nacc:
        out.append((acc << (8 - nacc)) & 255 if not compat else acc & 255)
    return bytes(out)


def tiff_chunks(samples_shape, bits, photometric, compression, chunks,
                rows=None, tile=None, extra=None, offset_pad=0) -> bytes:
    """A little-endian TIFF of (H, W, S) samples of `bits` bits whose strips
    (or `tile` (w, h) tiles) are the given coded `chunks`; offset_pad
    shifts the data by that many bytes (an odd file offset)."""
    H, W, S = samples_shape
    body = bytearray(b"II*\x00\x00\x00\x00\x00" + bytes(offset_pad))
    offs = []
    for c in chunks:
        offs.append(len(body))
        body += c
    tags = {256: ("I", [W]), 257: ("I", [H]), 258: ("H", [bits] * S),
            259: ("H", [compression]), 262: ("H", [photometric]),
            277: ("H", [S]), 284: ("H", [1])}
    if tile:
        tags[322], tags[323] = ("I", [tile[0]]), ("I", [tile[1]])
        tags[324], tags[325] = ("I", offs), ("I", [len(c) for c in chunks])
    else:
        tags[278] = ("I", [rows or H])
        tags[273], tags[279] = ("I", offs), ("I", [len(c) for c in chunks])
    tags.update(extra or {})
    return ifd_file(body, tags)


# ------------------------------------------------------------ ThunderScan --
def thunderscan_rows(pixels, rng) -> bytes:
    """(H, W) 4-bit pixels -> ThunderScan codes, each row coded on its own
    with a random mix of runs, 2-bit and 3-bit deltas and raw pixels."""
    out = bytearray()
    for row in np.asarray(pixels, np.int64):
        last, i, W = 0, 0, len(row)
        while i < W:
            run = 0
            while i + run < W and row[i + run] == last and run < 63:
                run += 1
            if run >= 2 and rng.random() < 0.8:
                out.append(run)
                i += run
                continue
            d = int(row[i]) - last
            mode = rng.integers(0, 3)
            if mode == 0 and d in (0, 1, -1):
                codes = [{0: 0, 1: 1, -1: 3}[d], 2, 2]
                out.append(0x40 | codes[0] << 4 | codes[1] << 2 | codes[2])
            elif mode == 1 and -3 <= d <= 3:
                code = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}[d]
                out.append(0x80 | code << 3 | 4)
            else:
                out.append(0xC0 | int(row[i]))
            last = int(row[i])
            i += 1
    return bytes(out)


# --------------------------------------------------------- stub formats ----
def _fits(cards, pad_to=2880, more=b""):
    head = b"".join(c.ljust(80).encode() for c in cards)
    return head.ljust(pad_to * (-(-len(head) // pad_to))) + more


def stub_headers() -> dict:
    """name -> the first bytes of a file of each format whose Pillow plugin
    the port only checks (the stubs, MPEG, EPS, WMF/EMF, IPTC and the
    plugins it does not decode yet), some accepted and some given up."""
    iptc = (b"\x1c\x03\x3c\x00\x02\x01\x00" + b"\x1c\x03\x14\x00\x02\x00\x04"
            + b"\x1c\x03\x1e\x00\x02\x00\x04")
    placeable = b"\xd7\xcd\xc6\x9a\x00\x00" + struct.pack("<4hH", 0, 0, 100,
                                                         100, 1440)
    return {
        "bufr": b"BUFR" + bytes(20), "bufr_zczc": b"ZCZC" + bytes(4),
        "grib": b"GRIB\0\0\0\x01" + bytes(8),
        "grib_edition2": b"GRIB\0\0\0\x02" + bytes(8),
        "hdf5": b"\x89HDF\r\n\x1a\n" + bytes(8),
        "mpeg": b"\x00\x00\x01\xb3\x14\x00\xf0\x00",
        "mpeg_empty": b"\x00\x00\x01\xb3\x00\x00\x00",
        "mpeg_short": b"\x00\x00\x01\xb3\x14",
        "eps": b"%!PS-Adobe-3.0 EPSF-3.0\n%%BoundingBox: 0 0 10 10\n"
               b"%%EndComments\nshowpage\n",
        "eps_no_bounding_box": b"%!PS-Adobe-3.0\n%%EndComments\n",
        "eps_bounding_box_at_end": b"%!PS-Adobe-3.0\n%%BoundingBox: (atend)\n"
                                   b"%%EndComments\n%%Trailer\n"
                                   b"%%BoundingBox: 0 0 5 7\n%%EOF\n",
        "eps_image_data": b"%!PS-Adobe-3.0\n%%BoundingBox: 0 0 5 7\n"
                          b"%%EndComments\n%ImageData: 3 4 8 3 0 1 1 \"x\"\n",
        "eps_image_data_bad_mode": b"%!PS-Adobe-3.0\n%%BoundingBox: 0 0 5 7\n"
                                   b"%%EndComments\n%ImageData: 3 4 8 9 0 1 "
                                   b"1 \"x\"\n",
        "eps_bad_header": b"%!PS-Adobe-3.0\nfoo\n",
        "eps_dos": struct.pack("<III", 0xC6D3D0C5, 12, 60)
                   + b"%!PS-Adobe-3.0\n%%BoundingBox: 0 0 4 4\n"
                   b"%%EndComments\n",
        "wmf_inch_0": b"\xd7\xcd\xc6\x9a\x00\x00" + bytes(40),
        "wmf_standard": placeable + bytes(6) + b"\x01\x00\t\x00" + bytes(20),
        "wmf_not_standard": placeable + bytes(30),
        "emf": b"\x01\x00\x00\x00" + bytes(4)
               + struct.pack("<8i", 0, 0, 100, 50, 0, 0, 2000, 1000) + b" EMF",
        "emf_empty_frame": b"\x01\x00\x00\x00" + bytes(4)
                           + struct.pack("<8i", 0, 0, 100, 50, 0, 0, 0, 1000)
                           + b" EMF",
        "iptc_no_3_60": b"\x1c\x02\x00\x00\x02ab" + bytes(5),
        "iptc_image": iptc + b"\x1c\x03\x78\x00\x01\x01"
                      + b"\x1c\x08\x0a\x00\x10" + bytes(16),
        "iptc_no_image_data": iptc + b"\x1c\x03\x78\x00\x01\x01",
        "iptc_bad_compression": iptc + b"\x1c\x03\x78\x00\x01\x07",
        "iptc_no_compression": iptc,
        "iptc_long_field": b"\x1c\x02\x00\x90" + bytes(10),
        "fits": _fits(["SIMPLE  = T", "BITPIX  = 8", "NAXIS   = 2",
                       "NAXIS1  = 4", "NAXIS2  = 3", "END"], more=bytes(12)),
        "fits_truncated": b"SIMPLE  = T".ljust(80),
        "fits_no_data": _fits(["SIMPLE  = T", "BITPIX  = 8", "NAXIS   = 0",
                               "END"], more=b"X" * 80),
        "fits_false": b"SIMPLE  = F".ljust(80),
        "fli": b"\x00" * 4 + struct.pack("<HHHH", 0xAF12, 1, 4, 3) + bytes(4)
               + bytes(6) + bytes(108) + struct.pack("<I", 16) + bytes(12),
        "fli_no_frames": b"\x00" * 4 + struct.pack("<HHHH", 0xAF12, 0, 4, 3)
                         + bytes(120),
        "gbr": struct.pack(">5I", 28, 2, 3, 3, 1) + b"GIMP" + bytes(13),
        "gbr_depth_2": struct.pack(">5I", 20, 1, 3, 3, 2) + bytes(9),
        "icns": b"icns" + struct.pack(">I", 8 + 8 + 16) + b"is32"
                + struct.pack(">I", 24) + bytes(16),
        "icns_unknown": b"icns" + struct.pack(">I", 32) + b"abcd"
                        + struct.pack(">I", 24) + bytes(16),
        "icns_bad_block": b"icns" + struct.pack(">I", 100) + b"is32"
                          + struct.pack(">I", 0),
        "imt": b"width 4\nheight 3\npixel n8\n\x0c" + bytes(12),
        "imt_no_mode": b"width 4\nheight 3\n\x0c" + bytes(12),
        "imt_bad_width": b"width x\nheight 3\npixel n8\n\x0c",
        "j2k": b"\xff\x4f\xff\x51" + struct.pack(
            ">HHIIIIIIIIH", 41, 0, 8, 8, 0, 0, 8, 8, 0, 0, 3)
               + bytes(9) + b"\xff\x90",
        "j2k_five_components": b"\xff\x4f\xff\x51" + struct.pack(
            ">HHIIIIIIIIH", 41, 0, 8, 8, 0, 0, 8, 8, 0, 0, 5) + bytes(9),
        "jp2_no_header": b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
                         + struct.pack(">I4s", 12, b"ftyp") + b"jp2 ",
        "jp2": b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
               + struct.pack(">I4s4s", 12, b"ftyp", b"jp2 ")
               + struct.pack(">I4s", 8 + 22, b"jp2h")
               + struct.pack(">I4sIIHBBBB", 22, b"ihdr", 4, 5, 3, 7, 7, 0, 0),
        "mcidas": b"\x00" * 7 + b"\x04" + struct.pack(
            ">62i", *([0] * 8 + [3, 4, 1] + [0] * 51)),
        "mcidas_bad_format": b"\x00" * 7 + b"\x04" + struct.pack(
            ">62i", *([0] * 8 + [3, 4, 3] + [0] * 51)),
        "pcd": bytes(2048) + b"PCD_" + bytes(1535),
        "pcd_short": bytes(2048) + b"PCD_" + bytes(100),
        "pixar": b"\200\350\000\000" + bytes(412)
                 + struct.pack("<HHxxxxHH", 3, 4, 14, 2) + bytes(84),
        "pixar_other_mode": b"\200\350\000\000" + bytes(412)
                            + struct.pack("<HHxxxxHH", 3, 4, 14, 1)
                            + bytes(84),
        "spider": struct.pack(">27f", *([1, 4, 1, 0, 1] + [0] * 6 + [4, 1]
                                        + [0] * 8 + [16, 16] + [0] * 4)),
        "spider_stack_image": struct.pack(
            ">27f", *([1, 4, 1, 0, 1] + [0] * 6 + [4, 1] + [0] * 8
                      + [16, 16, 0, 0, 0, 3])),
        "xv": b"P7 332\n#comment\n4 3 255\n" + bytes(12),
        "xv_bad_size": b"P7 332\n#c\nfoo\n", "xv_eof": b"P7 332\n#c\n",
    }


# ------------------------------------------------- readers for the tests ----
def first_strip(path) -> bytes:
    """The first strip of the first IFD of a little-endian classic TIFF."""
    with open(path, "rb") as fh:
        d = fh.read()
    ifd = struct.unpack_from("<I", d, 4)[0]
    tags = {}
    for i in range(struct.unpack_from("<H", d, ifd)[0]):
        tag, _, cnt, val = struct.unpack_from("<HHII", d, ifd + 2 + 12 * i)
        tags[tag] = struct.unpack_from("<I", d, val)[0] if cnt > 1 else val
    return d[tags[273]:tags[273] + tags[279]]


def stage(data: bytes, pil: bool):
    """(stage, result): Pillow's Image.open and convert("RGB"), or the
    port's identify and load; a failure as ("open" or "load", the class's
    name, Pillow's UnidentifiedImageError for the port's "cannot
    identify" OSError)."""
    import io as _io

    from PIL import Image

    from liverrenderer_tpu_torch.io import image as timage

    def name(e):
        if type(e).__name__ == "OSError" and "cannot identify" in str(e):
            return "UnidentifiedImageError"
        return type(e).__name__

    try:
        im = Image.open(_io.BytesIO(data)) if pil else timage.identify(data)
    except Exception as e:               # noqa: BLE001 - compared by callers
        return "open", name(e)
    try:
        return "ok", np.asarray(im.convert("RGB")) if pil else im()
    except Exception as e:               # noqa: BLE001 - compared by callers
        return "load", name(e)


# ------------------------------------------------------ committed files ----
def floor_bits():
    """floor_texture(256) as a bilevel image: 1 where its grey is dark."""
    from torch_xml_files import floor_texture
    f = floor_texture(256).astype(np.int64)
    grey = (f[..., 0] * 299 + f[..., 1] * 587 + f[..., 2] * 114) // 1000
    return (grey < 128).astype(np.uint8)


def committed(name: str) -> bytes:
    """The bytes of tests/data/<name> as written here, by the libtiff that
    Pillow bundles (libzstd's and liblzma's output may differ between
    versions of those, so the tests hold the files' pixels, not these
    bytes):

    - torch_height_zstd.tif: liver_proxy's 1,024^2 height map (BUMP, seed
      0) as 8-bit codes, ZSTD with predictor 2 in 64-row strips;
    - torch_height32_zstd.tif: the 32^2 map, the same way;
    - torch_height_lzma.tif: the 1,024^2 map, LZMA with predictor 2;
    - torch_floor_g4.tif: floor_bits() as a min-is-white Group 4 TIFF;
      torch_floor_g4.png its pixels as Pillow decodes them."""
    import io as _io

    from PIL import Image

    from liverrenderer_tpu_torch.io.png import write_png
    from liverrenderer_tpu_torch.scene.liver_proxy import BUMP, height_map
    if name.startswith("torch_height"):
        res = 32 if "32" in name else BUMP[0]
        codes = np.round(height_map(res, 0) * 255.0).astype(np.uint8)
        comp = 34925 if "lzma" in name else 50000
        return write_libtiff(codes, comp, 1, {317: 2},
                             rows_per_strip=min(64, res))
    data = write_libtiff(floor_bits(), 4, 0, {258: 1})
    if name.endswith(".png"):
        px = np.asarray(Image.open(_io.BytesIO(data)).convert("RGB"))
        fd, path = tempfile.mkstemp(suffix=".png")
        os.close(fd)
        try:
            write_png(path, px)
            with open(path, "rb") as fh:
                return fh.read()
        finally:
            os.unlink(path)
    return data
