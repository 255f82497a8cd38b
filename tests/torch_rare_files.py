"""Writers of the files of the rarer Pillow plugins, from each format's
layout as Pillow's plugin reads it (numpy, struct and gzip only; no PIL,
no JAX): FITS (raw and a GZIP_1 BINTABLE), SPIDER, McIdas, PIXAR, XV
thumbnails, IMT, GIMP brushes, IPTC/NAA records, Kodak PhotoCD, FLI / FLC
(every chunk kind, with encoders of BRUN, LC and SS2), ICNS (PNG, RLE and
mask entries), the PPM extensions (Pf, P0CMYK, PyP, PyRGBA, PyCMYK) and IM
of any image type.  Pillow has a writer for few of these; the tests read
each file with the JAX package (Pillow) and with the port.
"""
from __future__ import annotations

import gzip
import struct

import numpy as np


# ---------------------------------------------------------------- FITS ----
def fits_cards(cards, pad_to=2880) -> bytes:
    """80-column header cards ("KEY = value" strings), padded."""
    head = b"".join(c.ljust(80).encode() for c in cards)
    return head.ljust(pad_to * -(-len(head) // pad_to), b" ")


def _card(key, value) -> str:
    return f"{key:<8}= {value:>20}"


def fits(data: bytes, bitpix: int, w: int, h: int, naxis: int = 2,
         pad: bool = True) -> bytes:
    """A primary HDU holding `data` as its data unit."""
    cards = [_card("SIMPLE", "T"), _card("BITPIX", bitpix),
             _card("NAXIS", naxis), _card("NAXIS1", w)]
    if naxis > 1:
        cards.append(_card("NAXIS2", h))
    cards.append("END")
    body = fits_cards(cards) + data
    return body.ljust(2880 * -(-len(body) // 2880), b"\0") if pad else body


def fits_gzip(words: np.ndarray, zbitpix: int, level: int = 9) -> bytes:
    """A primary HDU without data, then a GZIP_1 BINTABLE extension whose
    heap Pillow decompresses as one stream: `words` (h, w) as 4-byte
    big-endian words, first row first (Pillow shows it at the bottom)."""
    h, w = words.shape
    primary = fits_cards([_card("SIMPLE", "T"), _card("BITPIX", 8),
                          _card("NAXIS", 0), _card("EXTEND", "T"), "END"])
    ext = fits_cards([
        _card("XTENSION", "'BINTABLE'"), _card("BITPIX", 8),
        _card("NAXIS", 2), _card("NAXIS1", 8), _card("NAXIS2", 1),
        _card("PCOUNT", 0), _card("GCOUNT", 1), _card("TFIELDS", 1),
        _card("TFORM1", "'1PB     '"), _card("ZIMAGE", "T"),
        _card("ZBITPIX", zbitpix), _card("ZNAXIS", 2),
        _card("ZNAXIS1", w), _card("ZNAXIS2", h),
        _card("ZCMPTYPE", "'GZIP_1  '"), "END"])
    stream = gzip.compress(np.ascontiguousarray(words, ">i4").tobytes(),
                           level, mtime=0)
    heap = struct.pack(">ii", len(stream), 0) + stream
    body = primary + ext + heap
    return body.ljust(2880 * -(-len(body) // 2880), b"\0")


# ------------------------------------------- SPIDER, McIdas, PIXAR, XV ----
def spider(img: np.ndarray, big: bool = True, stack: bool = False) -> bytes:
    """A SPIDER 2-D image of float32 (h, w) (makeSpiderHeader's labels);
    `stack`: an overall stack header, then the one image's header."""
    h, w = img.shape
    lenbyt = w * 4
    labrec = 1024 // lenbyt + (1024 % lenbyt != 0)
    labbyt = labrec * lenbyt
    hdr = [0.0] * (labbyt // 4 + 1)
    hdr[1], hdr[2], hdr[5], hdr[12] = 1.0, float(h), 1.0, float(w)
    hdr[13], hdr[22], hdr[23] = float(labrec), float(labbyt), float(lenbyt)
    end = ">" if big else "<"
    data = np.ascontiguousarray(img, end + "f4").tobytes()
    if not stack:
        return struct.pack(f"{end}{len(hdr) - 1}f", *hdr[1:]) + data
    top = list(hdr)
    top[24], top[26] = 2.0, 1.0                       # istack, maxim
    image = list(hdr)
    image[27] = 1.0                                   # imgnum
    return struct.pack(f"{end}{len(top) - 1}f", *top[1:]) \
        + struct.pack(f"{end}{len(image) - 1}f", *image[1:]) + data


def mcidas(img: np.ndarray, word: int, prefix: int = 0,
           data_at: int = 256) -> bytes:
    """A McIdas area file: the 64-word descriptor (lines, elements, bytes
    per element, one band, a line prefix), the rows at `data_at`."""
    h, w = img.shape
    desc = [0] * 65
    desc[2], desc[9], desc[10], desc[11] = 4, h, w, word
    desc[14], desc[15], desc[34] = 1, prefix, data_at
    head = struct.pack(">64i", *desc[1:]).ljust(data_at, b"\0")
    dt = {1: ">u1", 2: ">u2", 4: ">i4"}[word]
    rows = [b"\xa5" * prefix + np.ascontiguousarray(r, dt).tobytes()
            for r in img]
    return head + b"".join(rows)


def pixar(img: np.ndarray) -> bytes:
    """A PIXAR RGB raster: the 512-byte header (size at 416, mode at
    424), the pixels at 1,024."""
    h, w = img.shape[:2]
    head = bytearray(1024)
    head[:4] = b"\200\350\000\000"
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, 14, 2)
    return bytes(head) + np.ascontiguousarray(img, np.uint8).tobytes()


def xvthumb(idx: np.ndarray) -> bytes:
    h, w = idx.shape
    return (b"P7 332\n#XVVERSION:Version 2.28  Rev: 9/26/92\n"
            b"#IMGINFO:512x440 Color JPEG\n#END_OF_COMMENTS\n"
            + f"{w} {h} 255\n".encode()
            + np.ascontiguousarray(idx, np.uint8).tobytes())


def imt(grey: np.ndarray, comment: bool = True) -> bytes:
    h, w = grey.shape
    head = (b"* an IM Tools file\n" if comment else b"") \
        + f"width {w}\nheight {h}\npixel n8\n\x0c".encode()
    return head + np.ascontiguousarray(grey, np.uint8).tobytes()


def gbr(img: np.ndarray, version: int = 2, name: bytes = b"brush") -> bytes:
    """A GIMP brush: (h, w) grey or (h, w, 4) RGBA."""
    h, w = img.shape[:2]
    depth = 1 if img.ndim == 2 else 4
    comment = name + b"\0"
    if version == 1:
        head = struct.pack(">5I", 20 + len(comment), 1, w, h, depth)
    else:
        head = struct.pack(">5I", 28 + len(comment), 2, w, h, depth) \
            + b"GIMP" + struct.pack(">I", 25)
    return head + comment + np.ascontiguousarray(img, np.uint8).tobytes()


# ---------------------------------------------------------------- IPTC ----
def iptc_field(record: int, dataset: int, data: bytes) -> bytes:
    if len(data) < 0x8000:
        return struct.pack(">BBBH", 0x1C, record, dataset, len(data)) + data
    return struct.pack(">BBBHI", 0x1C, record, dataset, 0x8004,
                       len(data)) + data


def iptc(payload: bytes, size, layers: int = 1, component: int = 0,
         compression: int = 1, band=None, chunk: int = 0x7FFF) -> bytes:
    """An IPTC/NAA record: the object's fields (3:60 layers and component,
    3:20 / 3:30 size, 3:120 compression, 3:65 the band, one based), then
    the data in 8:10 fields of at most `chunk` bytes."""
    out = iptc_field(2, 0, b"\0\4") + iptc_field(3, 60,
                                                 bytes([layers, component]))
    out += iptc_field(3, 20, struct.pack(">H", size[0]))
    out += iptc_field(3, 30, struct.pack(">I", size[1]))
    out += iptc_field(3, 120, bytes([compression]))
    if band is not None:
        out += iptc_field(3, 65, bytes([band]))
    for i in range(0, len(payload), chunk):
        out += iptc_field(8, 10, payload[i:i + chunk])
    return out


# ----------------------------------------------------------------- PCD ----
def pcd(ycc: np.ndarray, orientation: int = 0) -> bytes:
    """A PhotoCD base image: ycc (512, 768, 3) uint8, chroma taken from
    each even row pair's left pixel of every two."""
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    y, cb, cr = ycc[..., 0], ycc[..., 1], ycc[..., 2]
    chunks = [np.concatenate([y[2 * k], y[2 * k + 1], cb[2 * k, ::2],
                              cr[2 * k, ::2]]) for k in range(256)]
    return bytes(head) + np.concatenate(chunks).astype(np.uint8).tobytes()


# --------------------------------------------------------------- FLI ----
def fli(frames, w: int, h: int, flc: bool = True, prefix: bytes = None,
        n_frames=None) -> bytes:
    """An FLI (0xAF11) or FLC (0xAF12) file: `frames` a list of chunk
    lists ((type, data) pairs); `prefix`: an FLC prefix chunk's body."""
    head = bytearray(128)
    struct.pack_into("<IHHHHHH", head, 0, 0, 0xAF12 if flc else 0xAF11,
                     len(frames) if n_frames is None else n_frames, w, h,
                     8, 3 if flc else 0)
    struct.pack_into("<I", head, 16, 70)
    body = b""
    if prefix is not None:
        body += struct.pack("<IHH", 16 + len(prefix), 0xF100, 0) \
            + bytes(8) + prefix
    for chunks in frames:
        sub = b"".join(struct.pack("<IH", 6 + len(d), t) + d
                       for t, d in chunks)
        body += struct.pack("<IHHHHHH", 16 + len(sub), 0xF1FA, len(chunks),
                            0, 0, 0, 0) + sub
    struct.pack_into("<I", head, 0, 128 + len(body))
    return bytes(head) + body


def fli_palette(pal: np.ndarray, skip: int = 0) -> bytes:
    """A colour chunk's body (types 4 and 11): one packet of len(pal)
    entries after `skip` (256 entries as a count of 0)."""
    n = len(pal)
    return struct.pack("<HBB", 1, skip, n & 255) \
        + np.asarray(pal, np.uint8).tobytes()


def fli_brun(img: np.ndarray) -> bytes:
    """BRUN: per line a packet count, then runs (count, value) and
    literals (-count, bytes)."""
    out = bytearray()
    for row in img:
        packets = bytearray()
        x, n, w = 0, 0, len(row)
        while x < w:
            run = 1
            while x + run < w and run < 127 and row[x + run] == row[x]:
                run += 1
            if run >= 3:
                packets += bytes([run, row[x]])
                x += run
            else:
                lit = min(w - x, 127)
                end = x + 1
                while end < x + lit and not (
                        end + 2 < w and row[end] == row[end + 1]
                        == row[end + 2]):
                    end += 1
                packets += bytes([256 - (end - x)]) + bytes(row[x:end])
                x = end
            n += 1
        out += bytes([n & 255]) + packets
    return bytes(out)


def fli_lc(prev: np.ndarray, img: np.ndarray) -> bytes:
    """LC (byte delta): the first changed line, the line count, then per
    line packets (skip, count) of literals, runs where 3+ bytes repeat."""
    changed = np.nonzero((prev != img).any(1))[0]
    if not len(changed):
        return struct.pack("<HH", 0, 0)
    y0, y1 = int(changed[0]), int(changed[-1]) + 1
    out = bytearray(struct.pack("<HH", y0, y1 - y0))
    for y in range(y0, y1):
        packets, n, x, w = bytearray(), 0, 0, img.shape[1]
        diff = prev[y] != img[y]
        while x < w:
            if not diff[x]:
                x += 1
                continue
            start = x
            while x < w and diff[x] and x - start < 127:
                x += 1
            seg = img[y, start:x]
            skip = start - (packets_end if n else 0)
            while skip > 255:                       # empty literal hops
                packets += bytes([255, 0])
                n += 1
                skip -= 255
            if len(seg) >= 3 and (seg == seg[0]).all():
                packets += bytes([skip, 256 - len(seg), seg[0]])
            else:
                packets += bytes([skip, len(seg)]) + seg.tobytes()
            n += 1
            packets_end = x
        out += bytes([n]) + packets
    return bytes(out)


def fli_ss2(prev: np.ndarray, img: np.ndarray, odd_last=False) -> bytes:
    """SS2 (word delta) over an even width: a skip word (0xC000 | -n)
    before unchanged lines, then per changed line its packets (skip,
    count of words) of literal words or repeated ones.  `odd_last` adds a
    0x8000 word setting each changed line's last byte."""
    h, w = img.shape
    lines = bytearray()
    n_lines, skip_lines = 0, 0
    for y in range(h):
        diff = (prev[y] != img[y]).reshape(-1, 2).any(1)
        if not diff.any():
            skip_lines += 1
            continue
        words = bytearray()
        if skip_lines:
            words += struct.pack("<H", 65536 - skip_lines)
            skip_lines = 0
        if odd_last:
            words += struct.pack("<H", 0x8000 | int(img[y, -1]))
        packets, n, x, end = bytearray(), 0, 0, 0
        while x < len(diff):
            if not diff[x]:
                x += 1
                continue
            start = x
            while x < len(diff) and diff[x] and x - start < 127:
                x += 1
            seg = img[y, 2 * start:2 * x]
            skip = 2 * start - end
            while skip > 255:
                packets += bytes([254, 0])
                n += 1
                skip -= 254
            pairs = seg.reshape(-1, 2)
            if len(pairs) >= 2 and (pairs == pairs[0]).all():
                packets += bytes([skip, 256 - len(pairs)]) \
                    + pairs[0].tobytes()
            else:
                packets += bytes([skip, len(pairs)]) + seg.tobytes()
            n += 1
            end = 2 * x
        words += struct.pack("<H", n) + packets
        lines += words
        n_lines += 1
    return struct.pack("<H", n_lines) + bytes(lines)


# ---------------------------------------------------------------- ICNS ----
def icns_rle(plane: np.ndarray) -> bytes:
    """IcnsImagePlugin's run lengths: 0..127 + n literal bytes, 128..255
    a run of (b - 125) copies of the next byte."""
    v = np.asarray(plane, np.uint8).reshape(-1)
    out, i, n = bytearray(), 0, len(v)
    while i < n:
        run = 1
        while i + run < n and run < 130 and v[i + run] == v[i]:
            run += 1
        if run >= 3:
            out += bytes([run + 125, v[i]])
            i += run
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and v[j] == v[j + 1] == v[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + v[i:j].tobytes()
        i = j
    return bytes(out)


def icns_rgb(img: np.ndarray, rle: bool = True, it32: bool = False) -> bytes:
    """A 32-bit RGB entry's body: three run-length planes (or raw)."""
    body = b"".join(icns_rle(img[..., k]) for k in range(3)) if rle \
        else np.ascontiguousarray(img[..., :3], np.uint8).tobytes()
    return (b"\0\0\0\0" if it32 else b"") + body


def icns(entries) -> bytes:
    """entries: (four-byte type, body) pairs, in file order."""
    blocks = b"".join(t + struct.pack(">I", 8 + len(b)) + b
                      for t, b in entries)
    return b"icns" + struct.pack(">I", 8 + len(blocks)) + blocks


# ------------------------------------------------------ PPM extensions ----
def ppm_ext(magic: bytes, samples: np.ndarray, maxval=255,
            scale=None) -> bytes:
    """P0CMYK / PyP / PyRGBA / PyCMYK with `maxval` (two bytes a sample
    past 255), or Pf with `scale` (its sign the byte order: negative
    little-endian), rows bottom-up as Pillow reads them."""
    h, w = samples.shape[:2]
    if magic == b"Pf":
        end = "<" if scale < 0 else ">"
        return b"Pf\n%d %d\n%s\n" % (w, h, repr(float(scale)).encode()) \
            + np.ascontiguousarray(samples[::-1], end + "f4").tobytes()
    dt = ">u2" if maxval > 255 else np.uint8
    return magic + b"\n%d %d\n%d\n" % (w, h, maxval) \
        + np.ascontiguousarray(samples, dt).tobytes()


# ------------------------------------------------------------------ IM ----
def im(kind: str, body: bytes, size, lut: bytes = None,
       extra=()) -> bytes:
    """An IM file: its text header (image type, size, Lut), padded with
    NULs to 511 bytes and ended by 0x1a, the 768-byte Lut if any, then
    the body."""
    lines = [f"Image type: {kind}", f"Image size (x*y): {size[0]}*{size[1]}",
             *extra]
    if lut is not None:
        lines.append("Lut: 1")
    head = "".join(line + "\r\n" for line in lines).encode()
    return head.ljust(511, b"\0") + b"\x1a" + (lut or b"") + body


# ------------------------------------------------------ committed files ----
def floor_indexed(n: int = 256, seed: int = 0):
    """torch_xml_files.floor_texture's checker of two seeded colours under
    a left-to-right ramp, in 256 colours: (n, n) indices (the square's
    colour times 128 plus the ramp's level, one level per n / 128 columns)
    and the (256, 3) palette."""
    y, x = np.mgrid[0:n, 0:n]
    base = np.random.default_rng(seed).uniform(0.2, 0.9, (2, 3))
    level = x * 128 // n
    idx = ((x // 8 + y // 8) % 2) * 128 + level
    ramp = 0.6 + 0.4 * np.arange(128) / 127
    pal = np.round(base[:, None, :] * ramp[None, :, None] * 255)
    return idx.astype(np.uint8), pal.reshape(256, 3).astype(np.uint8)


def committed(name: str) -> bytes:
    """The bytes of tests/data/<name> as written here:

    - torch_height_gzip.fits: liver_proxy's 1,024^2 height map (BUMP, seed
      0) as 8-bit codes in a GZIP_1 FITS table (ZBITPIX 8), rows stored
      bottom-up so that Pillow's reversal shows the codes;
    - torch_height32_gzip.fits: the 32^2 map, the same way;
    - torch_floor.flc: floor_indexed() as an FLC animation, its first
      frame a COLOR_256 chunk and BRUN, a second frame an LC delta;
      torch_floor_flc.png the first frame's pixels (palette[idx])."""
    import os
    import tempfile

    from liverrenderer_tpu_torch.io.png import write_png
    from liverrenderer_tpu_torch.scene.liver_proxy import BUMP, height_map
    if name.startswith("torch_height"):
        res = 32 if "32" in name else BUMP[0]
        codes = np.round(height_map(res, 0) * 255.0).astype(np.uint8)
        return fits_gzip(codes[::-1].astype(np.int32), 8)
    idx, pal = floor_indexed()
    if name.endswith(".png"):
        fd, path = tempfile.mkstemp(suffix=".png")
        os.close(fd)
        try:
            write_png(path, pal[idx])
            with open(path, "rb") as fh:
                return fh.read()
        finally:
            os.unlink(path)
    moved = idx.copy()
    moved[100:140, 60:200] = idx[100:140, 61:201]
    return fli([[(4, fli_palette(pal)), (15, fli_brun(idx))],
                [(12, fli_lc(idx, moved))]], 256, 256)
