"""Writers of raster files in layouts Pillow cannot save (numpy, struct and
zlib only; no PIL, no JAX): TIFF in every byte order, layout, codec,
predictor and sample kind the port reads, GIF with its own LZW encoder
(frame offsets, local tables, interlace, transparency, damaged streams),
and the small formats Pillow only reads (Sun raster, SGI RLE, DCX, MSP
version 2, XPM, CUR, ICO with BMP entries, PSD).  The tests read each
file with the JAX package (Pillow) and with the port.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


# ---------------------------------------------------------------- LZW ----
def lzw_encode_tiff(data: bytes) -> bytes:
    """TIFF LZW (MSB-first, early change), a Clear before 4,094 entries."""
    out, acc, nacc = bytearray(), 0, 0
    nbits = 9

    def put(code):
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)

    table = {bytes([i]): i for i in range(256)}
    nxt = 258
    put(256)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = nxt
        nxt += 1
        if nxt == (1 << nbits) and nbits < 12:
            nbits += 1
        if nxt >= 4094:
            put(256)
            table = {bytes([i]): i for i in range(256)}
            nxt, nbits = 258, 9
        w = bytes([c])
    if w:
        put(table[w])
        nxt += 1
        if nxt == (1 << nbits) and nbits < 12:
            nbits += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def lzw_encode_gif(idx: bytes, min_size: int, clear_every=None) -> bytes:
    """GIF LZW codes (LSB-first), not yet in sub-blocks; without a Clear
    when the table fills unless `clear_every` entries say otherwise."""
    out, acc, nacc = bytearray(), 0, 0
    clear, end = 1 << min_size, (1 << min_size) + 1
    size = min_size + 1

    def put(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    def reset():
        return {bytes([i]): i for i in range(clear)}, end + 1

    table, nxt = reset()
    put(clear)
    w = b""
    for c in idx:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w])
        if nxt >= (1 << size) and size < 12:
            size += 1
        if nxt < 4096:
            table[wc] = nxt
            nxt += 1
        if clear_every and nxt >= clear_every:
            put(clear)
            table, nxt = reset()
            size = min_size + 1
        w = bytes([c])
    if w:
        put(table[w])
        if nxt >= (1 << size) and size < 12:
            size += 1
    put(end)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def sub_blocks(data: bytes, size=255) -> bytes:
    out = bytearray()
    for i in range(0, len(data), size):
        chunk = data[i:i + size]
        out += bytes([len(chunk)]) + chunk
    return bytes(out) + b"\x00"


# --------------------------------------------------------------- TIFF ----
def packbits(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j + 1 < len(data) and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i
        while j < len(data) and j - i < 128 and not (
                j + 1 < len(data) and data[j + 1] == data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


_TYPE = {"H": 3, "I": 4, "Q": 16}


def write_tiff(samples, photometric, order="II", bigtiff=False, tile=None,
               rows_per_strip=None, planar=1, compression=1, predictor=1,
               extra=(), sample_format=None, fill_order=None, colormap=None,
               orientation=None, bits=None) -> bytes:
    """(H, W, S) samples -> TIFF bytes.  `bits` < 8 packs integer samples
    (planar 1, strips only); 16- and 32-bit samples go out in `order`."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    H, W, S = s.shape
    e = "<" if order == "II" else ">"
    bits = bits or s.dtype.itemsize * 8

    def pack_rows(a):             # (rows, cols, n) -> bytes, rows padded
        if bits < 8:
            v = a.reshape(a.shape[0], -1).astype(np.uint8)
            bitsarr = ((v[..., None] >> np.arange(bits - 1, -1, -1)) & 1)
            flat = bitsarr.reshape(a.shape[0], -1)
            pad = (-flat.shape[1]) % 8
            flat = np.pad(flat, ((0, 0), (0, pad)))
            return np.packbits(flat.astype(np.uint8), axis=1).tobytes()
        return np.ascontiguousarray(a).astype(
            a.dtype.newbyteorder(e) if a.dtype.itemsize > 1 else a.dtype
        ).tobytes()

    def predict(a):                # the encode side of the predictors
        if predictor == 2:
            d = a.astype(np.int64)
            d[:, 1:] = d[:, 1:] - d[:, :-1]
            return (d % (1 << bits)).astype(a.dtype)
        return a

    def encode(raw: bytes, rows, cols, n) -> bytes:
        if predictor == 3:
            nb = bits // 8
            b = np.frombuffer(raw, np.uint8).reshape(rows, cols * n, nb)
            if e == "<":
                b = b[..., ::-1]            # most significant byte first
            planes = b.transpose(0, 2, 1).reshape(rows, -1).astype(np.int64)
            planes = np.concatenate(
                [planes[:, :n], planes[:, n:] - planes[:, :-n]], 1) % 256
            raw = planes.astype(np.uint8).tobytes()
        if compression == 5:
            raw = lzw_encode_tiff(raw)
        elif compression in (8, 32946):
            raw = zlib.compress(raw)
        elif compression == 32773:
            raw = packbits(raw)
        if fill_order == 2:        # the bits of the stored (coded) bytes
            rev = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                           np.uint8)
            raw = rev[np.frombuffer(raw, np.uint8)].tobytes()
        return raw

    chunks = []
    planes_data = [s] if planar == 1 else [s[..., k:k + 1] for k in range(S)]
    if tile:
        tw, th = tile
        for p in planes_data:
            for y in range(0, H, th):
                for x in range(0, W, tw):
                    t = np.zeros((th, tw, p.shape[2]), s.dtype)
                    part = p[y:y + th, x:x + tw]
                    t[:part.shape[0], :part.shape[1]] = part
                    chunks.append(encode(pack_rows(predict(t)), th, tw,
                                         p.shape[2]))
    else:
        rps = rows_per_strip or H
        for p in planes_data:
            for y in range(0, H, rps):
                part = p[y:y + rps]
                chunks.append(encode(pack_rows(predict(part)), part.shape[0],
                                     W, p.shape[2]))
    tags = {256: ("I", [W]), 257: ("I", [H]), 258: ("H", [bits] * S),
            259: ("H", [compression]), 262: ("H", [photometric]),
            277: ("H", [S]), 284: ("H", [planar])}
    if not tile:
        tags[278] = ("I", [rows_per_strip or H])
    else:
        tags[322] = ("I", [tile[0]])
        tags[323] = ("I", [tile[1]])
    if predictor != 1:
        tags[317] = ("H", [predictor])
    if extra:
        tags[338] = ("H", list(extra))
    if sample_format:
        tags[339] = ("H", [sample_format] * S)
    if fill_order:
        tags[266] = ("H", [fill_order])
    if colormap is not None:
        tags[320] = ("H", list(np.asarray(colormap).T.reshape(-1)))
    if orientation:
        tags[274] = ("H", [orientation])
    off_tag, cnt_tag = (324, 325) if tile else (273, 279)
    head = 16 if bigtiff else 8
    ptr = head
    data_at = []
    for c in chunks:
        data_at.append(ptr)
        ptr += len(c) + (len(c) & 1)
    tags[off_tag] = ("Q" if bigtiff else "I", data_at)
    tags[cnt_tag] = ("Q" if bigtiff else "I", [len(c) for c in chunks])
    ifd_at = ptr
    ent, inline = (20, 8) if bigtiff else (12, 4)
    n = len(tags)
    extra_at = ifd_at + (8 if bigtiff else 2) + n * ent + (8 if bigtiff else 4)
    entries, blobs = b"", b""
    for tag in sorted(tags):
        code, vals = tags[tag]
        payload = struct.pack(e + code * len(vals), *vals)
        typ = _TYPE[code]
        if len(payload) <= inline:
            field = payload.ljust(inline, b"\x00")
        else:
            field = struct.pack(e + ("Q" if bigtiff else "I"),
                                extra_at + len(blobs))
            blobs += payload + b"\x00" * (len(payload) & 1)
        if bigtiff:
            entries += struct.pack(e + "HHQ", tag, typ, len(vals)) + field
        else:
            entries += struct.pack(e + "HHI", tag, typ, len(vals)) + field
    if bigtiff:
        header = (b"II" if e == "<" else b"MM") + struct.pack(
            e + "HHHQ", 43, 8, 0, ifd_at)
        ifd = struct.pack(e + "Q", n) + entries + struct.pack(e + "Q", 0)
    else:
        header = (b"II" if e == "<" else b"MM") + struct.pack(e + "HI", 42,
                                                              ifd_at)
        ifd = struct.pack(e + "H", n) + entries + struct.pack(e + "I", 0)
    body = b"".join(c + b"\x00" * (len(c) & 1) for c in chunks)
    return header + body + ifd + blobs


# ---------------------------------------------------------------- GIF ----
def write_gif(idx, palette=None, screen=None, offset=(0, 0), local=None,
              interlace=False, transparency=None, min_size=None,
              version=b"GIF89a", stream=None, trailer=True,
              clear_every=None, background=0) -> bytes:
    """One frame of indices `idx` (h, w) -> GIF bytes.  `palette`: the
    global table ((n, 3) uint8, n a power of two) or None; `local`: the
    frame's own table; `stream` replaces the frame's sub-blocks."""
    idx = np.asarray(idx, np.uint8)
    h, w = idx.shape
    sw, sh = screen or (w + offset[0], h + offset[1])
    flags = 0
    out = bytearray(version + struct.pack("<HH", sw, sh))
    if palette is not None:
        bits = int(np.log2(len(palette)))
        flags = 0x80 | 0x70 | (bits - 1)
    out += bytes([flags, background, 0])
    if palette is not None:
        out += np.asarray(palette, np.uint8).tobytes()
    if transparency is not None:
        out += b"!\xf9\x04" + bytes([1, 0, 0, transparency]) + b"\x00"
    lflags = 0x40 if interlace else 0
    if local is not None:
        lflags |= 0x80 | (int(np.log2(len(local))) - 1)
    out += b"," + struct.pack("<HHHH", offset[0], offset[1], w, h) \
        + bytes([lflags])
    if local is not None:
        out += np.asarray(local, np.uint8).tobytes()
    rows = idx
    if interlace:
        order = list(range(0, h, 8)) + list(range(4, h, 8)) \
            + list(range(2, h, 4)) + list(range(1, h, 2))
        rows = idx[order]
    if min_size is None:
        top = max(int(idx.max()), 1)
        min_size = max(2, int(np.ceil(np.log2(top + 1))))
    out += bytes([min_size])
    if stream is None:
        stream = sub_blocks(lzw_encode_gif(rows.tobytes(), min_size,
                                           clear_every))
    out += stream
    if trailer:
        out += b";"
    return bytes(out)


# ------------------------------------------------------- small formats ----
def write_sun(img, depth=24, rle=False, rgb_order=False, palette=None):
    """Sun raster: depth 1, 8 (with an optional RGB palette) or 24/32."""
    h, w = img.shape[:2]
    stride = ((w * depth + 15) // 16) * 2
    rows = np.zeros((h, stride), np.uint8)
    if depth == 1:
        rows[:, :(w + 7) // 8] = np.packbits(img.astype(np.uint8), axis=1)
    elif depth == 8:
        rows[:, :w] = img
    else:
        c = depth // 8
        px = img[..., :3] if rgb_order else img[..., 2::-1]
        if c == 4:
            px = np.concatenate([px, np.zeros((h, w, 1), np.uint8)], -1)
        rows[:, :w * c] = px.reshape(h, -1)
    body = rows.tobytes()
    if rle:
        enc, i = bytearray(), 0
        while i < len(body):
            j = i
            while j < len(body) and body[j] == body[i] and j - i < 256:
                j += 1
            n = j - i
            if n >= 3 or body[i] == 0x80:
                if n == 1:
                    enc += b"\x80\x00"
                else:
                    enc += bytes([0x80, n - 1, body[i]])
                i = j
            else:
                enc.append(body[i])
                i += 1
        body = bytes(enc)
    ftype = 2 if rle else (3 if rgb_order else 1)
    pal = b"" if palette is None else np.asarray(palette, np.uint8).T \
        .tobytes()
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), ftype,
                       1 if pal else 0, len(pal)) + pal + body


def write_sgi_rle(img, bpc=1):
    """An SGI file, RLE: img (h, w) or (h, w, c) uint8 / uint16."""
    a = np.asarray(img)
    if a.ndim == 2:
        a = a[..., None]
    h, w, z = a.shape
    dim = 3 if z > 1 else 2
    head = struct.pack(">hBBHHHH", 474, 1, bpc, dim, w, h, z) \
        + struct.pack(">ll", 0, 255 if bpc == 1 else 65535) + bytes(4) \
        + bytes(80) + struct.pack(">l", 0) + bytes(404)
    fmt = ">u2" if bpc == 2 else np.uint8
    starts, lengths, body = [], [], bytearray()
    tab = 512 + 8 * h * z
    for c in range(z):
        for y in range(h):
            row = a[h - 1 - y, :, c].astype(np.int64)
            enc, i = [], 0
            while i < w:
                j = i
                while j < w and row[j] == row[i] and j - i < 127:
                    j += 1
                if j - i >= 2:
                    enc += [j - i, int(row[i])]
                    i = j
                    continue
                j = i
                while j < w and j - i < 127 and not (
                        j + 1 < w and row[j + 1] == row[j]):
                    j += 1
                j = max(j, i + 1)
                enc += [0x80 | (j - i)] + [int(v) for v in row[i:j]]
                i = j
            enc.append(0)
            raw = np.array(enc, np.int64).astype(fmt).tobytes()
            starts.append(tab + len(body))
            lengths.append(len(raw))
            body += raw
    return head + struct.pack(">%dI" % len(starts), *starts) \
        + struct.pack(">%dI" % len(lengths), *lengths) + bytes(body)


def write_msp2(bits_img):
    """MSP version 2 ("LinS"): RLE rows of a 1-bit image (h, w) of 0/1."""
    h, w = bits_img.shape
    rows = np.packbits(bits_img.astype(np.uint8), axis=1)
    enc_rows = []
    for r in rows:
        enc, i = bytearray(), 0
        r = r.tobytes()
        while i < len(r):
            j = i
            while j < len(r) and r[j] == r[i] and j - i < 255:
                j += 1
            if j - i >= 3:
                enc += bytes([0, j - i, r[i]])
                i = j
            else:
                k = min(len(r), i + 3)
                enc += bytes([k - i]) + r[i:k]
                i = k
        enc_rows.append(bytes(enc))
    header = [0] * 16
    header[0], header[1] = struct.unpack("<HH", b"LinS")
    header[2], header[3] = w, h
    header[4] = header[5] = header[6] = header[7] = 1
    header[8], header[9] = w, h
    chk = 0
    for v in header:
        chk ^= v
    header[12] = chk
    return struct.pack("<16H", *header) + struct.pack(
        "<%dH" % h, *[len(r) for r in enc_rows]) + b"".join(enc_rows)


def write_xpm(idx, palette, chars=".#abcdefghijklmnopqrstuvwxyz",
              none_key=None):
    """An XPM of indices (h, w) into `palette` (n, 3), one char a pixel;
    `none_key` adds a transparent colour key."""
    h, w = idx.shape
    keys = chars[:len(palette)]
    ncol = len(palette) + (none_key is not None)
    lines = ["/* XPM */", "static char *im[] = {",
             f'"{w} {h} {ncol} 1",']
    for k, c in zip(keys, palette):
        lines.append('"%s c #%02X%02X%02X",' % (k, *c))
    if none_key is not None:
        lines.append(f'"{none_key} c None",')
    lines.append("/* pixels */")
    for r in idx:
        lines.append('"' + "".join(keys[v] for v in r) + '",')
    lines.append("};")
    return ("\n".join(lines) + "\n").encode()


def dib_entry(img, bits=24, palette=None):
    """A BMP body without the file header (a 40-byte DIB header at
    double height, XOR rows bottom-up, then an AND mask), as ICO and CUR
    entries hold it."""
    h, w = img.shape[:2]
    stride = ((w * bits + 31) >> 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    pal = b""
    if bits == 8:
        rows[:, :w] = img
        pal = np.concatenate([np.asarray(palette, np.uint8)[:, ::-1],
                              np.zeros((len(palette), 1), np.uint8)],
                             1).tobytes()
    else:
        c = bits // 8
        px = img[..., 2::-1]
        if c == 4:
            px = np.concatenate([px, np.full((h, w, 1), 255, np.uint8)], -1)
        rows[:, :w * c] = px.reshape(h, -1)
    mstride = ((w + 31) // 32) * 4
    mask = bytes(mstride * h)
    head = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, 0, 0, 0,
                       len(pal) // 4 if pal else 0, 0)
    return head + pal + rows[::-1].tobytes() + mask


def write_icon(entries, cur=False):
    """ICO / CUR from [(w, h, bpp, payload)] (payload: a PNG file or a
    dib_entry)."""
    out = struct.pack("<HHH", 0, 2 if cur else 1, len(entries))
    at = 6 + 16 * len(entries)
    body = b""
    for w, h, bpp, payload in entries:
        out += struct.pack("<BBBBHHII", w % 256, h % 256, 0, 0, 1, bpp,
                           len(payload), at + len(body))
        body += payload
    return out + body


def write_psd(channels, mode, rle=False, bits=8, palette=None):
    """A PSD with only its composite image: channels (c, h, w) uint8."""
    ch = np.asarray(channels)
    c, h, w = ch.shape
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, c, h, w, bits, mode)
    cm = b"" if palette is None else np.asarray(palette, np.uint8).T \
        .tobytes()
    out = head + struct.pack(">I", len(cm)) + cm + struct.pack(">I", 0) \
        + struct.pack(">I", 0)
    if not rle:
        return out + struct.pack(">H", 0) + ch.astype(">u1").tobytes()
    counts, rows = [], []
    for k in range(c):
        for y in range(h):
            enc = packbits(ch[k, y].tobytes())
            counts.append(len(enc))
            rows.append(enc)
    return out + struct.pack(">H", 1) + struct.pack(
        ">%dH" % len(counts), *counts) + b"".join(rows)
