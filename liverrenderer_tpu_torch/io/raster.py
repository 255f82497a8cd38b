"""PPM/PGM/PBM, BMP and TGA images, read and written as the JAX package
reads and writes them
through PIL (`Image.open(path).convert("RGB")`): (H, W, 3) uint8, with
PIL's mapping of every depth, palette and bit-field layout, and numpy
only.  Written from the formats' specifications and PIL's documented
decoding: 16-bit grey clips to 255 after PIL's scaling to 65,535, 5- and
6-bit fields scale by v * 255 // (2^n - 1), BMP's RLE and TGA's RLE
follow PIL's decoders.  Files that PIL refuses raise OSError, as PIL's
own errors do.  The writers produce the bytes PIL's `save` writes for an
RGB, RGBA or grey uint8 array.
"""
from __future__ import annotations

import struct

import numpy as np

_WS = b" \t\n\r\x0b\x0c"


# ---------------------------------------------------------------- PPM ----
def _ppm_token(data: bytes, pos: int):
    """The next header token (whitespace and # comments skipped) -> (token,
    position after the one whitespace byte that ends it)."""
    tok = b""
    while pos < len(data) and len(tok) <= 10:
        c = data[pos:pos + 1]
        pos += 1
        if c in _WS and c:
            if tok:
                break
            continue
        if c == b"#":
            while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                pos += 1
            pos += 1
            continue
        tok += c
    if not tok or len(tok) > 10:
        raise ValueError("PPM: a bad header token")
    return tok, pos


def _ppm_plain_tokens(body: bytes) -> list:
    """The plain formats' data tokens, comments removed."""
    out = []
    for line in body.replace(b"\r", b"\n").split(b"\n"):
        out += line.split(b"#", 1)[0].split()
    return out


# PpmImagePlugin.MODES
PPM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
             b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
             b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}


def ppm_magic(data: bytes) -> bytes:
    """PpmImageFile._read_magic: up to 6 bytes, to a whitespace."""
    magic = b""
    for c in data[:6]:
        if bytes([c]) in _WS:
            break
        magic += bytes([c])
    return magic


def open_ppm(data: bytes):
    """PpmImageFile._open -> a function that decodes the file: the magic,
    the size and the scale or maxval read (and refused) at open."""
    magic = ppm_magic(data)
    if magic not in PPM_MODES:
        raise SyntaxError("not a PPM file")
    mode = PPM_MODES[magic]
    tw, pos = _ppm_token(data, len(magic))
    th, pos = _ppm_token(data, pos)
    size = int(tw), int(th)
    if size[0] <= 0 or size[1] <= 0:
        raise SyntaxError("not identified by this plugin")
    if mode == "F":
        scale = float(_ppm_token(data, pos)[0])
        if scale == 0.0 or not np.isfinite(scale):
            raise ValueError("scale must be finite and non-zero")
    elif mode != "1":
        maxval = int(_ppm_token(data, pos)[0])
        if not 0 < maxval < 65536:
            raise ValueError("maxval must be greater than 0 and less than "
                             "65536")
    if magic[:2] in (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6"):
        return lambda: read_ppm(data)
    return lambda: _read_ppm_ext(data, magic, size)


def _read_ppm_ext(data: bytes, magic: bytes, size) -> np.ndarray:
    """Pillow's extensions of the format: Pf (grey floats, bottom-up, the
    scale's sign the byte order), P0CMYK / PyCMYK, PyP (P without a
    palette: black) and PyRGBA, raw at maxval 255, else through
    PpmDecoder's scaling."""
    from . import rawmode
    mode = PPM_MODES[magic]
    _, pos = _ppm_token(data, len(magic))
    _, pos = _ppm_token(data, pos)
    tok, pos = _ppm_token(data, pos)
    if mode == "F":
        raw = "F;32F" if float(tok) < 0 else "F;32BF"
        return rawmode.to_rgb(rawmode.raw_tile(data, pos, size, "F", raw,
                                               0, -1), "F")
    maxval = int(tok)
    if maxval == 255:
        return rawmode.to_rgb(rawmode.raw_tile(data, pos, size, mode, mode),
                              mode)
    rawmode.check_seek(pos)
    bands = {"P": 1, "RGBA": 4, "CMYK": 4}[mode]
    wide = maxval >= 256
    n = size[0] * size[1] * bands
    avail = (len(data) - pos) // ((1 + wide) * bands) * bands
    v = np.frombuffer(data, ">u2" if wide else np.uint8, min(n, avail), pos)
    v = np.minimum(255, np.round(v / maxval * 255))
    return rawmode.to_rgb(rawmode.frombytes(v.astype(np.uint8).tobytes(),
                                            size, mode), mode)


def read_ppm(data: bytes) -> np.ndarray:
    """P1-P6 -> (H, W, 3) uint8."""
    magic = data[:2]
    if magic not in (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6"):
        raise OSError("not a PPM file")
    tw, pos = _ppm_token(data, 2)
    th, pos = _ppm_token(data, pos)
    w, h = int(tw), int(th)
    bands = 3 if magic in (b"P3", b"P6") else 1
    n = w * h * bands
    if magic in (b"P1", b"P4"):
        if magic == b"P4":
            stride = (w + 7) // 8
            rows = np.frombuffer(data, np.uint8, stride * h, pos)
            bits = np.unpackbits(rows.reshape(h, stride), axis=1)[:, :w]
        else:
            digits = bytes(b"".join(_ppm_plain_tokens(data[pos:])))
            bits = (np.frombuffer(digits[:w * h], np.uint8) == ord("1")) \
                .reshape(h, w)
        grey = np.where(bits.astype(bool), 0, 255).astype(np.uint8)
        return np.repeat(grey[..., None], 3, -1)
    tm, pos = _ppm_token(data, pos)
    maxval = int(tm)
    if not 0 < maxval < 65536:
        raise ValueError("maxval must be greater than 0 and less than 65536")
    # PIL reads 16-bit grey as mode I (scaled to 65,535) and clips it to
    # 255 in convert("RGB"); everything else scales to 255
    out_max = 65535 if (maxval > 255 and bands == 1) else 255
    if magic in (b"P2", b"P3"):
        v = np.array([int(t) for t in _ppm_plain_tokens(data[pos:])[:n]],
                     np.int64)
        if (v > maxval).any():
            raise ValueError("Channel value too large for this mode")
        v = np.round(v / maxval * out_max)
    elif maxval == 255:
        from . import rawmode
        mode = "RGB" if bands == 3 else "L"
        return rawmode.to_rgb(rawmode.raw_tile(data, pos, (w, h), mode,
                                               mode), mode)
    else:
        dt = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
        v = np.frombuffer(data, dt, n, pos).astype(np.float64)
        v = np.round(v / maxval * out_max) if maxval != 65535 \
            or bands == 3 else v
        v = np.minimum(v, out_max)
    img = np.minimum(v, 255).astype(np.uint8).reshape(h, w, bands)
    return img if bands == 3 else np.repeat(img, 3, -1)


# ---------------------------------------------------------------- BMP ----
_BMP_MASKS = {
    32: {(0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
         (0xFF000000, 0xFF00, 0xFF, 0x0),
         (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
         (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
         (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
         (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0)},
    24: {(0xFF0000, 0xFF00, 0xFF)},
    16: {(0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)},
}


def _field(px: np.ndarray, mask: int) -> np.ndarray:
    """A bit field of the pixels scaled to 8 bits as PIL's unpackers do
    (v * 255 // (2^n - 1); 8-bit fields as they are)."""
    shift = (mask & -mask).bit_length() - 1
    top = mask >> shift
    v = (px.astype(np.int64) >> shift) & top
    return (v if top == 255 else v * 255 // top).astype(np.uint8)


def _bmp_rle(data: bytes, pos: int, w: int, h: int, rle4: bool) -> bytes:
    """PIL's BMP RLE4/RLE8 decoder -> w * h indices (rows bottom-up in the
    order stored)."""
    out = bytearray()
    x = 0
    need = w * h
    end = len(data)
    while len(out) < need:
        if pos + 2 > end:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            count = min(count, max(0, w - x)) if x + count > w else count
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:              # end of line
            out += bytes(-len(out) % w)
            x = 0
        elif byte == 1:              # end of bitmap
            break
        elif byte == 2:              # delta (PIL reads two bytes more)
            if pos + 2 > end:
                break
            pos += 2
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * w)
            x = len(out) % w
        else:                        # absolute run
            if rle4:
                nbytes = byte // 2
                raw = data[pos:pos + nbytes]
                out += bytes(v for b in raw for v in (b >> 4, b & 15))
            else:
                nbytes = byte
                raw = data[pos:pos + nbytes]
                out += raw
            pos += len(raw)
            if len(raw) < nbytes:
                break
            x += byte
            pos += pos % 2           # word alignment
    if len(out) < need:
        raise ValueError("not enough image data")
    return bytes(out[:need])


def read_bmp(data: bytes) -> np.ndarray:
    """A Windows or OS/2 bitmap -> (H, W, 3) uint8."""
    if data[:2] != b"BM":
        raise OSError("Not a BMP file")
    return read_dib(data, 14, int.from_bytes(data[10:14], "little"))


def read_dib(data: bytes, base: int = 0, offset: int = 0,
             halve: bool = False) -> np.ndarray:
    """A bitmap without its file header (DIB, or an ICO / CUR entry) whose
    info header starts at `base` -> (H, W, 3) uint8, as Pillow's
    BmpImageFile._bitmap reads it.  `offset` is the pixels' position (0:
    right after the header, masks and palette); `halve` takes the first
    half of the rows, as the icon plugins do (the AND mask only touches
    alpha, which convert("RGB") drops)."""
    hsize = int.from_bytes(data[base:base + 4], "little")
    hd = data[base + 4:base + hsize]

    def u32(o):
        return int.from_bytes(hd[o:o + 4], "little")

    def u16(o):
        return int.from_bytes(hd[o:o + 2], "little")

    pal_pos = base + hsize
    masks = None
    if hsize == 12:
        w, h, bits, comp, colors, pad = u16(0), u16(2), u16(6), 0, 0, 3
        topdown = False
    elif hsize in (40, 52, 56, 64, 108, 124):
        topdown = hd[7] == 0xFF
        w, h = u32(0), u32(4)
        h = 2 ** 32 - h if topdown else h
        bits, comp, colors, pad = u16(10), u32(12), u32(28), 4
        if comp == 3:                # BITFIELDS
            if len(hd) >= 48:
                masks = tuple(u32(36 + 4 * i) for i in range(3)) + \
                    ((u32(48),) if len(hd) >= 52 else (0,))
            else:
                masks = tuple(int.from_bytes(data[pal_pos + 4 * i:
                                                  pal_pos + 4 * i + 4],
                                             "little") for i in range(3)) \
                    + (0,)
                pal_pos += 12
    else:
        raise OSError(f"Unsupported BMP header type ({hsize})")
    if halve:
        h //= 2
    colors = colors or (1 << bits)
    if offset and offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if not offset:               # Pillow's fp.tell() after the palette
        offset = pal_pos + (pad * colors if bits <= 8 else 0)
    if bits not in (1, 4, 8, 16, 24, 32):
        raise OSError(f"Unsupported BMP pixel depth ({bits})")
    if comp == 3:
        if bits not in _BMP_MASKS or (masks if bits == 32 else masks[:3]) \
                not in _BMP_MASKS[bits]:
            raise OSError("Unsupported BMP bitfields layout")
    elif comp not in (0, 1, 2):
        raise OSError(f"Unsupported BMP compression ({comp})")
    if comp == 0 and bits == 16:
        masks = (0x7C00, 0x3E0, 0x1F, 0)
    stride = ((w * bits + 31) >> 3) & ~3
    if comp in (1, 2):
        idx = np.frombuffer(_bmp_rle(data, offset, w, h, comp == 2),
                            np.uint8).reshape(h, w)
    elif bits <= 8:
        rows = np.frombuffer(data, np.uint8, stride * h, offset) \
            .reshape(h, stride)
        idx = np.unpackbits(rows, axis=1).reshape(h, -1, bits)
        idx = (idx * (1 << np.arange(bits - 1, -1, -1))).sum(-1)[:, :w]
    else:
        rows = np.frombuffer(data, np.uint8, stride * h, offset) \
            .reshape(h, stride)[:, :w * bits // 8]
        if bits == 24:
            img = rows.reshape(h, w, 3)[..., ::-1]
        else:
            px = rows.reshape(h, w, bits // 8).view(
                "<u2" if bits == 16 else "<u4")[..., 0]
            r, g, b = (masks or (0xFF0000, 0xFF00, 0xFF, 0))[:3]
            if (r, g, b) == (0, 0, 0):   # PIL reads an empty layout as BGRA
                r, g, b = 0xFF0000, 0xFF00, 0xFF
            img = np.stack([_field(px, r), _field(px, g), _field(px, b)], -1)
        return np.ascontiguousarray(img if topdown else img[::-1])
    if not 0 < colors <= 65536:
        raise OSError(f"Unsupported BMP Palette size ({colors})")
    pal = np.frombuffer(data[pal_pos:pal_pos + pad * colors], np.uint8)
    pal = pal[:len(pal) // pad * pad].reshape(-1, pad)[:, 2::-1]
    # PIL's palette holds 256 entries: past the file's, a grey ramp
    lut = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    lut[:min(len(pal), 256)] = pal[:256]
    img = lut[idx]
    return np.ascontiguousarray(img if topdown else img[::-1])


# ---------------------------------------------------------------- TGA ----
def _tga_rle(data: bytes, pos: int, w: int, h: int, size: int) -> bytes:
    """TGA run-length packets -> w * h pixels of `size` bytes.  As PIL's
    decoder, a packet may not run past the end of its line."""
    out = bytearray()
    need = w * h * size
    while len(out) < need:
        if pos >= len(data):
            raise OSError("image file is truncated")
        head = data[pos]
        pos += 1
        count = (head & 0x7F) + 1
        if len(out) // size % w + count > w:
            raise OSError("buffer overrun when reading image file")
        if head & 0x80:
            px = data[pos:pos + size]
            pos += size
            out += px * count
        else:
            px = data[pos:pos + size * count]
            pos += size * count
            out += px
        if len(px) < (size if head & 0x80 else size * count):
            raise OSError("image file is truncated")
    return bytes(out)


def read_tga(data: bytes) -> np.ndarray:
    """A Targa file (types 1, 2, 3, 9, 10, 11) -> (H, W, 3) uint8."""
    id_len, cmap_type, itype = data[0], data[1], data[2]
    w = int.from_bytes(data[12:14], "little")
    h = int.from_bytes(data[14:16], "little")
    depth, flags = data[16], data[17]
    if cmap_type not in (0, 1) or w <= 0 or h <= 0 \
            or depth not in (1, 8, 16, 24, 32):
        raise OSError("not a TGA file")
    if itype not in (1, 2, 3, 9, 10, 11):
        raise OSError("unknown TGA mode")
    pos = 18 + id_len
    lut = None
    if cmap_type:
        start = int.from_bytes(data[3:5], "little")
        size = int.from_bytes(data[5:7], "little")
        mdepth = data[7]
        if mdepth not in (16, 24, 32):
            raise OSError("unknown TGA map depth")
        if mdepth == 32:       # PIL's palette has no BGRA raw mode
            raise ValueError("unrecognized raw mode")
        nb = mdepth // 8
        raw = np.frombuffer(data, np.uint8, nb * size, pos).reshape(size, nb)
        pos += nb * size
        if mdepth == 16:
            px = raw.view("<u2")[:, 0]
            ent = np.stack([_field(px, 0x7C00), _field(px, 0x3E0),
                            _field(px, 0x1F)], -1)
        else:
            ent = raw[:, 2::-1]
        lut = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
        lut[:min(start, 256)] = 0
        k = max(0, min(size, 256 - start))
        lut[start:start + k] = ent[:k]
    kind = itype & 7
    if (kind, depth) not in ((1, 8), (3, 1), (3, 8), (3, 16), (2, 16),
                             (2, 24), (2, 32)):
        raise OSError("cannot decode this TGA layout")
    if depth == 1:
        if itype & 8:          # PIL's RLE decoder reads no 1-bit pixels
            raise OSError("image file is truncated")
        stride = (w + 7) // 8
        raw = np.frombuffer(data, np.uint8, stride * h, pos)
        px = np.unpackbits(raw.reshape(h, stride), axis=1)[:, :w] * 255
        img = np.repeat(px[..., None].astype(np.uint8), 3, -1)
    else:
        nb = depth // 8
        if itype & 8:
            buf = np.frombuffer(_tga_rle(data, pos, w, h, nb), np.uint8)
        else:
            buf = np.frombuffer(data, np.uint8, w * h * nb, pos)
        px = buf.reshape(h, w, nb)
        if kind == 1:
            img = (lut if lut is not None else
                   np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
                   )[px[..., 0]]
        elif kind == 3:
            img = np.repeat(px[..., :1], 3, -1)
        elif depth == 16:
            p16 = px.view("<u2")[..., 0]
            img = np.stack([_field(p16, 0x7C00), _field(p16, 0x3E0),
                            _field(p16, 0x1F)], -1)
        else:
            img = px[..., 2::-1]
    orient = flags & 0x30
    if not orient & 0x20:
        img = img[::-1]
    if orient & 0x10:
        img = img[:, ::-1]
    return np.ascontiguousarray(img)


# ------------------------------------------------------------ writers ----
def encode_ppm(img: np.ndarray) -> bytes:
    """(H, W, 3|4) or (H, W) uint8 -> P6 or P5 bytes, as PIL writes them
    (alpha dropped)."""
    h, w = img.shape[:2]
    if img.ndim == 2:
        return b"P5\n%d %d\n255\n" % (w, h) + img.tobytes()
    return b"P6\n%d %d\n255\n" % (w, h) + \
        np.ascontiguousarray(img[..., :3]).tobytes()


def encode_bmp(img: np.ndarray) -> bytes:
    """(H, W, 3|4) or (H, W) uint8 -> a bottom-up BMP as PIL writes it
    (24-bit BGR, 32-bit BGRA, or 8-bit with a grey palette; 96 dpi)."""
    h, w = img.shape[:2]
    if img.ndim == 2:
        bits, colors, px = 8, 256, img
        palette = np.repeat(np.arange(256, dtype=np.uint8), 4) \
            .reshape(256, 4)
        palette[:, 3] = 0
        palette = palette.tobytes()
    else:
        bits, colors, palette = 8 * img.shape[2], 0, b""
        order = [2, 1, 0, 3][:img.shape[2]]
        px = img[..., order]
    stride = ((w * bits + 7) // 8 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * bits // 8] = px[::-1].reshape(h, -1)
    offset = 14 + 40 + 4 * colors
    ppm = int(96 * 39.3701 + 0.5)
    head = b"BM" + struct.pack("<IHHI", offset + rows.size, 0, 0, offset)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bits, 0, rows.size, ppm,
                       ppm, colors, colors)
    return head + info + palette + rows.tobytes()


def encode_tga(img: np.ndarray) -> bytes:
    """(H, W, 3|4) or (H, W) uint8 -> an uncompressed bottom-up TGA as PIL
    writes it, with its TRUEVISION-XFILE footer."""
    h, w = img.shape[:2]
    if img.ndim == 2:
        itype, bits, flags, px = 3, 8, 0, img[..., None]
    else:
        c = img.shape[2]
        itype, bits, flags = 2, 8 * c, 8 if c == 4 else 0
        px = img[..., [2, 1, 0, 3][:c]]
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, itype, 0, 0, 0, 0, 0, w, h,
                       bits, flags)
    return head + np.ascontiguousarray(px[::-1]).tobytes() + bytes(8) \
        + b"TRUEVISION-XFILE.\x00"
