"""The small raster formats Pillow reads, each read as the JAX package reads
it (`Image.open(path).convert("RGB")` -> (H, W, 3) uint8) and, where
Pillow saves an RGB array without quantising or resampling, written with
Pillow's bytes: PCX and the first page of DCX, SGI (verbatim and RLE, 8
and 16 bits), IM (Pillow's own format), Sun raster (standard and RLE),
XBM, XPM, MSP (both versions) and QOI.  Each decoder follows its Pillow
plugin and codec (PcxDecode.c, SgiRleDecode.c, SunRleDecode.c,
XbmDecode.c, the Python decoders of XPM, MSP and QOI); 16-bit samples
keep their high byte, as Pillow's unpackers do.

Each `open_*` raises SyntaxError where Pillow's plugin gives the file up
(Image.open then tries the next format), and the exception Pillow raises
otherwise; the returned function decodes.  Writers: `encode_pcx`,
`encode_sgi`, `encode_im`, `encode_qoi` (PCX, SGI and IM also take a grey
(H, W) array, as Pillow's mode "L"; QOI only RGB and RGBA).
"""
from __future__ import annotations

import os
import re
import struct

import numpy as np

from . import rawmode

_ERR = {-1: "buffer overrun when reading image file",
        -2: "broken data stream when reading image file"}


def _u16(d, o, e="<"):
    return struct.unpack_from(e + "H", d, o)[0]


def _u32(d, o, e="<"):
    return struct.unpack_from(e + "I", d, o)[0]


def _grey3(v: np.ndarray) -> np.ndarray:
    return np.repeat(np.asarray(v, np.uint8)[..., None], 3, -1)


def _bits(rows: np.ndarray, width: int) -> np.ndarray:
    """(h, bytes) -> (h, width) bits, most significant first."""
    return np.unpackbits(rows, axis=1)[:, :width]


def _truncated():
    return OSError("image file is truncated")


# ---------------------------------------------------------------- PCX ----
def _pcx_accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and prefix[0] == 10 and prefix[1] in (0, 2, 3, 5)


def open_pcx(data: bytes, base: int = 0):
    """PcxImageFile._open at `base` (0, or a DCX page's offset)."""
    s = data[base:base + 68]
    if not _pcx_accept(s):
        raise SyntaxError("not a PCX file")
    if len(s) < 68:
        raise SyntaxError("truncated PCX header")          # struct.error
    x0, y0 = _u16(s, 4), _u16(s, 6)
    x1, y1 = _u16(s, 8) + 1, _u16(s, 10) + 1
    if x1 <= x0 or y1 <= y0:
        raise SyntaxError("bad PCX image size")
    version, bits, planes, given = s[1], s[3], s[65], _u16(s, 66)
    palette = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode = f"P;{planes}L"
        palette = s[16:64]
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
        tail = data[-769:] if len(data) >= 769 else data
        if len(tail) == 769 and tail[0] == 12 and tail[1:] != bytes(
                v for i in range(256) for v in (i, i, i)):
            mode, palette = "P", tail[1:]
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB;L"
    else:
        raise OSError("unknown PCX mode")
    w, h = x1 - x0, y1 - y0
    stride = (w * bits + 7) // 8
    if given != stride:
        stride += stride % 2
    offset = base + 128

    def load():
        return _pcx_load(data, offset, w, h, bits, planes * stride, mode,
                         palette)
    return load


def _pcx_load(data, pos, w, h, bits, nbytes, mode, palette):
    if (w * bits + 7) // 8 > nbytes:
        raise OSError(_ERR[-1])
    lines = np.zeros((h, nbytes), np.uint8)
    line = bytearray(nbytes)
    x = y = 0
    err = 0
    n = len(data)
    while True:
        if pos >= n:
            raise _truncated()
        c = data[pos]
        if c & 0xC0 == 0xC0:
            if pos + 1 >= n:
                raise _truncated()
            v = data[pos + 1]
            for _ in range(c & 0x3F):
                if x >= nbytes:
                    err = -1
                    break
                line[x] = v
                x += 1
            pos += 2
        else:
            line[x] = c
            x += 1
            pos += 1
        if x >= nbytes:
            if nbytes % w and nbytes > w:
                bands = nbytes // w
                stride = nbytes // bands
                for i in range(1, bands):
                    line[i * w:(i + 1) * w] = line[i * stride:i * stride + w]
            lines[y] = np.frombuffer(bytes(line), np.uint8)
            x = 0
            y += 1
            if y >= h:
                break
    if err:
        raise OSError(_ERR[err])
    if mode == "1":
        return _grey3(_bits(lines, w) * 255)
    if mode.startswith("P;"):
        planes = int(mode[2])
        s = (w + 7) // 8
        idx = sum(_bits(lines[:, k * s:(k + 1) * s], w).astype(np.int64)
                  << k for k in range(planes))
        lut = np.zeros((256, 3), np.uint8)
        lut[:16] = np.frombuffer(palette, np.uint8).reshape(16, 3)
        return lut[idx]
    if mode == "L":
        return _grey3(lines[:, :w])
    if mode == "P":
        return np.frombuffer(palette, np.uint8).reshape(256, 3)[lines[:, :w]]
    return np.stack([lines[:, :w], lines[:, w:2 * w], lines[:, 2 * w:3 * w]],
                    -1)


def encode_pcx(img: np.ndarray) -> bytes:
    """(H, W, 3) or (H, W) uint8 -> PCX bytes as Pillow saves mode RGB or
    L (RLE lines, planes padded to even widths, L's grey palette)."""
    if img.ndim == 3 and img.shape[2] != 3:
        mode = {2: "LA", 4: "RGBA"}.get(img.shape[2], "?")
        raise ValueError(f"Cannot save {mode} images as PCX")
    h, w = img.shape[:2]
    planes = 1 if img.ndim == 2 else 3
    stride = w + w % 2
    head = struct.pack("<BBBBHHHHHH", 10, 5, 1, 8, 0, 0, w - 1, h - 1, 100,
                       100) + bytes(24) + b"\xff" * 24 + b"\x00" \
        + struct.pack("<BHHHH", planes, stride, 1, w, h) + bytes(54)
    out = bytearray(head)
    pad = stride - w
    # PcxEncode.c leaves a one-byte line's last plane out of a 3-plane
    # image (its loop ends before it flushes that plane's run)
    written = planes - 1 if w == 1 and planes == 3 else planes
    for y in range(h):
        buf = img[y].tobytes() if planes == 1 else \
            np.ascontiguousarray(img[y].T).tobytes()
        for p in range(written):
            out += _pcx_rle(buf[p * w:(p + 1) * w])
            out += bytes(pad)
    if planes == 1:
        out += b"\x0c" + bytes(v for i in range(256) for v in (i, i, i))
    return bytes(out)


def _pcx_rle(line: bytes) -> bytes:
    """PcxEncode.c on one plane of one line."""
    out = bytearray()
    last, count = line[0], 1
    for this in line[1:]:
        if count == 63:
            out += bytes([0xFF, last])
            count = 0
        if this == last:
            count += 1
            continue
        if count == 1 and last < 0xC0:
            out.append(last)
        elif count > 0:
            out += bytes([0xC0 | count, last])
        last, count = this, 1
    if count == 1 and last < 0xC0:
        out.append(last)
    elif count > 0:
        out += bytes([0xC0 | count, last])
    return bytes(out)


def open_dcx(data: bytes):
    """DcxImageFile: the first page's PCX."""
    if len(data) < 4 or _u32(data, 0) != 0x3ADE68B1:
        raise SyntaxError("not a DCX file")
    first = _u32(data, 4) if len(data) >= 8 else 0
    if not first:
        raise SyntaxError("attempt to seek outside sequence")  # EOFError
    return open_pcx(data, first)


# ---------------------------------------------------------------- SGI ----
_SGI_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L",
              (1, 3, 3): "RGB", (2, 3, 3): "RGB", (1, 3, 4): "RGBA",
              (2, 3, 4): "RGBA"}


def open_sgi(data: bytes):
    if len(data) < 2 or _u16(data, 0, ">") != 474:
        raise ValueError("Not an SGI image file")
    s = data[:512]
    if len(s) < 12:
        raise SyntaxError("truncated SGI header")          # struct.error
    comp, bpc = s[2], s[3]
    dim, w, h, z = (_u16(s, o, ">") for o in (4, 6, 8, 10))
    if (bpc, dim, z) not in _SGI_MODES:
        raise ValueError("Unsupported SGI image mode")
    bands = len(_SGI_MODES[(bpc, dim, z)])
    if comp not in (0, 1):
        def no_tile():
            raise OSError("cannot load this image")
        return no_tile
    if w <= 0 or h <= 0:
        raise SyntaxError("an empty image")

    def load():
        if comp == 0:
            n = w * h * bpc
            planes = []
            for b in range(bands):
                raw = data[512 + b * n:512 + (b + 1) * n]
                if len(raw) < n:
                    raise _truncated()
                v = np.frombuffer(raw, np.uint8 if bpc == 1 else ">u2") \
                    .reshape(h, w)
                planes.append(v if bpc == 1 else (v >> 8))
            px = np.stack(planes, -1)[::-1]
        else:
            px = _sgi_rle(data, w, h, bands, bpc)
        px = px.astype(np.uint8)
        return _grey3(px[..., 0]) if bands == 1 else \
            np.ascontiguousarray(px[..., :3])
    return load


def _sgi_rle(data, w, h, z, bpc):
    """SgiRleDecode.c: per channel and row the start/length tables, then
    the runs (rows stored bottom-up) -> (h, w, z) samples (high bytes)."""
    n = h * z
    tab = data[512:512 + 8 * n]
    if len(tab) < 8 * n:
        raise _truncated()
    starts = struct.unpack(">%dI" % n, tab[:4 * n])
    lengths = struct.unpack(">%dI" % n, tab[4 * n:])
    out = np.zeros((h, w, z), np.int64)
    size = len(data)
    for c in range(z):
        for y in range(h):
            off, ln = starts[y + c * h], lengths[y + c * h]
            if off + ln > size:
                raise OSError(_ERR[-1])
            status = _sgi_row(data, off, ln, bpc, w, out[y, :, c])
            if status == -1:
                raise OSError(_ERR[-1])
            if status == 1:
                return out[::-1]
    return out[::-1]


def _sgi_row(d, src, n, bpc, xsize, dest) -> int:
    """expandrow / expandrow2: `n` counts opcodes (the row's byte length
    read as a count, as Pillow reads it); 16-bit rows keep the first
    (high) byte of each sample."""
    x = 0
    end = len(d) - 1
    while n > 0:
        if (src + 1 if bpc == 2 else src) > end:
            return -1
        pixel = d[src + 1] if bpc == 2 else d[src]
        src += bpc
        if n == 1 and pixel != 0:
            return n
        count = pixel & 0x7F
        if not count:
            return 0
        if x + count > xsize:
            return -1
        if pixel & 0x80:
            if src + bpc * count > end:
                return -1
            dest[x:x + count] = np.frombuffer(d, np.uint8, count * bpc,
                                              src)[::bpc]
            src += bpc * count
        else:
            if (src + 2 if bpc == 2 else src) > end:
                return -1
            dest[x:x + count] = d[src]
            src += bpc
        x += count
        n -= 1
    return 0


def encode_sgi(img: np.ndarray, path: str) -> bytes:
    """(H, W, 3|4) or (H, W) uint8 -> a verbatim 8-bit SGI file as Pillow
    saves it (the file's base name in the header)."""
    h, w = img.shape[:2]
    z = 1 if img.ndim == 2 else img.shape[2]
    dim = (1 if h == 1 else 2) if z == 1 else 3
    name = os.path.splitext(os.path.basename(path))[0]
    name = name.encode("ascii", "ignore")
    head = struct.pack(">hBBHHHHll", 474, 0, 1, dim, w, h, z, 0, 255) \
        + bytes(4) + struct.pack("79s", name) + b"\x00" \
        + struct.pack(">l", 0) + bytes(404)
    planes = [img] if z == 1 else [img[..., k] for k in range(z)]
    return head + b"".join(np.ascontiguousarray(p[::-1]).tobytes()
                           for p in planes)


# ----------------------------------------------------------------- IM ----
_IM_KEYS = {"Comment", "Date", "Digitalization equipment",
            "File size (no of images)", "Lut", "Name", "Scale (x,y)",
            "Image size (x*y)", "Image type"}
# ImImagePlugin.OPEN: image type -> (mode, rawmode)
_IM_OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"),
    "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
    "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
    "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
    "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
    "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
    "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
    "YCC image": ("YCbCr", "YCbCr;L")}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    _IM_OPEN[f"L {_i} image"] = _IM_OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    _IM_OPEN[f"L {_i} image"] = _IM_OPEN[f"L*{_i} image"] = (f"I;{_i}",
                                                            f"I;{_i}")
_IM_OPEN["L 32S image"] = _IM_OPEN["L*32S image"] = ("I", "I;32S")
for _i in range(2, 33):
    _IM_OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
# Pillow 12.1's image modes (Image.new refuses any other)
_PIL_MODES = {"1", "L", "LA", "La", "P", "PA", "RGB", "RGBA", "RGBa",
              "RGBX", "CMYK", "YCbCr", "LAB", "HSV", "I", "I;16", "I;16L",
              "I;16B", "I;16N", "F"}
_IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")


def open_im(data: bytes):
    """ImImageFile._open -> its decoder (a format tried on every file)."""
    if b"\n" not in data[:100]:
        raise SyntaxError("not an IM file")
    pos, n = 0, 0
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    raw = "L"
    s = b""
    while True:
        s = data[pos:pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s == b"\0" or s == b"\x1a":
            break
        nl = data.find(b"\n", pos)
        end = len(data) if nl < 0 else nl + 1
        s += data[pos:end]
        pos = end
        if len(s) > 100:
            raise SyntaxError("not an IM file")
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") \
            else s
        m = _IM_SPLIT.match(s)
        if not m:
            raise SyntaxError("Syntax error in IM header")
        k = m.group(1).decode("latin-1", "replace")
        v = m.group(2).decode("latin-1", "replace")
        if k in ("File size (no of images)", "Scale (x,y)",
                 "Image size (x*y)"):
            vals = tuple(_number(t) for t in v.replace("*", ",").split(","))
            v = vals[0] if len(vals) == 1 else vals
        elif k == "Image type" and v in _IM_OPEN:
            v, raw = _IM_OPEN[v]
        info[k] = v
        if k in _IM_KEYS:
            n += 1
    if not n:
        raise SyntaxError("Not an IM file")
    size = info["Image size (x*y)"]
    mode = info["Image type"]
    if not isinstance(size, tuple) or len(size) != 2 \
            or not all(isinstance(t, int) for t in size) \
            or size[0] <= 0 or size[1] <= 0 or not mode:
        raise SyntaxError("an empty image")
    while s and not s.startswith(b"\x1a"):
        s = data[pos:pos + 1]
        pos += len(s)
    if not s:
        raise SyntaxError("File truncated")
    palette = None
    if "Lut" in info:
        lut = data[pos:pos + 768]
        pos += len(lut)
        if len(lut) < 768:
            raise SyntaxError("truncated IM palette")     # an IndexError
        grey = all(lut[i] == lut[i + 256] == lut[i + 512]
                   for i in range(256))
        if mode in ("L", "LA", "P", "PA") and not grey:
            mode, raw = ("P", "P") if mode in ("L", "P") else ("PA", "PA;L")
            palette = np.frombuffer(lut, np.uint8).reshape(3, 256).T

    def load():
        return _im_load(data, pos, size, mode, raw, palette)
    return load


def _number(t: str):
    try:
        return int(t)
    except ValueError:
        return float(t)


def _im_load(data, pos, size, mode, raw, palette):
    """ImImageFile's tiles: one raw tile bottom-up; three band tiles (G,
    R, B) for the old 3PC types; Pillow's bit decoder for the F;<bits>
    types other than 8, 16 and 32."""
    if mode not in _PIL_MODES:
        raise ValueError("unrecognized image mode")
    if raw in ("RGB;T", "RYB;T"):
        w, h = size
        px = np.zeros((h, w, 3), np.uint8)
        for k, band in enumerate("GRB"):
            px[..., "RGB".index(band)] = rawmode.raw_tile(
                data, pos + k * w * h, size, "RGB", band, 0, -1, False)
    elif mode == "P" and raw == "L":         # Unpack.c's P from "L"
        px = rawmode.raw_tile(data, pos, size, "P", "P", 0, -1, False)
    elif raw.startswith("F;") and raw[2:].isdigit() \
            and int(raw[2:]) not in (8, 16, 32):
        px = _bit_decode(data, pos, size, int(raw[2:]))
    else:
        px = rawmode.raw_tile(data, pos, size, mode, raw, 0, -1)
    return rawmode.to_rgb(px, mode, palette)


def _bit_decode(data, pos, size, bits) -> np.ndarray:
    """BitDecode.c with (bits, pad 8, fill 3, unsigned, bottom-up): bytes
    join the bit buffer above its `bitcount` bits, pixels leave from the
    low end; at each row's end the count (not the buffer) is cleared, so a
    row's leftover bits are OR-ed into the next row's first byte."""
    w, h = size
    rawmode.check_seek(pos)
    mask = (1 << bits) - 1
    out = np.zeros(w * h, np.float32)
    buf = cnt = x = 0
    k = 0
    for byte in data[pos:]:
        buf = (buf | byte << cnt) & 0xFFFFFFFFFFFFFFFF
        cnt += 8
        while cnt >= bits:
            out[k] = buf & mask
            k += 1
            buf = byte >> (8 - (cnt - bits)) if cnt > 32 else buf >> bits
            cnt -= bits
            x += 1
            if x >= w:
                if k == w * h:
                    return out.reshape(h, w)[::-1]
                x = cnt = 0
    raise _truncated()


def encode_im(img: np.ndarray, path: str) -> bytes:
    """(H, W, 3|4) or (H, W) uint8 -> Pillow's IM file: its text header
    (type, name, size, frames) padded to 512 bytes, then the rows
    bottom-up, each line-interleaved by band."""
    h, w = img.shape[:2]
    kind = {1: "Greyscale", 3: "RGB", 4: "RGBA"}[
        1 if img.ndim == 2 else img.shape[2]]
    name, ext = os.path.splitext(os.path.basename(path))
    name = name[:92 - len(ext)] + ext
    head = (f"Image type: {kind} image\r\nName: {name}\r\n"
            f"Image size (x*y): {w}*{h}\r\nFile size (no of images): 1\r\n"
            ).encode("ascii")
    head += b"\x00" * (511 - len(head)) + b"\x1a"
    px = img[::-1]
    body = px.tobytes() if img.ndim == 2 else \
        np.ascontiguousarray(px.transpose(0, 2, 1)).tobytes()
    return head + body


# ---------------------------------------------------------------- Sun ----
def open_sun(data: bytes):
    if len(data) < 4 or _u32(data, 0, ">") != 0x59A66A95:
        raise SyntaxError("not an SUN raster file")
    if len(data) < 32:
        raise SyntaxError("truncated Sun header")         # struct.error
    w, h, depth, _, ftype, ptype, plen = struct.unpack_from(">7I", data, 4)
    if depth == 1:
        mode = "1;I"
    elif depth == 4:
        mode = "L;4"
    elif depth == 8:
        mode = "L"
    elif depth in (24, 32):
        mode = ("RGB" if ftype == 3 else "BGR") + ("X" if depth == 32
                                                   else "")
    else:
        raise SyntaxError("Unsupported Mode/Bit Depth")
    offset = 32
    palette = None
    if plen:
        if plen > 1024:
            raise SyntaxError("Unsupported Color Palette Length")
        if ptype != 1:
            raise SyntaxError("Unsupported Palette Type")
        pal = data[32:32 + plen]
        offset += plen
        if mode.startswith("L"):
            mode = mode.replace("L", "P")
            k = len(pal) // 3
            palette = np.zeros((256, 3), np.uint8)
            palette[:min(k, 256)] = np.frombuffer(pal, np.uint8, 3 * k) \
                .reshape(3, k).T[:256]
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise SyntaxError("Unsupported Sun Raster file type")
    if w <= 0 or h <= 0:
        raise SyntaxError("an empty image")

    def load():
        if ftype == 2:
            nbytes = (w * depth + 7) // 8
            rows = _sun_rle(data, offset, nbytes, h)
        else:
            stride = ((w * depth + 15) // 16) * 2
            buf = data[offset:offset + stride * h]
            if len(buf) < stride * h:
                raise _truncated()
            rows = np.frombuffer(buf, np.uint8).reshape(h, stride)
        if depth == 1:
            return _grey3((1 - _bits(rows, w)) * 255)
        if depth == 4:
            v = np.stack([rows >> 4, rows & 15], -1).reshape(h, -1)[:, :w]
            return palette[v] if palette is not None else _grey3(v * 17)
        if depth == 8:
            v = rows[:, :w]
            return palette[v] if palette is not None else _grey3(v)
        c = depth // 8
        px = rows[:, :w * c].reshape(h, w, c)[..., :3]
        return np.ascontiguousarray(px if mode.startswith("RGB")
                                    else px[..., ::-1])
    return load


def _sun_rle(data, pos, nbytes, h) -> np.ndarray:
    out = np.zeros((h, nbytes), np.uint8)
    line = bytearray(nbytes)
    x = y = 0
    n = len(data)
    while True:
        if pos >= n:
            raise _truncated()
        c = data[pos]
        if c == 0x80:
            if pos + 1 >= n:
                raise _truncated()
            k = data[pos + 1]
            if k == 0:
                line[x] = 0x80
                run = 1
                pos += 2
            else:
                if pos + 2 >= n:
                    raise _truncated()
                run = k + 1
                if x + run > nbytes:
                    raise OSError(_ERR[-1])
                line[x:x + run] = bytes([data[pos + 2]]) * run
                pos += 3
        else:
            line[x] = c
            run = 1
            pos += 1
        x += run
        if x >= nbytes:
            out[y] = np.frombuffer(bytes(line), np.uint8)
            x = 0
            y += 1
            if y >= h:
                return out


# ---------------------------------------------------------------- XBM ----
_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]")


def _hex(c: int) -> int:
    if 48 <= c <= 57:
        return c - 48
    if 97 <= c <= 102:
        return c - 87
    if 65 <= c <= 70:
        return c - 55
    return 0


def open_xbm(data: bytes):
    m = _XBM_HEAD.match(data[:512])
    if not m:
        raise SyntaxError("not a XBM file")
    w, h = int(m.group("width")), int(m.group("height"))
    if w <= 0 or h <= 0:
        raise SyntaxError("an empty image")

    def load():
        stride = (w + 7) // 8
        need = stride * h
        vals = bytearray()
        pos, n = m.end(), len(data)
        while len(vals) < need:
            pos = data.find(b"x", pos)
            if pos < 0 or n - pos < 3:
                raise _truncated()
            vals.append((_hex(data[pos + 1]) << 4) + _hex(data[pos + 2]))
            pos += 3
        rows = np.frombuffer(bytes(vals), np.uint8).reshape(h, stride)
        bits = np.unpackbits(rows, axis=1, bitorder="little")[:, :w]
        return _grey3(bits * 255)
    return load


# ---------------------------------------------------------------- XPM ----
_XPM_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def open_xpm(data: bytes):
    if not data.startswith(b"/* XPM */"):
        raise SyntaxError("not an XPM file")
    lines = [ln + b"\n" for ln in data[9:].split(b"\n")]
    it = iter(lines)
    for line in it:
        m = _XPM_HEAD.match(line)
        if m:
            break
    else:
        raise SyntaxError("broken XPM file")
    w, h, ncol, bpp = (int(g) for g in m.groups())
    palette = {}
    for _ in range(ncol):
        line = next(it, b"").rstrip()
        c = line[1:bpp + 1]
        s = line[bpp + 1:-2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                rgb = s[i + 1]
                if rgb == b"None":
                    pass
                elif rgb.startswith(b"#"):
                    v = int(rgb[1:], 16)
                    palette[c] = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
                else:
                    raise ValueError("cannot read this XPM file")
                break
        else:
            raise ValueError("cannot read this XPM file")
    rest = list(it)
    if w <= 0 or h <= 0:
        raise SyntaxError("an empty image")

    def load():
        keys = list(palette)
        index = {k: i for i, k in enumerate(keys)}
        out = bytearray()
        need = w * h * (3 if ncol > 256 else 1)
        header = False
        for line in rest:
            if len(out) >= need:
                break
            if line.rstrip() == b"/* pixels */" and not header:
                header = True
                continue
            line = b'"'.join(line.split(b'"')[1:-1])
            for i in range(0, len(line), bpp):
                key = line[i:i + bpp]
                if ncol > 256:
                    out += bytes(palette[key])         # KeyError as Pillow
                elif key in index:
                    out.append(index[key])
                else:
                    raise ValueError(f"{key!r} is not in tuple")
        if len(out) < need:
            raise ValueError("not enough image data")
        v = np.frombuffer(bytes(out[:need]), np.uint8)
        if ncol > 256:
            return v.reshape(h, w, 3).copy()
        lut = np.zeros((256, 3), np.uint8)
        if keys:
            lut[:len(keys)] = np.array([palette[k] for k in keys], np.uint8)
        return lut[v.reshape(h, w)]
    return load


# ---------------------------------------------------------------- MSP ----
def open_msp(data: bytes):
    s = data[:32]
    if not s.startswith((b"DanM", b"LinS")):
        raise SyntaxError("not an MSP file")
    if len(s) < 32:
        raise SyntaxError("truncated MSP header")         # struct.error
    chk = 0
    for i in range(0, 32, 2):
        chk ^= _u16(s, i)
    if chk:
        raise SyntaxError("bad MSP checksum")
    w, h = _u16(s, 4), _u16(s, 6)
    if w <= 0 or h <= 0:
        raise SyntaxError("an empty image")
    stride = (w + 7) // 8

    def load():
        if s.startswith(b"DanM"):
            buf = data[32:32 + stride * h]
            if len(buf) < stride * h:
                raise _truncated()
        else:
            buf = _msp2(data, w, h)
            if len(buf) < stride * h:
                raise ValueError("not enough image data")
        rows = np.frombuffer(buf[:stride * h], np.uint8).reshape(h, stride)
        return _grey3(_bits(rows, w) * 255)
    return load


def _msp2(data, w, h) -> bytes:
    rowmap = data[32:32 + 2 * h]
    if len(rowmap) < 2 * h:
        raise OSError("Truncated MSP file in row map")
    lens = struct.unpack("<%dH" % h, rowmap)
    pos = 32 + 2 * h
    out = bytearray()
    for y, ln in enumerate(lens):
        if ln == 0:
            out += b"\xff" * ((w + 7) // 8)
            continue
        row = data[pos:pos + ln]
        pos += ln
        if len(row) != ln:
            raise OSError(f"Truncated MSP file, expected {ln} bytes on "
                          f"row {y}")
        i = 0
        while i < ln:
            t = row[i]
            i += 1
            if t == 0:
                if i + 2 > ln:
                    raise OSError(f"Corrupted MSP file in row {y}")
                out += row[i + 1:i + 2] * row[i]
                i += 2
            else:
                out += row[i:i + t]
                i += t
    return bytes(out)


# ---------------------------------------------------------------- QOI ----
def open_qoi(data: bytes):
    if not data.startswith(b"qoif"):
        raise SyntaxError("not a QOI file")
    if len(data) < 14:
        raise SyntaxError("truncated QOI header")         # IndexError
    w, h = _u32(data, 4, ">"), _u32(data, 8, ">")
    bands = 3 if data[12] == 3 else 4
    if w <= 0 or h <= 0:
        raise SyntaxError("an empty image")
    return lambda: _qoi_decode(data, w, h, bands)


def _qoi_decode(d, w, h, bands) -> np.ndarray:
    seen = {}
    prev = (0, 0, 0, 255)
    out = bytearray()
    need = w * h * bands
    pos = 14
    while len(out) < need:
        b = d[pos]                                  # IndexError as Pillow
        pos += 1
        if b == 0xFE:
            v = tuple(d[pos:pos + 3]) + prev[3:]
            pos += 3
        elif b == 0xFF:
            v = tuple(d[pos:pos + 4])
            pos += 4
        else:
            op = b >> 6
            if op == 0:
                v = seen.get(b & 63, (0, 0, 0, 0))
            elif op == 1:
                v = ((prev[0] + ((b >> 4) & 3) - 2) % 256,
                     (prev[1] + ((b >> 2) & 3) - 2) % 256,
                     (prev[2] + (b & 3) - 2) % 256, prev[3])
            elif op == 2:
                b2 = d[pos]
                pos += 1
                dg = (b & 63) - 32
                v = ((prev[0] + dg + ((b2 >> 4) & 15) - 8) % 256,
                     (prev[1] + dg) % 256,
                     (prev[2] + dg + (b2 & 15) - 8) % 256, prev[3])
            else:
                out += bytes(prev[:bands]) * ((b & 63) + 1)
                continue
        prev = v
        seen[(v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64] = v
        out += bytes(v[:bands])
    px = np.frombuffer(bytes(out[:need]), np.uint8).reshape(h, w, bands)
    return np.ascontiguousarray(px[..., :3])


def encode_qoi(img: np.ndarray) -> bytes:
    """(H, W, 3|4) uint8 -> QOI bytes as Pillow's QoiEncoder writes them
    (colour space byte 1, as Pillow writes by default)."""
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError("Unsupported QOI image mode")
    h, w, c = img.shape
    px = img.reshape(-1, c).tolist()
    seen = {0: (0, 0, 0, 0)}
    prev = (0, 0, 0, 255)
    run = 0
    out = bytearray(b"qoif" + struct.pack(">II", w, h) + bytes([c, 1]))

    def delta(a, b):
        r = (a - b) & 255
        return r - 256 if r >= 128 else r

    for p in px:
        p = (p[0], p[1], p[2], p[3] if c == 4 else 255)
        if p == prev:
            run += 1
            if run == 62:
                out.append(0xC0 | (run - 1))
                run = 0
            continue
        if run:
            out.append(0xC0 | (run - 1))
            run = 0
        r, g, b, a = p
        hsh = (r * 3 + g * 5 + b * 7 + a * 11) % 64
        if seen.get(hsh) == p:
            out.append(hsh)
        else:
            seen[hsh] = p
            if prev[3] == a:
                dr, dg, db = delta(r, prev[0]), delta(g, prev[1]), \
                    delta(b, prev[2])
                if -2 <= dr < 2 and -2 <= dg < 2 and -2 <= db < 2:
                    out.append(0x40 | (dr + 2) << 4 | (dg + 2) << 2
                               | (db + 2))
                else:
                    dgr, dgb = delta(dr, dg), delta(db, dg)
                    if -8 <= dgr < 8 and -32 <= dg < 32 and -8 <= dgb < 8:
                        out += bytes([0x80 | (dg + 32),
                                      (dgr + 8) << 4 | (dgb + 8)])
                    else:
                        out += bytes([0xFE, r, g, b])
            else:
                out += bytes([0xFF, r, g, b, a])
        prev = p
    if run:
        out.append(0xC0 | (run - 1))
    return bytes(out + b"\x00" * 7 + b"\x01")
