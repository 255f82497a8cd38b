"""The Pillow 12.1 plugins without a module of their own in the port, for
io/image.py's walk over Pillow's registry: the stubs, MPEG, EPS, IPTC,
GBR, IMT, McIdas, PhotoCD, PIXAR, SPIDER, XV thumbnails and JPEG 2000's
header (FITS, FLI and ICNS live in io/fits.py, io/fli.py, io/icns.py).

Each opener mirrors its plugin's `_open` on the file's bytes and returns
the function that loads it, or raises as Pillow raises:

- SyntaxError where Pillow gives the file up, so the walk passes it on
  to the next plugin.  ImageFile's constructor turns an IndexError,
  TypeError, KeyError, EOFError or struct.error of `_open` into one, and
  so does an image with no mode or an empty size (`_pillow_open`).
- Pillow's own exception class (OSError, ValueError, AssertionError,
  ...) where its `_open` raises one out of Image.open, and
  DecompressionBombError past twice Image.MAX_IMAGE_PIXELS.
- At load: the stub plugins (BUFR, GRIB, HDF5, WMF), which have no
  handler on this platform, raise "cannot find loader"; an MPEG file, an
  IPTC record without image data, or an IMT header without its form
  feed, has no tile ("cannot load this image"); an EPS file goes through
  Ghostscript as Pillow runs it (the same command line, the page read
  back by io/raster.py), or raises Pillow's OSError where there is no
  `gs`.  GBR, IMT, McIdas, PIXAR, SPIDER and XV thumbnails decode their
  raw tile (io/rawmode.py); IPTC opens its image data as a file of its
  own (a raw band behind a P5 header, or JPEG) and merges a band into
  the mode's others as Pillow's Image.merge does; PhotoCD decodes the
  base image's PhotoYCC as Pillow's pcd decoder and YCC;P unpacker do
  and rotates it by the orientation byte.  JPEG 2000 opens here (the
  codestream's SIZ or the JP2 boxes, with the palette of a `pclr` box)
  and decodes through io/jpeg2000.py.
"""
from __future__ import annotations

import io
import os
import re
import struct
import subprocess
import tempfile

import numpy as np

from . import rawmode

# Image.MAX_IMAGE_PIXELS
MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3


class DecompressionBombError(Exception):
    """Pillow's Image.DecompressionBombError."""


def _i16(c, o=0):
    return struct.unpack_from("<H", c, o)[0]


def _i32(c, o=0):
    return struct.unpack_from("<I", c, o)[0]


def _i16be(c, o=0):
    return struct.unpack_from(">H", c, o)[0]


def _i32be(c, o=0):
    return struct.unpack_from(">I", c, o)[0]


def _pillow_open(open_fn):
    """ImageFile.__init__ around a plugin's `_open(fp)` -> (mode, size,
    load): the errors it turns into SyntaxError, its empty-image test,
    then Image.open's decompression-bomb test."""
    def opener(data: bytes):
        try:
            mode, size, load = open_fn(io.BytesIO(data))
        except (IndexError, TypeError, KeyError, EOFError,
                struct.error) as e:
            raise SyntaxError(str(e)) from e
        if not mode or size[0] <= 0 or size[1] <= 0:
            raise SyntaxError("not identified by this plugin")
        pixels = max(1, size[0]) * max(1, size[1])
        if pixels > 2 * MAX_IMAGE_PIXELS:
            raise DecompressionBombError(
                f"Image size ({pixels} pixels) exceeds limit of "
                f"{2 * MAX_IMAGE_PIXELS} pixels, could be decompression "
                "bomb DOS attack.")
        return load
    return opener


def _no_loader(fmt):
    def load():
        raise OSError(f"cannot find loader for this {fmt} file")
    return load


def _no_tile():
    raise OSError("cannot load this image")


def _raw_load(fp, offset, size, mode, raw, stride=0, palette=None):
    """The load of a plugin with one raw tile (rawmode.raw_tile)."""
    data = fp.getvalue()
    return lambda: rawmode.to_rgb(rawmode.raw_tile(
        data, offset, size, mode, raw, stride), mode, palette)


# --------------------------------------------------- the stub plugins ----
def _stub(fmt, n, accept):
    """BufrStub / GribStub / Hdf5StubImagePlugin: the prefix test again on
    the first `n` bytes; mode F, 1 x 1; no handler registered."""
    def _open(fp):
        if not accept(fp.read(n)):
            raise SyntaxError(f"Not a {fmt} file")
        return "F", (1, 1), _no_loader(fmt)
    return _pillow_open(_open)


open_bufr = _stub("BUFR", 4, lambda p: p.startswith((b"BUFR", b"ZCZC")))
open_grib = _stub("GRIB", 8, lambda p: len(p) >= 8 and p.startswith(b"GRIB")
                  and p[7] == 1)
open_hdf5 = _stub("HDF5", 8, lambda p: p.startswith(b"\x89HDF\r\n\x1a\n"))


@_pillow_open
def open_wmf(fp):
    """WmfStubImageFile._open: a placeable WMF header (inch, bounding box,
    the standard metafile header at bytes 22-26) or an EMF header."""
    s = fp.read(44)
    if s.startswith(b"\xd7\xcd\xc6\x9a\x00\x00"):
        inch = _i16(s, 14)
        if inch == 0:
            raise ValueError("Invalid inch")
        x0, y0, x1, y1 = struct.unpack_from("<4h", s, 6)
        size = ((x1 - x0) * 72 // inch, (y1 - y0) * 72 // inch)
        if s[22:26] != b"\x01\x00\t\x00":
            raise SyntaxError("Unsupported WMF file format")
    elif s.startswith(b"\x01\x00\x00\x00") and s[40:44] == b" EMF":
        x0, y0, x1, y1 = struct.unpack_from("<4i", s, 8)
        frame = struct.unpack_from("<4i", s, 24)
        size = x1 - x0, y1 - y0
        # the dpi Pillow computes (a ZeroDivisionError on an empty frame)
        2540.0 * (x1 - x0) / (frame[2] - frame[0])
        2540.0 * (y1 - y0) / (frame[3] - frame[1])
    else:
        raise SyntaxError("Unsupported file format")
    return "RGB", size, _no_loader("WMF")


# ------------------------------------------------------------- MPEG ----
@_pillow_open
def open_mpeg(fp):
    """MpegImageFile._open: the sequence header's 12-bit width and height
    (a byte past the end is an IndexError); no tile, so load raises."""
    bits = bitbuf = 0

    def read(n):
        nonlocal bits, bitbuf
        while bits < n:
            bitbuf = (bitbuf << 8) + fp.read(1)[0]
            bits += 8
        v = bitbuf >> (bits - n) & (1 << n) - 1
        bits -= n
        return v

    if read(32) != 0x1B3:
        raise SyntaxError("not an MPEG file")
    w = read(12)
    return "RGB", (w, read(12)), _no_tile


# -------------------------------------------------------------- EPS ----
_EPS_SPLIT = re.compile(r"^%%([^:]*):[ \t]*(.*)[ \t]*$")
_EPS_FIELD = re.compile(r"^%[%!\w]([^:]*)[ \t]*$")
_EPS_MODES = {1: "L", 2: "LAB", 3: "RGB", 4: "CMYK"}


@_pillow_open
def open_eps(fp):
    """EpsImageFile._open: the DOS EPS header, then the DSC comments read
    line by line for %!PS-Adobe, %%BoundingBox (or its value at the end)
    and %ImageData."""
    s = fp.read(4)
    if s == b"%!PS":
        fp.seek(0, io.SEEK_END)
        offset = 0
    elif _i32(s) == 0xC6D3D0C5:
        offset = _i32(fp.read(8))
    else:
        raise SyntaxError("not an EPS file")
    fp.seek(offset)
    mode = "RGB"
    info = {}
    bounding_box = imagedata_size = None
    byte_arr = bytearray(255)
    mv = memoryview(byte_arr)
    n = 0
    header = True
    trailer_comments = trailer_reached = False

    def required():
        if "PS-Adobe" not in info:
            raise SyntaxError('EPS header missing "%!PS-Adobe" comment')
        if "BoundingBox" not in info:
            raise SyntaxError('EPS header missing "%%BoundingBox" comment')

    def read_comment(s):
        nonlocal bounding_box, trailer_comments
        try:
            m = _EPS_SPLIT.match(s)
        except re.error as e:
            raise SyntaxError("not an EPS file") from e
        if not m:
            return False
        k, v = m.group(1, 2)
        info[k] = v
        if k == "BoundingBox":
            if v == "(atend)":
                trailer_comments = True
            elif not bounding_box or (trailer_reached and trailer_comments):
                try:
                    bounding_box = [int(float(i)) for i in v.split()]
                except Exception:               # noqa: BLE001 - as Pillow
                    pass
        return True

    while True:
        byte = fp.read(1)
        if byte == b"":
            if n == 0:
                if header:
                    required()
                break
        elif byte in b"\r\n":
            if n == 0:
                continue
        else:
            if n >= 255:
                if byte_arr[0] == ord("%"):
                    raise SyntaxError("not an EPS file")
                if header:
                    required()
                    header = False
                n = 0
            byte_arr[n] = byte[0]
            n += 1
            continue
        if header:
            if byte_arr[0] != ord("%") or mv[:13] == b"%%EndComments":
                required()
                header = False
                continue
            s = str(mv[:n], "latin-1")
            if not read_comment(s):
                m = _EPS_FIELD.match(s)
                if m:
                    k = m.group(1)
                    if k.startswith("PS-Adobe"):
                        info["PS-Adobe"] = k[9:]
                    else:
                        info[k] = ""
                elif s[0] != "%":
                    raise OSError("bad EPS header")
        elif mv[:11] == b"%ImageData:":
            if imagedata_size:
                n = 0
                continue
            cols, rows, depth, mode_id = (
                int(v) for v in byte_arr[11:n].split(None, 7)[:4])
            if depth == 1:
                mode = "1"
            elif depth == 8:
                mode = _EPS_MODES[mode_id]
            else:
                break
            imagedata_size = cols, rows
        elif mv[:5] == b"%%EOF":
            break
        elif trailer_reached and trailer_comments:
            read_comment(str(mv[:n], "latin-1"))
        elif mv[:9] == b"%%Trailer":
            trailer_reached = True
        elif mv[:14] == b"%%BeginBinary:":
            fp.seek(int(byte_arr[14:n]), os.SEEK_CUR)
        n = 0
    if not bounding_box:
        raise OSError("cannot determine EPS bounding box")
    size = imagedata_size or (bounding_box[2] - bounding_box[0],
                              bounding_box[3] - bounding_box[1])
    return mode, size, lambda: _ghostscript(fp.getvalue(), size,
                                            bounding_box)


def _has_ghostscript() -> bool:
    """EpsImagePlugin.has_ghostscript on a POSIX host."""
    try:
        subprocess.check_call(["gs", "--version"], stdout=subprocess.DEVNULL)
    except OSError:
        return False
    return True


def _ghostscript(data: bytes, size, bbox):
    """EpsImagePlugin.Ghostscript at scale 1 without transparency: Pillow's
    command line, and the pnmraw page it writes read by the port."""
    if not _has_ghostscript():
        raise OSError("Unable to locate Ghostscript on paths")
    from . import raster
    width, height = size
    res_x = 72.0 * width / (bbox[2] - bbox[0])
    res_y = 72.0 * height / (bbox[3] - bbox[1])
    with tempfile.TemporaryDirectory() as tmp:
        infile, outfile = os.path.join(tmp, "in.eps"), os.path.join(tmp,
                                                                   "out")
        with open(infile, "wb") as f:
            f.write(data)
        subprocess.check_call([
            "gs", "-q", f"-g{width:d}x{height:d}", f"-r{res_x:f}x{res_y:f}",
            "-dBATCH", "-dNOPAUSE", "-dSAFER", "-sDEVICE=pnmraw",
            f"-sOutputFile={outfile}", "-c",
            f"{-bbox[0]} {-bbox[1]} translate",
            "-f", infile, "-c", "showpage"])
        with open(outfile, "rb") as f:
            return raster.read_ppm(f.read())


# ------------------------------------------------------------- IPTC ----
def _iptc_i(c):
    return _i32be((b"\0\0\0\0" + c)[-4:])


def _iptc_field(fp):
    """IptcImageFile.field -> (tag or None, size)."""
    s = fp.read(5)
    if not s.strip(b"\x00"):
        return None, 0
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
        raise SyntaxError("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise OSError("illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        size = _iptc_i(fp.read(size - 128))
    else:
        size = _i16be(s, 3)
    return tag, size


@_pillow_open
def open_iptc(fp):
    """IptcImageFile._open: the fields up to the image data (8:10), then
    the image's layers (3:60), size (3:20, 3:30) and compression (3:120).
    Without 8:10 the file opens with no tile."""
    info = {}
    while True:
        offset = fp.tell()
        tag, size = _iptc_field(fp)
        if not tag or tag == (8, 10):
            break
        tagdata = fp.read(size) if size else None
        if tag in info:
            if isinstance(info[tag], list):
                info[tag].append(tagdata)
            else:
                info[tag] = [info[tag], tagdata]
        else:
            info[tag] = tagdata
    layers = info[(3, 60)][0]
    component = info[(3, 60)][1]
    mode, band = "", None
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
    size = _iptc_i(info[(3, 20)]), _iptc_i(info[(3, 30)])
    try:
        compression = {1: "raw", 5: "jpeg"}[_iptc_i(info[(3, 120)])]
    except KeyError as e:
        raise OSError("Unknown IPTC image compression") from e
    if tag != (8, 10):
        return mode, size, _no_tile
    data = fp.getvalue()
    return mode, size, lambda: _iptc_load(data, offset, mode, size,
                                          compression, band)


def _iptc_load(data, offset, mode, size, compression, band):
    """IptcImageFile.load: the 8:10 fields' bytes (after a P5 header when
    raw) opened as an image of their own; a band image goes into the
    mode's other bands as zeros (Image.merge)."""
    from . import image, jpeg
    fp = io.BytesIO(data)
    fp.seek(offset)
    o = bytearray(b"P5\n%d %d\n255\n" % size if compression == "raw"
                  else b"")
    while True:
        tag, n = _iptc_field(fp)
        if tag != (8, 10):
            break
        while n > 0:
            s = fp.read(min(n, 8192))
            if not s:
                break
            o += s
            n -= len(s)
    inner = bytes(o)
    token = rawmode.FROM_PATH.set(False)        # Image.open of a stream
    try:
        fmt, load = image.identify_format(inner)
        if band is None:
            return load()
        bands = [None] * (3 if mode == "RGB" else 4)
        bands[band] = "image"                   # an IndexError, as Pillow
        is_l = fmt == "PPM" and inner[:2] in (b"P2", b"P5") \
            and _ppm_maxval(inner) < 256 \
            or fmt == "JPEG" and jpeg.components(inner) == 1
        if not is_l and bands[0] is None:       # Image.merge's test
            raise ValueError("mode mismatch")
        px = load()[..., 0]
        if not is_l:                            # core.merge's
            raise ValueError("image has wrong mode")
    finally:
        rawmode.FROM_PATH.reset(token)
    out = np.zeros(px.shape + (len(bands),), np.uint8)
    out[..., bands.index("image")] = px
    return rawmode.to_rgb(out, mode)


def _ppm_maxval(data: bytes) -> int:
    """A P2 / P5 header's maxval (an L image up to 255, I above)."""
    from .raster import _ppm_token
    _, pos = _ppm_token(data, 2)
    _, pos = _ppm_token(data, pos)
    return int(_ppm_token(data, pos)[0])


# ------------------------------------------ the plugins the port lacks ----
@_pillow_open
def open_gbr(fp):
    """GbrImageFile._open (its own decompression-bomb test included)."""
    header_size = _i32be(fp.read(4))
    if header_size < 20:
        raise SyntaxError("not a GIMP brush")
    version = _i32be(fp.read(4))
    if version not in (1, 2):
        raise SyntaxError(f"Unsupported GIMP brush version: {version}")
    width, height, depth = (_i32be(fp.read(4)) for _ in range(3))
    if width == 0 or height == 0:
        raise SyntaxError("not a GIMP brush")
    if depth not in (1, 4):
        raise SyntaxError(f"Unsupported GIMP brush color depth: {depth}")
    if version == 2:
        if fp.read(4) != b"GIMP":
            raise SyntaxError("not a GIMP brush, bad magic number")
        _i32be(fp.read(4))
    fp.read(header_size - (20 if version == 1 else 28))    # the comment
    mode, size = ("L" if depth == 1 else "RGBA"), (width, height)
    px = fp.read(width * height * depth)
    return mode, size, lambda: rawmode.to_rgb(
        rawmode.frombytes(px, size, mode), mode)


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


@_pillow_open
def open_imt(fp):
    """ImtImageFile._open: `key value` lines up to a form feed."""
    buffer = fp.read(100)
    if b"\n" not in buffer:
        raise SyntaxError("not an IM file")
    xsize = ysize = 0
    size, mode, offset = (0, 0), "", None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = fp.read(1)
        if not s:
            break
        if s == b"\x0c":
            offset = fp.tell() - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += fp.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            xsize = int(v)
            size = xsize, ysize
        elif k == b"height":
            ysize = int(v)
            size = xsize, ysize
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    if offset is None:
        return mode, size, _no_tile
    return mode, size, _raw_load(fp, offset, size, mode, mode)


class _Boxes:
    """Jpeg2KImagePlugin.BoxReader."""

    def __init__(self, fp, length=-1):
        self.fp, self.length = fp, length
        self.has_length = length >= 0
        self.remaining = -1

    def _can_read(self, n):
        if self.has_length and self.fp.tell() + n > self.length:
            return False
        return n <= self.remaining if self.remaining >= 0 else True

    def _read(self, n):
        if not self._can_read(n):
            raise SyntaxError("Not enough data in header")
        data = self.fp.read(n)
        if len(data) < n:
            raise OSError(f"Expected to read {n} bytes but only got "
                          f"{len(data)}.")
        if self.remaining > 0:
            self.remaining -= n
        return data

    def fields(self, fmt):
        return struct.unpack(fmt, self._read(struct.calcsize(fmt)))

    def sub(self):
        n = self.remaining
        return _Boxes(io.BytesIO(self._read(n)), n)

    def has_next(self):
        return self.fp.tell() + self.remaining < self.length \
            if self.has_length else True

    def next_type(self):
        if self.remaining > 0:
            self.fp.seek(self.remaining, os.SEEK_CUR)
        self.remaining = -1
        lbox, tbox = self.fields(">I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = self.fields(">Q")[0], 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise SyntaxError("Invalid header length")
        self.remaining = lbox - hlen
        return tbox


def _j2k_codestream(fp):
    """Jpeg2KImagePlugin._parse_codestream -> (size, mode)."""
    hdr = fp.read(2)
    siz = hdr + fp.read(_i16be(hdr) - 2)
    _, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _, csiz = struct.unpack_from(
        ">HHIIIIIIIIH", siz)
    if csiz == 1:
        mode = "I;16" if (struct.unpack_from(">B", siz, 38)[0] & 0x7F) + 1 \
            > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
    else:
        raise SyntaxError("unable to determine J2K image mode")
    return (xsiz - xosiz, ysiz - yosiz), mode


def _j2k_comment(fp):
    """Jpeg2KImageFile._parse_comment: the markers up to a COM segment."""
    while True:
        marker = fp.read(2)
        if not marker:
            break
        typ = marker[1]
        if typ in (0x90, 0xD9):
            break
        length = _i16be(fp.read(2))
        if typ == 0x64:
            fp.read(length - 2)
            break
        fp.seek(length - 2, os.SEEK_CUR)


def _jp2_header(fp):
    """Jpeg2KImagePlugin._parse_jp2_header -> (size, mode)."""
    reader = _Boxes(fp)
    header = None
    while reader.has_next():
        tbox = reader.next_type()
        if tbox == b"jp2h":
            header = reader.sub()
            break
        if tbox == b"ftyp":
            reader.fields(">4s")
    assert header is not None
    size = mode = nc = palette = None
    while header.has_next():
        tbox = header.next_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.fields(">IIHB")
            size = (width, height)
            if nc == 1:
                mode = "I;16" if (bpc & 0x7F) > 8 else "L"
            else:
                mode = {2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode)
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.fields(">HB")
            if max(header.fields(">" + "B" * npc), default=0) <= 8:
                palette = _jp2_palette(header, ne, npc)
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.sub()
            while res.has_next():
                if res.next_type() == b"resc":
                    res.fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise SyntaxError("Malformed JP2 header")
    return size, mode, palette


def _jp2_palette(header, ne, npc) -> np.ndarray:
    """ImagePalette.getcolor on each pclr entry (its refusals; a colour
    seen before adds nothing) -> the (n, 3) palette Pillow converts
    through."""
    pmode = 4 if npc == 4 else 3
    colors, length, raw = set(), 0, bytearray()
    for _ in range(ne):
        color = header.fields(">" + "B" * npc)
        if pmode == 3 and len(color) == 4:
            if color[3] != 255:
                raise ValueError("cannot add non-opaque RGBA color to RGB "
                                 "palette")
            color = color[:3]
        elif pmode == 4 and len(color) == 3:
            color += (255,)
        if color in colors:
            continue
        if length // pmode >= 256:
            raise ValueError("cannot allocate more than 256 colors")
        colors.add(color)
        length += len(color)
        raw += bytes(color)
    n = len(raw) // pmode
    return np.frombuffer(bytes(raw[:n * pmode]), np.uint8).reshape(
        n, pmode)[:, :3]


@_pillow_open
def open_jpeg2000(fp):
    """Jpeg2KImageFile._open: a raw codestream's SIZ segment, or a JP2
    file's boxes."""
    sig = fp.read(4)
    palette = None
    if sig == b"\xff\x4f\xff\x51":
        codec = "j2k"
        size, mode = _j2k_codestream(fp)
        _j2k_comment(fp)
    else:
        sig = sig + fp.read(8)
        if sig != b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a":
            raise SyntaxError("not a JPEG 2000 file")
        codec = "jp2"
        size, mode, palette = _jp2_header(fp)
        if fp.read(12).endswith(b"jp2c\xff\x4f\xff\x51"):
            fp.seek(_i16be(fp.read(2)) - 2, os.SEEK_CUR)
            _j2k_comment(fp)
    data = fp.getvalue()
    return mode, size, lambda: jpeg2000_load(data, codec, mode, size,
                                             palette)


def jpeg2000_load(data: bytes, codec: str, mode: str, size,
                  palette) -> np.ndarray:
    """Jpeg2KImageFile.load, then convert("RGB") (an ICNS entry's
    convert("RGBA") then "RGB" gives the same pixels)."""
    from .jpeg2000 import decode
    px = decode(data, codec, mode, size)
    if mode in ("LA", "PA"):
        px = px[..., [0, 3]]
    elif mode == "RGB":
        px = px[..., :3]
    return rawmode.to_rgb(px, mode, palette)


@_pillow_open
def open_mcidas(fp):
    """McIdasImageFile._open: the 256-byte area descriptor."""
    s = fp.read(256)
    if not s.startswith(b"\x00\x00\x00\x00\x00\x00\x00\x04") \
            or len(s) != 256:
        raise SyntaxError("not an McIdas area file")
    w = [0, *struct.unpack("!64i", s)]
    if w[11] not in (1, 2, 4):
        raise SyntaxError("unsupported McIdas format")
    mode, raw = {1: ("L", "L"), 2: ("I;16B", "I;16B"), 4: ("I", "I;32B")}[
        w[11]]
    size = w[10], w[9]
    return mode, size, _raw_load(fp, w[34] + w[15], size, mode, raw,
                                 w[15] + w[10] * w[11] * w[14])


@_pillow_open
def open_pcd(fp):
    """PcdImageFile._open: "PCD_" at 2,048 and the orientation byte."""
    fp.seek(2048)
    s = fp.read(1539)
    if not s.startswith(b"PCD_"):
        raise SyntaxError("not a PCD file")
    orientation = s[1538] & 3
    size = (512, 768) if orientation in (1, 3) else (768, 512)
    data = fp.getvalue()
    return "RGB", size, lambda: _pcd_load(data, orientation)


def _pcd_load(data: bytes, orientation: int) -> np.ndarray:
    """Pillow's pcd decoder (PcdDecode.c) on the 768 x 512 base image at
    96 * 2,048: per two rows, their 768 lumas each, then 384 Cb and 384
    Cr shared by the pair, PhotoYCC through the "YCC;P" unpacker; then
    load_end's rotation by the orientation byte."""
    start = 96 * 2048
    if start + 256 * 2304 > len(data):
        raise OSError("image file is truncated")
    chunk = np.frombuffer(data, np.uint8, 256 * 2304, start) \
        .reshape(256, 2304)
    y = chunk[:, :1536].reshape(512, 768)
    half = np.arange(768) // 2
    cb = np.repeat(chunk[:, 1536 + half], 2, 0)
    cr = np.repeat(chunk[:, 1920 + half], 2, 0)
    img = rawmode.photoycc_to_rgb(np.stack([y, cb, cr], -1))
    if orientation == 1:
        img = np.rot90(img, 1)
    elif orientation == 3:
        img = np.rot90(img, -1)
    return np.ascontiguousarray(img)


@_pillow_open
def open_pixar(fp):
    """PixarImageFile._open: the size at 416 and the mode at 424 (RGB
    only)."""
    s = fp.read(4)
    if not s.startswith(b"\200\350\000\000"):
        raise SyntaxError("not a PIXAR file")
    s = s + fp.read(508)
    size = _i16(s, 418), _i16(s, 416)
    mode = "RGB" if (_i16(s, 424), _i16(s, 426)) == (14, 2) else ""
    return mode, size, _raw_load(fp, 1024, size, mode, mode)


def _spider_header(t) -> int:
    """SpiderImagePlugin.isSpiderHeader."""
    h = (99,) + t

    def is_int(f):
        try:
            return f - int(f) == 0
        except (ValueError, OverflowError):
            return False

    if not all(is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labbyt = int(h[22])
    return labbyt if labbyt == int(h[13]) * int(h[23]) else 0


@_pillow_open
def open_spider(fp):
    """SpiderImageFile._open: 27 floats, big- then little-endian."""
    f = fp.read(108)
    try:
        raw = "F;32BF"
        t = struct.unpack(">27f", f)
        hdrlen = _spider_header(t)
        if not hdrlen:
            raw = "F;32F"
            t = struct.unpack("<27f", f)
            hdrlen = _spider_header(t)
        if not hdrlen:
            raise SyntaxError("not a valid Spider file")
    except struct.error as e:
        raise SyntaxError("not a valid Spider file") from e
    h = (99,) + t
    if int(h[5]) != 1:
        raise SyntaxError("not a Spider 2D image")
    size = int(h[12]), int(h[2])
    istack, imgnumber = int(h[24]), int(h[27])
    offset = hdrlen
    if istack > 0 and imgnumber == 0:
        int(h[26])
        offset = hdrlen * 2
    elif istack == 0 and imgnumber > 0:
        # Pillow reads self.stkoffset before it is set
        raise AttributeError(
            "'SpiderImageFile' object has no attribute 'stkoffset'")
    elif not (istack == 0 and imgnumber == 0):
        raise SyntaxError("inconsistent stack header values")
    return "F", size, _raw_load(fp, offset, size, "F", raw)


# XVThumbImagePlugin.PALETTE: 3-3-2 bits of red, green and blue
_XV_PALETTE = np.array([(r * 255 // 7, g * 255 // 7, b * 255 // 3)
                        for r in range(8) for g in range(8)
                        for b in range(4)], np.uint8)


@_pillow_open
def open_xvthumb(fp):
    """XVThumbImageFile._open: the comment lines, then `width height`."""
    if not fp.read(6).startswith(b"P7 332"):
        raise SyntaxError("not an XV thumbnail file")
    fp.readline()
    while True:
        s = fp.readline()
        if not s:
            raise SyntaxError("Unexpected EOF reading XV thumbnail file")
        if s[0] != 35:
            break
    w, h = s.strip().split(maxsplit=2)[:2]
    return "P", (int(w), int(h)), _raw_load(fp, fp.tell(), (int(w), int(h)),
                                            "P", "P", palette=_XV_PALETTE)
