"""The header checks of the Pillow 12.1 plugins whose pixels the port does
not decode, for io/image.py's walk over Pillow's registry.

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
  handler on this platform, raise "cannot find loader"; an MPEG file, or
  an IPTC record without image data, has no tile ("cannot load this
  image"); an EPS file goes through Ghostscript as Pillow runs it (the
  same command line, the page read back by io/raster.py), or raises
  Pillow's OSError where there is no `gs`.
- A file that Pillow opens and decodes raises NotImplementedError (ROADMAP
  Queue 1 M9): the port does not decode FITS, FLI, GBR, ICNS, IMT, IPTC,
  JPEG 2000, McIdas, PCD, PIXAR, SPIDER or XV thumbnails yet.
"""
from __future__ import annotations

import io
import math
import os
import re
import struct
import subprocess
import tempfile

from ..errors import not_ported

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


def _not_ported(fmt):
    """A file Pillow opens (and decodes) that the port does not decode."""
    def load():
        raise not_ported(f"{fmt} image files", "Queue 1 M9")
    return load


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


@_pillow_open
def open_iptc(fp):
    """IptcImageFile._open: the fields up to the image data (8:10), then
    the image's layers (3:60), size (3:20, 3:30) and compression (3:120).
    Without 8:10 the file opens with no tile."""
    info = {}
    tag = None
    while True:
        s = fp.read(5)
        if not s.strip(b"\x00"):
            tag, size = None, 0
        else:
            tag = s[1], s[2]
            if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9,
                                              240):
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
    mode = ""
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        if (3, 65) in info:
            info[(3, 65)][0] - 1
    size = _iptc_i(info[(3, 20)]), _iptc_i(info[(3, 30)])
    try:
        {1: "raw", 5: "jpeg"}[_iptc_i(info[(3, 120)])]
    except KeyError as e:
        raise OSError("Unknown IPTC image compression") from e
    return mode, size, _not_ported("IPTC") if tag == (8, 10) else _no_tile


# ------------------------------------------ the plugins the port lacks ----
@_pillow_open
def open_fits(fp):
    """FitsImageFile._open: 80-byte header cards to the first header with
    an image (NAXIS, BITPIX; a GZIP_1-compressed BINTABLE extension)."""
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
                found = _fits_headers(headers)
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
    return found[0], found[1], _not_ported("FITS")


def _fits_headers(headers):
    """FitsImageFile._parse_headers -> (mode, size) or None."""
    def get_size(prefix):
        naxis = int(headers[prefix + b"NAXIS"])
        if naxis == 0:
            return None
        if naxis == 1:
            return 1, int(headers[prefix + b"NAXIS1"])
        return (int(headers[prefix + b"NAXIS1"]),
                int(headers[prefix + b"NAXIS2"]))

    prefix = b""
    if headers.get(b"XTENSION") == b"'BINTABLE'" \
            and headers.get(b"ZIMAGE") == b"T" \
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '":
        get_size(prefix)
        int(headers[b"BITPIX"])
        prefix = b"Z"
    size = get_size(prefix)
    if not size:
        return None
    bits = int(headers[prefix + b"BITPIX"])
    mode = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}.get(bits, "")
    return mode, size


@_pillow_open
def open_fli(fp):
    """FliImageFile._open: the header's zero fields, the first frame's
    palette chunk, then seek(0)'s frame size."""
    s = fp.read(128)
    if not (len(s) >= 16 and _i16(s, 4) in (0xAF11, 0xAF12)
            and _i16(s, 14) in (0, 3) and s[20:22] == b"\x00" * 2
            and s[42:80] == b"\x00" * 38 and s[88:] == b"\x00" * 40):
        raise SyntaxError("not an FLI/FLC file")
    n_frames = _i16(s, 6)
    size = _i16(s, 8), _i16(s, 10)
    palette = [(a, a, a) for a in range(256)]
    s = fp.read(16)
    if _i16(s, 4) == 0xF100:
        fp.seek(128 + _i32(s))
        s = fp.read(16)
    if _i16(s, 4) == 0xF1FA:
        chunk_size = None
        for _ in range(_i16(s, 6)):
            if chunk_size is not None:
                fp.seek(chunk_size - 6, os.SEEK_CUR)
            s = fp.read(6)
            if _i16(s, 4) in (4, 11):
                i = 0
                for _ in range(_i16(fp.read(2))):
                    s = fp.read(2)
                    i = i + s[0]
                    n = s[1] or 256
                    s = fp.read(n * 3)
                    for n in range(0, len(s), 3):
                        palette[i] = (s[n], s[n + 1], s[n + 2])
                        i += 1
                break
            chunk_size = _i32(s)
            if not chunk_size:
                break
    if n_frames <= 0:
        raise EOFError("attempt to seek outside sequence")
    fp.seek(128)
    if not fp.read(4):
        raise EOFError("missing frame size")
    return "P", size, _not_ported("FLI")


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
    return ("L" if depth == 1 else "RGBA"), (width, height), \
        _not_ported("GBR")


# IcnsFile.SIZES: (width, height, scale) -> the resource types it reads
_ICNS_SIZES = {
    (512, 512, 2): (b"ic10",), (512, 512, 1): (b"ic09",),
    (256, 256, 2): (b"ic14",), (256, 256, 1): (b"ic08",),
    (128, 128, 2): (b"ic13",), (128, 128, 1): (b"ic07", b"it32", b"t8mk"),
    (64, 64, 1): (b"icp6",), (32, 32, 2): (b"ic12",),
    (48, 48, 1): (b"ih32", b"h8mk"), (32, 32, 1): (b"icp5", b"il32", b"l8mk"),
    (16, 16, 2): (b"ic11",), (16, 16, 1): (b"icp4", b"is32", b"s8mk")}


@_pillow_open
def open_icns(fp):
    """IcnsImageFile._open: the resource headers, then the largest size
    with a resource Pillow reads."""
    sig, filesize = struct.unpack(">4sI", fp.read(8))
    if not sig.startswith(b"icns"):
        raise SyntaxError("not an icns file")
    found = set()
    i = 8
    while i < filesize:
        sig, blocksize = struct.unpack(">4sI", fp.read(8))
        if blocksize <= 0:
            raise SyntaxError("invalid block header")
        i += 8
        blocksize -= 8
        found.add(sig)
        fp.seek(blocksize, io.SEEK_CUR)
        i += blocksize
    sizes = [s for s, kinds in _ICNS_SIZES.items() if found & set(kinds)]
    if not sizes:
        raise SyntaxError("No 32bit icon resources found")
    w, h, scale = max(sizes)
    return "RGBA", (w * scale, h * scale), _not_ported("ICNS")


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


@_pillow_open
def open_imt(fp):
    """ImtImageFile._open: `key value` lines up to a form feed."""
    buffer = fp.read(100)
    if b"\n" not in buffer:
        raise SyntaxError("not an IM file")
    xsize = ysize = 0
    size, mode = (0, 0), ""
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = fp.read(1)
        if not s or s == b"\x0c":
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
    return mode, size, _not_ported("IMT")


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
    size = mode = nc = None
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
                _jp2_palette(header, ne, npc)
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.sub()
            while res.has_next():
                if res.next_type() == b"resc":
                    res.fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise SyntaxError("Malformed JP2 header")
    return size, mode


def _jp2_palette(header, ne, npc):
    """ImagePalette.getcolor on each pclr entry: its refusals."""
    pmode = 4 if npc == 4 else 3
    colors, length = set(), 0
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


@_pillow_open
def open_jpeg2000(fp):
    """Jpeg2KImageFile._open: a raw codestream's SIZ segment, or a JP2
    file's boxes."""
    sig = fp.read(4)
    if sig == b"\xff\x4f\xff\x51":
        size, mode = _j2k_codestream(fp)
        _j2k_comment(fp)
    else:
        sig = sig + fp.read(8)
        if sig != b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a":
            raise SyntaxError("not a JPEG 2000 file")
        size, mode = _jp2_header(fp)
        if fp.read(12).endswith(b"jp2c\xff\x4f\xff\x51"):
            fp.seek(_i16be(fp.read(2)) - 2, os.SEEK_CUR)
            _j2k_comment(fp)
    return mode, size, _not_ported("JPEG 2000")


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
    return {1: "L", 2: "I;16B", 4: "I"}[w[11]], (w[10], w[9]), \
        _not_ported("McIdas")


@_pillow_open
def open_pcd(fp):
    """PcdImageFile._open: "PCD_" at 2,048 and the orientation byte."""
    fp.seek(2048)
    s = fp.read(1539)
    if not s.startswith(b"PCD_"):
        raise SyntaxError("not a PCD file")
    size = (512, 768) if s[1538] & 3 in (1, 3) else (768, 512)
    return "RGB", size, _not_ported("PCD")


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
    return mode, size, _not_ported("PIXAR")


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
        t = struct.unpack(">27f", f)
        if not _spider_header(t):
            t = struct.unpack("<27f", f)
            if not _spider_header(t):
                raise SyntaxError("not a valid Spider file")
    except struct.error as e:
        raise SyntaxError("not a valid Spider file") from e
    h = (99,) + t
    if int(h[5]) != 1:
        raise SyntaxError("not a Spider 2D image")
    size = int(h[12]), int(h[2])
    istack, imgnumber = int(h[24]), int(h[27])
    if istack > 0 and imgnumber == 0:
        int(h[26])
    elif istack == 0 and imgnumber > 0:
        # Pillow reads self.stkoffset before it is set
        raise AttributeError(
            "'SpiderImageFile' object has no attribute 'stkoffset'")
    elif not (istack == 0 and imgnumber == 0):
        raise SyntaxError("inconsistent stack header values")
    return "F", size, _not_ported("SPIDER")


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
    return "P", (int(w), int(h)), _not_ported("XV thumbnail")
