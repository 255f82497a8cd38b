"""TIFF images, read and written as the JAX package reads and writes them
through Pillow (`Image.open(path).convert("RGB")`, `Image.fromarray(px)
.save(path)`), with numpy, zlib, lzma and the C++ loops of io/lzw.py,
io/tiff_fax.py and io/zstd.py.

Reading takes the first IFD, as Pillow does: II and MM byte order,
classic TIFF and BigTIFF; strips and tiles (edge tiles padded, tiles that
start inside a byte placed pixel by pixel); PlanarConfiguration 1 and 2;
every compression of Pillow's COMPRESSION_INFO as its libtiff 4.7 reads
it: none, PackBits, LZW (and libtiff's old style, chosen by the first
strip), Deflate (8 and 32946), LZMA, ZSTD, CCITT fax (2, 3, 4, 32771),
ThunderScan, JPEG (6, 7); SGILog and WebP fail at load as there.
libtiff's predictors (2 at 8, 16 and 32 bits, 3 on floats; its
PredictorSetup refuses the rest); photometric min-is-white, min-is-black,
RGB, palette and CMYK at 1, 2, 4, 8, 12, 16 and 32 bits per sample;
ExtraSamples (associated alpha is divided out as Pillow's "RGBa"
unpacker does); FillOrder 2; the Orientation tag applied as Pillow's
exif_transpose applies it.  Pillow's mode table (TiffImagePlugin.
OPEN_INFO) decides which layouts open, and its conversions give the RGB
bytes: 16-bit grey clips to 255, signed and 32-bit integers clip to
0..255, floats truncate and clip, CMYK goes through Pillow's cmyk2rgb.
Uncompressed files go through Pillow's raw decoder (its strides, its
one-letter rawmodes for separate planes, the rawmodes it lacks);
compressed files through libtiff in Pillow, which hands samples over in
the host's (little-endian) order: 16-bit rawmodes are re-read natively,
32-bit ones are not (a big-endian compressed float or 32-bit integer file
reads byte-swapped there, and here), and TiffDecode.c's tile-size test
refuses some narrow tiles.  JPEG-in-TIFF (compression 7 and 6) and YCbCr
files are read by io/tiff_ycbcr.py as libtiff reads them for Pillow; an
uncompressed YCbCr file goes through Pillow's raw "RGBX" unpacker as
Pillow sends it.  CIELab (mode "LAB") is converted as Pillow converts it
through LittleCMS (io/cielab.py).

`open_tiff` raises SyntaxError where Pillow's plugin gives the file up
(the caller then tries the next format, as Image.open does), and
OSError / ValueError where Pillow raises them.
"""
from __future__ import annotations

import lzma
import struct
import zlib

import numpy as np

from . import cielab, lzw, tiff_fax, tiff_ycbcr, zstd
from .rawmode import cmyk_to_rgb, float_to_grey

PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
            b"MM\x00\x2b", b"II\x2b\x00")

# tags
WIDTH, LENGTH, BPS, COMPRESSION, PHOTOMETRIC, FILLORDER = \
    256, 257, 258, 259, 262, 266
STRIP_OFFSETS, ORIENTATION, SPP, ROWS_PER_STRIP, STRIP_COUNTS = \
    273, 274, 277, 278, 279
PLANAR, T4OPTIONS, PREDICTOR, COLORMAP = 284, 292, 317, 320
TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_COUNTS = 322, 323, 324, 325
EXTRA, SAMPLE_FORMAT = 338, 339
# tags whose value Pillow's tag_v2 returns as a scalar (TiffTags length 1)
_SCALAR = {WIDTH, LENGTH, COMPRESSION, PHOTOMETRIC, FILLORDER, ORIENTATION,
           SPP, ROWS_PER_STRIP, PLANAR, PREDICTOR, TILE_WIDTH, TILE_LENGTH}
# tag type -> (struct code, size)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("L", 4), 5: ("LL", 8),
          6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("l", 4), 10: ("ll", 8),
          11: ("f", 4), 12: ("d", 8), 13: ("L", 4), 16: ("Q", 8),
          17: ("q", 8), 18: ("Q", 8)}

_COMPRESSIONS = {1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4",
                 5: "tiff_lzw", 6: "tiff_jpeg", 7: "jpeg",
                 8: "tiff_adobe_deflate", 32771: "tiff_raw_16",
                 32773: "packbits", 32809: "tiff_thunderscan",
                 32946: "tiff_deflate", 34676: "tiff_sgilog",
                 34677: "tiff_sgilog24", 34925: "lzma", 50000: "zstd",
                 50001: "webp"}
# what this libtiff cannot decode for any layout Pillow opens: SGILog needs
# photometric LogL or LogLuv (Pillow's mode table has neither), and WebP
# support is not configured
_UNDECODABLE = {"tiff_sgilog", "tiff_sgilog24", "webp"}
_FAX = {"tiff_ccitt": 2, "group3": 3, "group4": 4, "tiff_raw_16": 32771}
# the codecs that run libtiff's predictors (TIFFPredictorInit)
_PREDICTED = {"tiff_lzw", "tiff_adobe_deflate", "tiff_deflate", "lzma",
              "zstd"}


def _open_info() -> dict:
    """Pillow 12's OPEN_INFO: (byte order, photometric, sample format,
    fill order, bits per sample, extra samples) -> (mode, rawmode)."""
    both, ii = ("II", "MM"), ("II",)
    rows = [
        (0, (1,), 1, (1,), (), "1", "1;I"), (0, (1,), 2, (1,),
        (), "1", "1;IR"),
        (1, (1,), 1, (1,), (), "1", "1"), (1, (1,), 2, (1,), (), "1", "1;R"),
        (0, (1,), 1, (2,), (), "L", "L;2I"),
        (0, (1,), 2, (2,), (), "L", "L;2IR"),
        (1, (1,), 1, (2,), (), "L", "L;2"), (1, (1,), 2, (2,),
        (), "L", "L;2R"),
        (0, (1,), 1, (4,), (), "L", "L;4I"),
        (0, (1,), 2, (4,), (), "L", "L;4IR"),
        (1, (1,), 1, (4,), (), "L", "L;4"), (1, (1,), 2, (4,),
        (), "L", "L;4R"),
        (0, (1,), 1, (8,), (), "L", "L;I"), (0, (1,), 2, (8,),
        (), "L", "L;IR"),
        (1, (1,), 1, (8,), (), "L", "L"), (1, (2,), 1, (8,), (), "L", "L"),
        (1, (1,), 2, (8,), (), "L", "L;R"),
        (1, (2,), 1, (16,), (), "I", None), (0, (3,), 1, (32,), (), "F", None),
        (1, (2,), 1, (32,), (), "I", None), (1, (3,), 1, (32,), (), "F", None),
        (1, (1,), 1, (8, 8), (2,), "LA", "LA"),
        (2, (1,), 1, (8, 8, 8), (), "RGB", "RGB"),
        (2, (1,), 2, (8, 8, 8), (), "RGB", "RGB;R"),
        (2, (1,), 1, (8, 8, 8, 8), (), "RGBA", "RGBA"),
        (2, (1,), 1, (8,) * 4, (0,), "RGB", "RGBX"),
        (2, (1,), 1, (8,) * 5, (0, 0), "RGB", "RGBXX"),
        (2, (1,), 1, (8,) * 6, (0, 0, 0), "RGB", "RGBXXX"),
        (2, (1,), 1, (8,) * 4, (1,), "RGBA", "RGBa"),
        (2, (1,), 1, (8,) * 5, (1, 0), "RGBA", "RGBaX"),
        (2, (1,), 1, (8,) * 6, (1, 0, 0), "RGBA", "RGBaXX"),
        (2, (1,), 1, (8,) * 4, (2,), "RGBA", "RGBA"),
        (2, (1,), 1, (8,) * 5, (2, 0), "RGBA", "RGBAX"),
        (2, (1,), 1, (8,) * 6, (2, 0, 0), "RGBA", "RGBAXX"),
        (2, (1,), 1, (8,) * 4, (999,), "RGBA", "RGBA"),
        (2, (1,), 1, (16,) * 3, (), "RGB", "RGB;16"),
        (2, (1,), 1, (16,) * 4, (), "RGBA", "RGBA;16"),
        (2, (1,), 1, (16,) * 4, (0,), "RGB", "RGBX;16"),
        (2, (1,), 1, (16,) * 4, (1,), "RGBA", "RGBa;16"),
        (2, (1,), 1, (16,) * 4, (2,), "RGBA", "RGBA;16"),
        (3, (1,), 1, (1,), (), "P", "P;1"), (3, (1,), 2, (1,),
        (), "P", "P;1R"),
        (3, (1,), 1, (2,), (), "P", "P;2"), (3, (1,), 2, (2,),
        (), "P", "P;2R"),
        (3, (1,), 1, (4,), (), "P", "P;4"), (3, (1,), 2, (4,),
        (), "P", "P;4R"),
        (3, (1,), 1, (8,), (), "P", "P"), (3, (1,), 2, (8,), (), "P", "P;R"),
        (3, (1,), 1, (8, 8), (0,), "P", "PX"),
        (3, (1,), 1, (8, 8), (2,), "PA", "PA"),
        (5, (1,), 1, (8,) * 4, (), "CMYK", "CMYK"),
        (5, (1,), 1, (8,) * 5, (0,), "CMYK", "CMYKX"),
        (5, (1,), 1, (8,) * 6, (0, 0), "CMYK", "CMYKXX"),
        (5, (1,), 1, (16,) * 4, (), "CMYK", "CMYK;16"),
        (6, (1,), 1, (8,), (), "L", "L"),
        (6, (1,), 1, (8, 8, 8), (), "RGB", "RGBX"),
        (8, (1,), 1, (8, 8, 8), (), "LAB", "LAB"),
    ]
    table = {}
    for photo, fmt, fill, bps, extra, mode, raw in rows:
        for order in both:
            if raw is None:          # signed / 32-bit / float: by order
                raw = {("I", 16): "I;16S", ("I", 32): "I;32S",
                       ("F", 32): "F;32F"}[(mode, bps[0])]
                raw_mm = {"I;16S": "I;16BS", "I;32S": "I;32BS",
                          "F;32F": "F;32BF"}[raw]
                table[("II", photo, fmt, fill, bps, extra)] = (mode, raw)
                table[("MM", photo, fmt, fill, bps, extra)] = (mode, raw_mm)
                raw = None
                break
            r = raw + ("L" if order == "II" else "B") \
                if raw.endswith(";16") else raw
            table[(order, photo, fmt, fill, bps, extra)] = (mode, r)
    # the little-endian-only rows
    for key, val in {(1, (1,), 1, (12,), ()): ("I;16", "I;12"),
                     (0, (1,), 1, (16,), ()): ("I;16", "I;16"),
                     (1, (1,), 1, (16,), ()): ("I;16", "I;16"),
                     (1, (1,), 2, (16,), ()): ("I;16", "I;16R"),
                     (1, (1,), 1, (32,), ()): ("I", "I;32N")}.items():
        for order in ii:
            table[(order,) + key] = val
    table[("MM", 1, (1,), 1, (16,), ())] = ("I;16B", "I;16B")
    return table


OPEN_INFO = _open_info()


# ------------------------------------------------------------------ IFD ----
class _Ifd(dict):
    """tag -> tuple of values of the first IFD, as Pillow's
    ImageFileDirectory_v2 loads it; `get` unwraps Pillow's scalar tags."""

    def __init__(self, data: bytes):
        super().__init__()
        self.prefix = data[:2].decode()
        # Pillow tests byte 2 only: a big-endian BigTIFF reads as classic
        self.bigtiff = data[2] == 43
        e = "<" if self.prefix == "II" else ">"
        if self.bigtiff:
            off = struct.unpack(e + "Q", data[8:16])[0]
            cnt_fmt, ent, inline = "Q", 20, 8
        else:
            off = struct.unpack(e + "L", data[4:8])[0]
            cnt_fmt, ent, inline = "H", 12, 4
        head = struct.calcsize(cnt_fmt)
        if off + head > len(data):
            raise SyntaxError("not a TIFF file (no IFD)")
        n = struct.unpack(e + cnt_fmt, data[off:off + head])[0]
        pos = off + head
        for _ in range(n):
            raw = data[pos:pos + ent]
            pos += ent
            if len(raw) < ent:
                raise SyntaxError("not a TIFF file (truncated IFD)")
            if self.bigtiff:
                tag, typ, count = struct.unpack(e + "HHQ", raw[:12])
                val = raw[12:20]
            else:
                tag, typ, count = struct.unpack(e + "HHL", raw[:8])
                val = raw[8:12]
            if typ not in _TYPES:
                continue                 # Pillow warns and skips the tag
            code, size = _TYPES[typ]
            nbytes = size * count
            if nbytes > inline:
                at = struct.unpack(e + ("Q" if self.bigtiff else "L"),
                                   val)[0]
                if at + nbytes > len(data):
                    continue             # "possibly corrupt EXIF data"
                val = data[at:at + nbytes]
            else:
                val = val[:nbytes]
            if typ in (2, 7):
                self[tag] = (val,)
                continue
            k = len(code)
            vals = struct.unpack(e + code[0] * (count * k), val)
            if k == 2:
                vals = tuple(a / b if b else float("nan")
                             for a, b in zip(vals[::2], vals[1::2]))
            self[tag] = vals

    def get(self, tag, default=None):
        if tag not in self:
            return default
        v = self[tag]
        return v[0] if tag in _SCALAR and len(v) else v


# ---------------------------------------------------------------- codecs ----
def _packbits(src: bytes, occ: int) -> bytes:
    out = bytearray()
    i, n = 0, len(src)
    while i < n and len(out) < occ:
        c = src[i]
        i += 1
        if c < 128:
            out += src[i:i + c + 1]
            i += c + 1
        elif c > 128:
            if i >= n:
                break
            out += src[i:i + 1] * (257 - c)
            i += 1
    return bytes(out)


class _Codec:
    """libtiff's codec of one image as Pillow's strip or tile loop drives
    it, with the state it keeps from one strip or tile to the next: LZW's
    old style (LZWPreDecode decides it on the first strip or tile read, for
    all of them), the fax run arrays and Pillow's strip buffer, which a
    strip that ends early leaves as it was."""

    def __init__(self, L, tags):
        self.kind = L["kind"]
        self.lzw_compat = None
        self.fax = None
        self.width = L["xsize"]
        # Pillow's strip (tile) buffer, which a codec may leave partly
        # unwritten
        self.buffer = np.zeros((L["w"] * sum(L["bps"]) + 7) // 8 * L["h"],
                               np.uint8)
        if self.kind == "tiff_thunderscan" and L["bps"][0] != 4:
            raise OSError("decoder error -2")     # ThunderSetupDecode
        if self.kind in _FAX:
            if L["bps"][0] != 1 or (len(L["bps"]) != 1 and L["planar"] == 1):
                raise OSError("decoder error -2")     # Fax3SetupState
            rowpixels = L["w"]
            kind = tiff_fax.decoder_kind(_FAX[self.kind],
                                         int((tags.get(T4OPTIONS) or (0,))[0]))
            self.fax = dict(kind=kind, rowpixels=rowpixels,
                            rowbytes=(rowpixels + 7) // 8,
                            runs=np.zeros(2 * tiff_fax.nruns(rowpixels, kind),
                                          np.uint32),
                            flags=np.zeros(1, np.int32),
                            lsb_first=L["fill"] == 2)

    def __call__(self, src: bytes, occ: int, offset: int) -> bytes:
        """One compressed strip or tile (at `offset` in the file) -> occ
        bytes, or OSError as Pillow's libtiff decoder raises on a short or
        broken one."""
        kind = self.kind
        if self.fax is not None:
            f = self.fax
            rows = occ // f["rowbytes"]
            if tiff_fax.decode(src, f["kind"], rows, f["rowpixels"],
                               f["rowbytes"], f["lsb_first"], offset & 1,
                               f["runs"], self.buffer, f["flags"]) < 0:
                raise OSError("decoder error -2")
            return self.buffer[:occ].tobytes()
        if kind == "tiff_thunderscan":
            scan = (self.width * 4 + 7) // 8        # tif_scanlinesize
            if occ % scan:
                raise OSError("decoder error -2")
            cp = 0
            for row in range(occ // scan):
                cp = _thunderscan_row(src, cp, self.buffer, row * scan,
                                      self.width)
            return self.buffer[:occ].tobytes()
        if kind == "tiff_lzw":
            if self.lzw_compat is None:                # libtiff's test
                self.lzw_compat = len(src) >= 2 and src[0] == 0 \
                    and bool(src[1] & 1)
            try:
                out = lzw.lzw_tiff(src, occ, self.lzw_compat)
            except ValueError as err:
                raise OSError("decoder error -2") from err
        elif kind == "packbits":
            out = _packbits(src, occ)
        elif kind == "lzma":
            try:
                out = lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(src,
                                                                       occ)
            except lzma.LZMAError as err:
                raise OSError("decoder error -2") from err
        elif kind == "zstd":
            out = zstd.decode_tiff(src, occ)
        else:
            try:
                out = zlib.decompressobj().decompress(src, occ)
            except zlib.error as err:
                raise OSError("decoder error -2") from err
        if len(out) < occ:
            raise OSError("decoder error -2")
        return out


def _thunderscan_row(src: bytes, cp: int, out: np.ndarray, op: int,
                     maxpixels: int) -> int:
    """tif_thunder.c's ThunderDecode: one row of 4-bit pixels from src[cp:]
    into out[op:] -> the next code's position, or OSError where the codes
    do not give the row exactly `maxpixels` pixels."""
    last = npixels = 0

    def setpixel(v):
        nonlocal last, npixels, op
        last = v & 15
        if npixels < maxpixels:
            if npixels & 1:
                out[op] |= last
                op += 1
            else:
                out[op] = last << 4
            npixels += 1

    while cp < len(src) and npixels < maxpixels:
        n = src[cp]
        cp += 1
        code = n & 0xC0
        if code == 0x00:                     # a run of the last pixel
            if npixels & 1:
                out[op] |= last
                last = int(out[op])
                op += 1
                npixels += 1
                n -= 1
            else:
                last |= last << 4
            npixels += n
            if npixels <= maxpixels:
                while n > 0:
                    out[op] = last
                    op += 1
                    n -= 2
            if n == -1:
                op -= 1
                out[op] &= 0xF0
            last &= 15
        elif code == 0x40:                   # three 2-bit deltas
            for shift in (4, 2, 0):
                d = (n >> shift) & 3
                if d != 2:
                    setpixel(last + (0, 1, 0, -1)[d])
        elif code == 0x80:                   # two 3-bit deltas
            for shift in (3, 0):
                d = (n >> shift) & 7
                if d != 4:
                    setpixel(last + (0, 1, 2, 3, 0, -3, -2, -1)[d])
        else:                                # a raw pixel
            setpixel(n)
    if npixels != maxpixels:
        raise OSError("decoder error -2")
    return cp


def _predictor_setup(predictor: int, bps: int, sample_format: int) -> int:
    """libtiff's PredictorSetup: the predictor, or OSError where it fails
    (Pillow's decoder error)."""
    if predictor == 1:
        return 1
    if predictor == 2 and bps in (8, 16, 32, 64):
        return 2
    if predictor == 3 and sample_format == 3 and bps in (16, 24, 32, 64):
        return 3
    raise OSError("decoder error -2")


# each byte with its bits in reverse order (FillOrder 2)
_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                     np.uint8)


def _predict(buf: bytes, predictor: int, rows: int, width: int, stride: int,
             bps: int, order: str) -> bytes:
    """libtiff's decode side of the predictors on one strip or tile of
    `rows` rows of `width` pixels of `stride` samples: the result is in
    the host's (little-endian) byte order, as libtiff hands it over."""
    if predictor == 2:
        dt = {8: "u1", 16: "u2", 32: "u4"}[bps]
        src = np.frombuffer(buf, (">" if order == "MM" else "<") + dt)
        a = src.reshape(rows, width, stride).astype(np.uint64)
        a = np.cumsum(a, axis=1) & ((1 << bps) - 1)
        return a.astype("<" + dt).tobytes()
    if predictor == 3:
        nb = bps // 8
        # one running sum over the row's bytes (all byte planes) at the
        # pixel's sample stride
        a = np.frombuffer(buf, np.uint8).reshape(rows, -1, stride)
        acc = (np.cumsum(a.astype(np.uint32), axis=1) & 255) \
            .astype(np.uint8).reshape(rows, nb, width * stride)
        # byte planes, most significant first -> little-endian words
        return np.ascontiguousarray(acc[:, ::-1, :].transpose(0, 2, 1)) \
            .tobytes()
    if bps in (16, 32) and order == "MM":       # libtiff's swab
        dt = ">u2" if bps == 16 else ">u4"
        return np.frombuffer(buf, dt).astype(dt.replace(">", "<")).tobytes()
    return buf


# ---------------------------------------------------------------- reader ----
def open_tiff(data: bytes):
    """Read the first IFD's header as Pillow's TiffImageFile._open and
    _setup do -> a function that decodes it to (H, W, 3) uint8."""
    if not data.startswith(PREFIXES):
        raise SyntaxError("not a TIFF file")
    tags = _Ifd(data)
    if 0xBC01 in tags:
        raise OSError("Windows Media Photo files not yet supported")
    cnum = tags.get(COMPRESSION, 1)
    if cnum not in _COMPRESSIONS:
        raise SyntaxError(f"unknown compression {cnum}")   # a KeyError
    kind = _COMPRESSIONS[cnum]
    planar = tags.get(PLANAR, 1)
    photo = tags.get(PHOTOMETRIC, 0)
    if kind == "tiff_jpeg":
        photo = 6
    fill = tags.get(FILLORDER, 1)
    if WIDTH not in tags or LENGTH not in tags:
        raise SyntaxError("Missing dimensions")
    xsize, ysize = tags.get(WIDTH), tags.get(LENGTH)
    if not isinstance(xsize, int) or not isinstance(ysize, int):
        raise ValueError("Invalid dimensions")
    fmt = tags.get(SAMPLE_FORMAT, (1,))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bps = tags.get(BPS, (1,))
    extra = tags.get(EXTRA, ())
    count = {2: 3, 6: 3, 8: 3, 5: 4}.get(photo, 1) + len(extra)
    spp = tags.get(SPP, 3 if kind == "tiff_jpeg" and photo in (2, 6) else 1)
    if spp > 6:
        raise SyntaxError("Invalid value for samples per pixel")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise SyntaxError("unknown data organization")
    key = (tags.prefix, photo, fmt, fill, bps, extra)
    if key not in OPEN_INFO:
        raise SyntaxError("unknown pixel mode")
    mode, rawmode = OPEN_INFO[key]
    libtiff = kind != "raw"
    if libtiff:
        if fill == 2:
            mode, rawmode = OPEN_INFO[key[:3] + (1,) + key[4:]]
        if rawmode == "I;16" or rawmode.endswith((";16B", ";16L")):
            rawmode = "I;16N" if rawmode == "I;16" else rawmode[:-1] + "N"
        if planar == 2 and mode == "RGBA" and not extra:
            # TiffDecode.c unpacks a separate-plane RGBA image with no
            # ExtraSamples tag as associated alpha
            rawmode = "RGBa" + rawmode[4:]
    if STRIP_OFFSETS in tags:
        offsets = tags.get(STRIP_OFFSETS)
        counts = tags.get(STRIP_COUNTS, ())
        h = tags.get(ROWS_PER_STRIP, ysize)
        w = xsize
        tiled = False
    elif TILE_OFFSETS in tags:
        offsets = tags.get(TILE_OFFSETS)
        counts = tags.get(TILE_COUNTS, ())
        w, h = tags.get(TILE_WIDTH), tags.get(TILE_LENGTH)
        if not isinstance(w, int) or not isinstance(h, int):
            raise ValueError("Invalid tile dimensions")
        tiled = True
    else:
        raise SyntaxError("unknown data organization")
    if not libtiff and planar == 2 and offsets:
        per_plane = (-(-xsize // w) if tiled else 1) * -(-ysize // h)
        if (len(offsets) - 1) // per_plane >= len(rawmode):
            raise SyntaxError("more planes than the raw mode has bands")
    palette = None
    if mode in ("P", "PA"):
        if COLORMAP not in tags:
            raise SyntaxError("no colour map")               # a KeyError
        cmap = np.asarray(tags.get(COLORMAP), np.int64) // 256
        n = len(cmap) // 3
        palette = np.zeros((256, 3), np.uint8)
        k = min(n, 256)
        palette[:k] = np.stack(
            [cmap[:k], cmap[n:n + k], cmap[2 * n:2 * n + k]], -1) \
            .astype(np.uint8)
    if kind in _UNDECODABLE:
        def fail():
            raise OSError("decoder error -2")
        return fail
    layout = dict(xsize=xsize, ysize=ysize, w=w, h=h, offsets=offsets,
                  counts=counts, tiled=tiled, planar=planar, bps=bps,
                  count=count, kind=kind, libtiff=libtiff, fill=fill,
                  predictor=tags.get(PREDICTOR, 1), order=tags.prefix,
                  rawmode=rawmode, sample_format=fmt[0], tags=tags,
                  stride_bits=sum(bps),
                  orientation=tags.get(ORIENTATION, 1))
    # the C decoder reads the file's own photometric tag
    file_photo = tags.get(PHOTOMETRIC)
    if kind in ("jpeg", "tiff_jpeg"):
        fn = tiff_ycbcr.jpeg_image if kind == "jpeg" \
            else tiff_ycbcr.ojpeg_image
        return lambda: _oriented(fn(data, tags, layout, file_photo),
                                 layout["orientation"])
    if file_photo == 6 and libtiff:
        return lambda: _oriented(_rgba(data, tags, layout),
                                 layout["orientation"])
    if photo == 6 and rawmode == "RGBX" and planar == 1:
        # Pillow's raw decoder unpacks 4 bytes a pixel ("RGBX") from data
        # laid out in 3-sample (or subsampled) units
        layout["bps"] = (8,) * 4

    def load():
        return _load(data, mode, rawmode, palette, layout)
    return load


def _rgba(data, tags, L) -> np.ndarray:
    """A photometric YCbCr file under libtiff's LZW, Deflate or PackBits:
    each strip or tile decompressed, then TIFFRGBAImage's conversion."""
    codec = _Codec(L, tags)

    def chunk(k, occ):
        off = L["offsets"][k]
        cnt = L["counts"][k] if k < len(L["counts"]) else 0
        src = data[off:off + cnt]
        if L["fill"] == 2:
            src = _REVERSED[np.frombuffer(src, np.uint8)].tobytes()
        return codec(src, occ, off)
    return tiff_ycbcr.rgba_image(tags, L, chunk)


def read_tiff(data: bytes) -> np.ndarray:
    """A TIFF file -> (H, W, 3) uint8 as Pillow's convert("RGB")."""
    return open_tiff(data)()


def _planes(data, L) -> list:
    """Decode every strip or tile -> per plane (ysize, row bytes) uint8."""
    if L["libtiff"] and L["planar"] == 2 and "X" in L["rawmode"] \
            and not L["tiled"]:
        # Pillow's libtiff strip decoder finds no band for a planar pad
        # sample (its tile decoder skips it)
        raise OSError("decoder error -2")
    xsize, ysize, w, h = L["xsize"], L["ysize"], L["w"], L["h"]
    bps, planar = L["bps"], L["planar"]
    nplanes = len(bps) if planar == 2 else 1
    px_bits = bps[0] if planar == 2 else sum(bps)
    stride = 1 if planar == 2 else len(bps)
    row = (xsize * px_bits + 7) // 8
    chunk_row = (w * px_bits + 7) // 8
    across = (xsize + w - 1) // w if L["tiled"] else 1
    down = (ysize + h - 1) // h
    per_plane = across * down
    offsets = list(L["offsets"])
    if not L["libtiff"] and w == xsize and h == ysize and planar != 2:
        offsets = offsets[-1:]
    if L["libtiff"]:
        if L["tiled"] and chunk_row * h > \
                (h * sum(bps) // nplanes + 7) // 8 * w:
            # TiffDecode.c's tile-size test (its row bits taken over the
            # tile's length, times its width) refuses tiles whose rows end
            # inside a byte
            raise OSError("decoder error -2")
        codec = _Codec(L, L["tags"])
        pred = _predictor_setup(L["predictor"], bps[0], L["sample_format"]) \
            if L["kind"] in _PREDICTED else 1
    out = [np.zeros((ysize, row), np.uint8) for _ in range(nplanes)]
    for k, off in enumerate(offsets):
        plane, idx = divmod(k, per_plane)
        if plane >= nplanes:
            break
        ty, tx = divmod(idx, across)
        y0, x0 = ty * h, tx * w
        rows, cols = min(h, ysize - y0), min(w, xsize - x0)
        if rows <= 0:
            continue
        if L["libtiff"]:
            n_rows = h if L["tiled"] else rows
            occ = n_rows * chunk_row
            cnt = L["counts"][k] if k < len(L["counts"]) else 0
            src = data[off:off + cnt]
            if L["fill"] == 2 and L["kind"] not in _FAX:
                # libtiff reverses the coded bytes (the fax decoder reads
                # them in either order itself)
                src = _REVERSED[np.frombuffer(src, np.uint8)].tobytes()
            buf = _predict(codec(src, occ, off), pred, n_rows, w, stride,
                           bps[0], L["order"])
            tile = np.frombuffer(buf, np.uint8, rows * chunk_row) \
                .reshape(rows, chunk_row)
        else:
            # Pillow's raw decoder: the extent's bytes a row, rows `pitch`
            # apart (an edge tile's stride is its width's bytes, rounded
            # down; less than a row's bytes is a configuration error)
            nbytes = (cols * px_bits + 7) // 8
            pitch = int(w * L["stride_bits"] / 8) \
                if L["tiled"] and x0 + w > xsize else 0
            pitch = pitch or nbytes                 # 0: the extent's bytes
            if pitch < nbytes:
                raise OSError("decoder error -8")
            need = pitch * (rows - 1) + nbytes
            buf = data[off:off + need]
            if len(buf) < need:
                raise OSError("image file is truncated")
            tile = np.lib.stride_tricks.as_strided(
                np.frombuffer(buf, np.uint8), (rows, nbytes), (pitch, 1))
        if x0 * px_bits % 8:
            # a tile that starts inside a byte: placed pixel by pixel
            nbits = cols * px_bits
            bits = np.unpackbits(out[plane][y0:y0 + rows], axis=1)
            bits[:, x0 * px_bits:x0 * px_bits + nbits] = \
                np.unpackbits(tile, axis=1)[:, :nbits]
            out[plane][y0:y0 + rows] = np.packbits(bits, axis=1)[:, :row]
            continue
        b0 = x0 * px_bits // 8
        nb = min(tile.shape[1], row - b0)
        out[plane][y0:y0 + rows, b0:b0 + nb] = tile[:, :nb]
    return out


def _samples(plane: np.ndarray, width: int, bits: int, n: int, dtype):
    """(H, row bytes) -> (H, width, n) samples of `bits` bits."""
    H = plane.shape[0]
    if bits < 8:
        v = np.unpackbits(plane, axis=1).reshape(H, -1, bits)
        v = (v * (1 << np.arange(bits - 1, -1, -1))).sum(-1)
        return v[:, :width * n].reshape(H, width, n).astype(np.int64)
    nb = bits // 8
    flat = np.ascontiguousarray(plane[:, :width * n * nb])
    return flat.view(dtype).reshape(H, width, n)


# the rawmodes of the mode table that Pillow's raw decoder has no unpacker
# for (FillOrder 2 without libtiff)
_NO_UNPACKER = {"L;IR", "P;1R", "P;2R", "P;4R"}
# the one-letter rawmodes Pillow unpacks for each mode, and their bits
_LETTERS = {"1": "1", "L": "L", "P": "P", "F": "F", "I": "I", "RGB": "RGB",
            "RGBA": "RGBA", "CMYK": "CMYK", "LAB": "LAB"}
_LETTER_BITS = {"1": 1, "F": 32, "I": 32}


def _raw_planar(data, mode, rawmode, L) -> list:
    """Pillow's own decoder on an uncompressed PlanarConfiguration 2 file:
    layer k's tiles unpack with the one-letter rawmode rawmode[k] (1 bit
    for "1", 32 for "F" and "I", else 8 bits a sample, whatever the file's
    depth; no bit reversal, no inversion) from rows `stride` bytes apart
    (the extent's bytes, or on an edge tile its width times the pixel's
    bytes over the band count) -> per layer (H, W) samples."""
    xsize, ysize, w, h = L["xsize"], L["ysize"], L["w"], L["h"]
    bps = L["bps"]
    letters = rawmode[:len(bps)]
    if any(c not in _LETTERS.get(mode, "") for c in letters):
        raise ValueError("unknown raw mode for given image mode")
    across = (xsize + w - 1) // w if L["tiled"] else 1
    per_plane = across * ((ysize + h - 1) // h)
    out = [np.zeros((ysize, xsize), np.float32 if c == "F" else np.int64)
           for c in letters]
    for k, off in enumerate(L["offsets"][:per_plane * len(bps)]):
        plane, idx = divmod(k, per_plane)
        bits = _LETTER_BITS.get(letters[plane], 8)
        ty, tx = divmod(idx, across)
        y0, x0 = ty * h, tx * w
        rows, cols = min(h, ysize - y0), min(w, xsize - x0)
        if rows <= 0:
            continue
        nbytes = (cols * bits + 7) // 8
        stride = int(w * L["stride_bits"] / 8 / L["count"]) \
            if x0 + w > xsize else 0
        stride = stride or nbytes               # 0: the extent's bytes
        if stride < nbytes:
            raise OSError("decoder error -8")
        need = stride * (rows - 1) + nbytes
        buf = data[off:off + need]
        if len(buf) < need:
            raise OSError("image file is truncated")
        tile = np.lib.stride_tricks.as_strided(
            np.frombuffer(buf, np.uint8), (rows, nbytes), (stride, 1))
        if bits == 1:
            v = np.unpackbits(tile, axis=1)[:, :cols].astype(np.int64) * 255
        elif bits == 32:
            v = np.ascontiguousarray(tile).view(
                "<f4" if letters[plane] == "F" else "<i4")
        else:
            v = tile
        out[plane][y0:y0 + rows, x0:x0 + cols] = v
    return out


def _load(data, mode, rawmode, palette, L) -> np.ndarray:
    xsize, ysize, bps = L["xsize"], L["ysize"], L["bps"]
    if not L["libtiff"] and L["planar"] == 1 and rawmode in _NO_UNPACKER:
        raise ValueError("unknown raw mode for given image mode")
    if L["planar"] == 2 and not L["libtiff"]:
        layers = _raw_planar(data, mode, rawmode, L)
        if mode == "F":
            grey = float_to_grey(layers[0])
        elif mode in ("1", "L", "I"):
            grey = np.clip(layers[0], 0, 255).astype(np.uint8)
        elif mode == "LAB":              # band unpackers: a and b as read
            return _oriented(cielab.lab_to_rgb(
                np.stack(layers, -1).astype(np.uint8)), L["orientation"])
        else:
            return _oriented(_to_rgb(np.stack(layers, -1), mode, mode,
                                     palette, 8), L["orientation"])
        return _oriented(np.repeat(grey[..., None], 3, -1),
                         L["orientation"])
    planes = _planes(data, L)
    if L["fill"] == 2 and not L["libtiff"]:
        planes = [_REVERSED[p] for p in planes]
    bits = bps[0]
    nsamp = len(bps)
    if rawmode.startswith(("I;16", "I;32", "F;32", "I;12")):
        base = {"I;16": "<u2", "I;16N": "<u2", "I;16R": "<u2",
                "I;16B": ">u2", "I;16S": "<i2", "I;16BS": ">i2",
                "I;32N": "<u4", "I;32S": "<i4", "I;32BS": ">i4",
                "F;32F": "<f4", "F;32BF": ">f4"}
        if rawmode == "I;12":
            raw = planes[0][:, :(xsize * 12 + 7) // 8]
            v = np.unpackbits(raw, axis=1)[:, :xsize * 12] \
                .reshape(ysize, xsize, 12)
            v = (v * (1 << np.arange(11, -1, -1))).sum(-1)
        else:
            v = _samples(planes[0], xsize, bits, 1, base[rawmode])[..., 0]
        if mode == "F":
            grey = float_to_grey(v)
        else:
            grey = np.clip(v.astype(np.int64), 0, 255).astype(np.uint8)
        return _oriented(np.repeat(grey[..., None], 3, -1), L["orientation"])
    if L["planar"] == 2:
        s = np.concatenate([_samples(p, xsize, bits, 1, "<u2" if bits == 16
                                     else np.uint8) for p in planes], -1)
        if mode == "LAB":          # one band unpacker a plane: a, b as read
            return _oriented(cielab.lab_to_rgb(s.astype(np.uint8)),
                             L["orientation"])
    else:
        dt = ("<u2" if L["libtiff"] or rawmode.endswith("L") else ">u2") \
            if bits == 16 else np.uint8
        s = _samples(planes[0], xsize, bits, nsamp, dt)
    if bits == 16:                               # Pillow keeps the high byte
        s = (s.astype(np.int64) >> 8)
    return _oriented(_to_rgb(s.astype(np.int64), mode, rawmode, palette,
                             bits), L["orientation"])


def _to_rgb(s, mode, rawmode, palette, bits) -> np.ndarray:
    """(H, W, samples) int64 -> (H, W, 3) uint8 by Pillow's unpackers and
    convert("RGB")."""
    if mode == "1":
        v = s[..., 0] * 255
        grey = 255 - v if "I" in rawmode[2:] else v
        img = np.repeat(grey[..., None], 3, -1)
    elif mode == "L" or mode == "LA":
        v = s[..., 0] * (255 // ((1 << bits) - 1)) if bits < 8 else s[..., 0]
        if rawmode.startswith("L;") and "I" in rawmode[2:]:
            v = 255 - v
        img = np.repeat(v[..., None], 3, -1)
    elif mode in ("P", "PA"):
        img = palette[s[..., 0]]
    elif mode == "CMYK":
        img = cmyk_to_rgb(s[..., :4])
    elif mode == "LAB":
        lab = s[..., :3].astype(np.uint8)
        if rawmode == "LAB":            # Pillow's unpackLAB: signed a, b
            lab[..., 1:] ^= 128
        img = cielab.lab_to_rgb(lab)
    elif rawmode.startswith("RGBa"):
        a = s[..., 3:4]
        rgb = np.clip(s[..., :3] * 255 // np.maximum(a, 1), 0, 255)
        img = np.where(a == 0, 0, rgb)
    else:
        img = s[..., :3]
    return img.astype(np.uint8)


def _oriented(img: np.ndarray, orientation) -> np.ndarray:
    """Pillow's exif_transpose of the Orientation tag."""
    if orientation == 2:
        img = img[:, ::-1]
    elif orientation == 3:
        img = img[::-1, ::-1]
    elif orientation == 4:
        img = img[::-1]
    elif orientation == 5:
        img = img.transpose(1, 0, 2)
    elif orientation == 6:
        img = np.rot90(img, -1)
    elif orientation == 7:
        img = img.transpose(1, 0, 2)[::-1, ::-1]
    elif orientation == 8:
        img = np.rot90(img, 1)
    return np.ascontiguousarray(img)


# ---------------------------------------------------------------- writer ----
def encode_tiff(img: np.ndarray) -> bytes:
    """(H, W, 3|4) or (H, W) uint8 -> an uncompressed little-endian TIFF,
    the bytes Pillow's default save writes: one strip, its tag set and
    order, BitsPerSample out of line for RGB and RGBA."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    photo = 1 if c == 1 else 2
    entries = [(WIDTH, 4, 1, w), (LENGTH, 4, 1, h)]
    n = 9 + (c > 1) + (c == 4)
    ifd_end = 8 + 2 + 12 * n + 4
    extra = b""
    if c == 1:
        entries.append((BPS, 3, 1, 8))
    else:
        entries.append((BPS, 3, c, ifd_end))
        extra = struct.pack("<%dH" % c, *([8] * c))
    data_at = ifd_end + len(extra)
    entries += [(COMPRESSION, 3, 1, 1), (PHOTOMETRIC, 3, 1, photo),
                (STRIP_OFFSETS, 4, 1, data_at)]
    if c > 1:
        entries.append((SPP, 3, 1, c))
    entries += [(ROWS_PER_STRIP, 4, 1, h), (STRIP_COUNTS, 4, 1, w * h * c),
                (PLANAR, 3, 1, 1)]
    if c == 4:
        entries.append((EXTRA, 3, 1, 2))
    out = [b"II*\x00", struct.pack("<IH", 8, len(entries))]
    for tag, typ, cnt, val in entries:
        packed = struct.pack("<H", val) + b"\x00\x00" \
            if typ == 3 and cnt == 1 else struct.pack("<I", val)
        out.append(struct.pack("<HHI", tag, typ, cnt) + packed)
    out += [b"\x00" * 4, extra, np.ascontiguousarray(img).tobytes()]
    return b"".join(out)
