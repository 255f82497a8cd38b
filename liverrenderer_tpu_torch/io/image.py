"""Image IO (counterpart of liverrenderer_tpu/io/image.py) through the port's
own codecs, with no PIL.

8-bit images are read as the JAX package reads them through Pillow 12.1
(`Image.open(path).convert("RGB")`, / 255, then the sRGB curve unless
`srgb_to_linear` is false); EXR files as it reads them with its native
library built (R, G, B(, A), alpha kept), and PFM by extension.  The
format is found as Image.open finds it: Pillow's plugins in their
registry order (`_OPEN`, Pillow's Image.ID), each one's test of the
file's first 16 bytes, and the plugins without one (IM, IMT, IPTC, PCD,
SPIDER, TGA) tried on the file itself; a plugin that gives the file up
(SyntaxError and its kin in Pillow) passes it on.  The stub formats
(BUFR, GRIB, HDF5, WMF) raise Pillow's "cannot find loader" OSError,
MPEG "cannot load this image", and EPS Pillow's Ghostscript error (or
goes through `gs`) (io/pil_open.py); AVIF raises NotImplementedError
(ROADMAP Queue 1 M9) on its prefix alone (Pillow's opener is libavif).
The port decodes PNG, JPEG, JPEG 2000 (codestreams and JP2 files, as
OpenJPEG 2.5.4 decodes them, io/jpeg2000.py),
PPM/PGM/PBM and Pillow's PPM extensions, BMP, DIB, GIF, TIFF, PCX, DCX,
SGI, IM, Sun raster, XBM, XPM, MSP, QOI, ICO, CUR, PSD, TGA, WebP
(io/webp.py), DDS (io/dds.py), BLP (io/blp.py), FTEX (io/ftex.py), FITS
(io/fits.py), FLI (io/fli.py), ICNS (io/icns.py), and GBR, IMT, IPTC,
McIdas, PCD, PIXAR, SPIDER and XV thumbnails (io/pil_open.py); a file no
plugin opens (an RGBE `.hdr`, say) raises OSError as Pillow's
UnidentifiedImageError does.  `read_8bit` sets io/rawmode.FROM_PATH, so
that a raw tile Pillow would memory-map fails as the map does.

Written files: EXR and PFM as float; otherwise an ordered dither to 8
bits, then the format of the extension as Pillow's registry names it:
PNG (as io/png.py writes it), JPEG and MPO (quality 75, 4:2:0), PPM,
BMP, DIB, TGA, TIFF, PCX, SGI, IM, QOI, DDS (raw, as Pillow saves it
with no pixel format), JPEG 2000 (.jp2, .j2k, .jpc, .jpf, .jpx, .j2c:
lossless, as Pillow saves it with its defaults, io/jpeg2000.py), GIF
(Pillow's quantisers, io/quantize.py, and LZW encoder), EPS (io/eps.py)
and PDF (io/pdf.py; its dates from the clock), all byte for byte as
Pillow saves them; ICO and ICNS with Pillow's resampler
(io/resample.py), byte for byte but for the deflate streams of their PNG
entries.  Where Pillow refuses, the port raises the same exception (an
unknown extension ValueError, a format with no writer KeyError, XBM /
MSP / Palm OSError for an RGB image, EPS ValueError and JPEG / MPO
OSError for RGBA); WebP and AVIF, which Pillow writes through libwebp
and libavif, raise NotImplementedError (ROADMAP M9).
"""
from __future__ import annotations

import os
import struct

import numpy as np

from ..core.spectrum import linear_to_srgb_np
from ..errors import not_ported
from . import (blp, dds, eps, fits, fli, ftex, gif, icns, ico, jpeg2000,
               legacy, pdf, pil_open, psd, raster, rawmode, tiff, webp)
from .exr import read_exr_any, write_exr
from .jpeg import encode_jpeg, open_jpeg
from .png import decode_png, write_png

# the 4 x 4 ordered-dither thresholds of an 8-bit write
_BAYER = np.array([[0, 8, 2, 10], [12, 4, 14, 6],
                   [3, 11, 1, 9], [15, 7, 13, 5]], np.float32) / 16.0


def read_image(path: str, srgb_to_linear: bool = True) -> np.ndarray:
    """An image file as float32 (H, W, C >= 3), linear RGB."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        return read_exr_any(path)
    if ext == ".pfm":
        return _read_pfm(path)
    img = read_8bit(path).astype(np.float32) / 255.0
    if srgb_to_linear:
        img = np.where(img <= 0.04045, img / 12.92,
                       ((img + 0.055) / 1.055) ** 2.4).astype(np.float32)
    return img


def read_8bit(path: str) -> np.ndarray:
    """Any file Pillow opens -> (H, W, 3) uint8, as Pillow's
    `Image.open(path).convert("RGB")` returns it (or the raise above)."""
    with open(path, "rb") as f:
        data = f.read()
    token = rawmode.FROM_PATH.set(True)
    try:
        return identify(data, path)()
    finally:
        rawmode.FROM_PATH.reset(token)


def identify(data: bytes, name: str = ""):
    """Image.open's walk over Pillow's plugins -> a function that decodes
    the file."""
    return identify_format(data, name)[1]


def identify_format(data: bytes, name: str = ""):
    """identify -> (the format Pillow names the file, its decoder)."""
    prefix = data[:16]
    for fmt, accept, opener in _OPEN:
        try:
            if accept is not None and not accept(prefix):
                continue
        except (IndexError, struct.error):
            continue
        if opener is None:
            raise not_ported(f"{fmt} image files", "Queue 1 M9")
        try:
            return fmt, opener(data)
        except SyntaxError:
            continue
    raise OSError(f"cannot identify image file {name!r}")


# ---------------------------------------------------- the open registry ----
def _u32(p, e="<"):
    return struct.unpack_from(e + "I", p)[0]


def _u16(p, o=0, e="<"):
    return struct.unpack_from(e + "H", p, o)[0]


def _open_tga(data):
    """TgaImageFile._open's tests (the plugin has no prefix test)."""
    s = data[:18]
    if len(s) < 18:
        raise SyntaxError("not a TGA file")                # an IndexError
    w, h = _u16(s, 12), _u16(s, 14)
    if s[1] not in (0, 1) or w <= 0 or h <= 0 \
            or s[16] not in (1, 8, 16, 24, 32):
        raise SyntaxError("not a TGA file")
    if s[2] not in (1, 2, 3, 9, 10, 11):
        raise SyntaxError("unknown TGA mode")
    if s[1] and s[7] not in (16, 24, 32):
        raise SyntaxError("unknown TGA map depth")
    return lambda: raster.read_tga(data)


def _pfx(*magics):
    return lambda p: p.startswith(magics)


# Pillow 12.1's Image.ID after preinit() and init(), each format's prefix
# test (None: tried on every file) and the port's opener (None: Pillow
# opens it, the port does not yet)
_OPEN = (
    ("BMP", _pfx(b"BM"), lambda d: (lambda: raster.read_bmp(d))),
    ("DIB", lambda p: _u32(p) in (12, 40, 52, 56, 64, 108, 124),
     lambda d: (lambda: raster.read_dib(d))),
    ("GIF", gif._accept, gif.open_gif),
    ("JPEG", _pfx(b"\xff\xd8\xff"), open_jpeg),
    ("PPM", lambda p: len(p) >= 2 and p[:1] == b"P" and p[1] in b"0123456fy",
     raster.open_ppm),
    ("PNG", _pfx(b"\x89PNG\r\n\x1a\n"), lambda d: (lambda: decode_png(d))),
    ("AVIF", lambda p: p[4:8] == b"ftyp"
     and p[8:12] in (b"avif", b"avis", b"mif1", b"msf1"), None),
    ("BLP", _pfx(b"BLP1", b"BLP2"), blp.open_blp),
    ("BUFR", _pfx(b"BUFR", b"ZCZC"), pil_open.open_bufr),
    ("CUR", _pfx(b"\0\0\2\0"), ico.open_cur),
    ("PCX", legacy._pcx_accept, legacy.open_pcx),
    ("DCX", lambda p: len(p) >= 4 and _u32(p) == 0x3ADE68B1, legacy.open_dcx),
    ("DDS", _pfx(b"DDS "), dds.open_dds),
    ("EPS", lambda p: p.startswith(b"%!PS")
     or (len(p) >= 4 and _u32(p) == 0xC6D3D0C5), pil_open.open_eps),
    ("FITS", _pfx(b"SIMPLE"), fits.open_fits),
    ("FLI", lambda p: len(p) >= 16 and _u16(p, 4) in (0xAF11, 0xAF12)
     and _u16(p, 14) in (0, 3), fli.open_fli),
    ("FTEX", _pfx(b"FTEX"), ftex.open_ftex),
    ("GBR", lambda p: len(p) >= 8 and _u32(p, ">") >= 20
     and _u32(p[4:], ">") in (1, 2), pil_open.open_gbr),
    ("GRIB", lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1,
     pil_open.open_grib),
    ("HDF5", _pfx(b"\x89HDF\r\n\x1a\n"), pil_open.open_hdf5),
    ("JPEG2000", _pfx(b"\xff\x4f\xff\x51",
                      b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"),
     pil_open.open_jpeg2000),
    ("ICNS", _pfx(b"icns"), icns.open_icns),
    ("ICO", _pfx(b"\0\0\1\0"), ico.open_ico),
    ("IM", None, legacy.open_im),
    ("IMT", None, pil_open.open_imt),
    ("IPTC", None, pil_open.open_iptc),
    ("MCIDAS", _pfx(b"\x00\x00\x00\x00\x00\x00\x00\x04"),
     pil_open.open_mcidas),
    ("MPEG", _pfx(b"\x00\x00\x01\xb3"), pil_open.open_mpeg),
    ("TIFF", _pfx(*tiff.PREFIXES), tiff.open_tiff),
    ("MSP", _pfx(b"DanM", b"LinS"), legacy.open_msp),
    ("PCD", None, pil_open.open_pcd),
    ("PIXAR", _pfx(b"\200\350\000\000"), pil_open.open_pixar),
    ("PSD", _pfx(b"8BPS"), psd.open_psd),
    ("QOI", _pfx(b"qoif"), legacy.open_qoi),
    ("SGI", lambda p: len(p) >= 2 and _u16(p, 0, ">") == 474,
     legacy.open_sgi),
    ("SPIDER", None, pil_open.open_spider),
    ("SUN", lambda p: len(p) >= 4 and _u32(p, ">") == 0x59A66A95,
     legacy.open_sun),
    ("TGA", None, _open_tga),
    ("WEBP", lambda p: p.startswith(b"RIFF") and p[8:12] == b"WEBP"
     and p[12:16] in (b"VP8 ", b"VP8X", b"VP8L"), webp.open_webp),
    ("WMF", _pfx(b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00"),
     pil_open.open_wmf),
    ("XBM", lambda p: p.lstrip().startswith(b"#define"), legacy.open_xbm),
    ("XPM", _pfx(b"/* XPM */"), legacy.open_xpm),
    ("XVTHUMB", _pfx(b"P7 332"), pil_open.open_xvthumb),
)


# ---------------------------------------------------- the save registry ----
# Pillow 12.1's Image.EXTENSION -> format
EXTENSION = {
    ".avif": "AVIF", ".avifs": "AVIF", ".blp": "BLP", ".bmp": "BMP",
    ".dib": "DIB", ".bufr": "BUFR", ".cur": "CUR", ".pcx": "PCX",
    ".dcx": "DCX", ".dds": "DDS", ".ps": "EPS", ".eps": "EPS",
    ".fit": "FITS", ".fits": "FITS", ".fli": "FLI", ".flc": "FLI",
    ".ftc": "FTEX", ".ftu": "FTEX", ".gbr": "GBR", ".gif": "GIF",
    ".grib": "GRIB", ".h5": "HDF5", ".hdf": "HDF5", ".png": "PNG",
    ".apng": "PNG", ".jp2": "JPEG2000", ".j2k": "JPEG2000",
    ".jpc": "JPEG2000", ".jpf": "JPEG2000", ".jpx": "JPEG2000",
    ".j2c": "JPEG2000", ".icns": "ICNS", ".ico": "ICO", ".im": "IM",
    ".iim": "IPTC", ".jfif": "JPEG", ".jpe": "JPEG", ".jpg": "JPEG",
    ".jpeg": "JPEG", ".mpg": "MPEG", ".mpeg": "MPEG", ".tif": "TIFF",
    ".tiff": "TIFF", ".mpo": "MPO", ".msp": "MSP", ".palm": "PALM",
    ".pcd": "PCD", ".pdf": "PDF", ".pxr": "PIXAR", ".pbm": "PPM",
    ".pgm": "PPM", ".ppm": "PPM", ".pnm": "PPM", ".pfm": "PPM",
    ".psd": "PSD", ".qoi": "QOI", ".bw": "SGI", ".rgb": "SGI",
    ".rgba": "SGI", ".sgi": "SGI", ".ras": "SUN", ".tga": "TGA",
    ".icb": "TGA", ".vda": "TGA", ".vst": "TGA", ".webp": "WEBP",
    ".wmf": "WMF", ".emf": "WMF", ".xbm": "XBM", ".xpm": "XPM"}
# the formats with a writer in Pillow (Image.SAVE); encode_8bit ports all
# but AVIF and WEBP and mirrors the refusals of the others
SAVE = {"AVIF", "BLP", "BMP", "BUFR", "DDS", "DIB", "EPS", "GIF", "GRIB",
        "HDF5", "ICNS", "ICO", "IM", "JPEG", "JPEG2000", "MPO", "MSP",
        "PALM", "PCX", "PDF", "PNG", "PPM", "QOI", "SGI", "SPIDER", "TGA",
        "TIFF", "WEBP", "WMF", "XBM"}
# Pillow's writers that take only mode "1" (OSError), only "P" (BLP), or
# are stubs without a handler
_MODE_1_ONLY = {"MSP": "MSP", "PALM": "Palm", "XBM": "XBM"}
_STUBS = {"BUFR", "GRIB", "HDF5", "WMF"}


def write_image(path: str, img: np.ndarray):
    """Write a linear RGB float image: EXR and PFM as float, the 8-bit
    formats sRGB-encoded with an ordered dither before the quantisation."""
    img = np.asarray(img, np.float32)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        write_exr(path, img, half=False)
        return
    if ext == ".pfm":
        _write_pfm(path, img)
        return
    if ext not in EXTENSION:
        raise ValueError(f"unknown file extension: {ext}")
    fmt = EXTENSION[ext]
    if fmt not in SAVE:
        raise KeyError(fmt)
    px = dither_8bit(img)
    if fmt == "PNG":
        write_png(path, px)
        return
    data = encode_8bit(px, fmt, path)
    with open(path, "wb") as f:
        f.write(data)


def dither_8bit(img: np.ndarray) -> np.ndarray:
    """A linear float image -> the sRGB-encoded uint8 pixels an 8-bit
    write stores (the 4 x 4 ordered dither before the quantisation)."""
    ldr = np.clip(linear_to_srgb_np(np.clip(img, 0, None)), 0, 1)
    h, w = ldr.shape[:2]
    thresh = np.tile(_BAYER, ((h + 3) // 4, (w + 3) // 4))[:h, :w]
    if ldr.ndim == 3:
        thresh = thresh[..., None]
    return (ldr * 255 + thresh).astype(np.uint8)


def encode_8bit(px: np.ndarray, fmt: str, path: str = "") -> bytes:
    """(H, W), (H, W, 3) or (H, W, 4) uint8 -> the bytes Pillow's `fmt`
    writer saves for Image.fromarray(px) (mode L, RGB or RGBA; PNG goes
    through io/png.write_png)."""
    mode = "L" if px.ndim == 2 else {3: "RGB", 4: "RGBA"}[px.shape[2]]
    if fmt in _MODE_1_ONLY:
        raise OSError(f"cannot write mode {mode} as {_MODE_1_ONLY[fmt]}")
    if fmt in _STUBS:
        raise OSError(f"{fmt} save handler not installed")
    if fmt == "BLP":
        raise ValueError("Unsupported BLP image mode")
    if fmt in ("JPEG", "MPO"):
        if mode == "RGBA":
            raise OSError("cannot write mode RGBA as JPEG")
        return encode_jpeg(px)
    # the writers of Pillow's formats the port writes, by format name
    writers = {"PPM": raster.encode_ppm, "BMP": raster.encode_bmp,
               "DIB": lambda a: raster.encode_bmp(a)[14:],
               "TGA": raster.encode_tga, "TIFF": tiff.encode_tiff,
               "PCX": legacy.encode_pcx,
               "SGI": lambda a: legacy.encode_sgi(a, path),
               "IM": lambda a: legacy.encode_im(a, path),
               "QOI": legacy.encode_qoi, "DDS": dds.encode_dds,
               "JPEG2000": lambda a: jpeg2000.encode_jpeg2000(a, path),
               "GIF": gif.encode_gif, "ICO": ico.encode_ico,
               "ICNS": icns.encode_icns, "EPS": eps.encode_eps,
               "PDF": lambda a: pdf.encode_pdf(a, path)}
    if fmt not in writers:
        raise not_ported(f"writing {fmt} image files", "Queue 1 M9")
    return writers[fmt](px)


def _read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        color = f.readline().strip() == b"PF"
        w, h = (int(x) for x in f.readline().split())
        scale = float(f.readline().strip())
        data = np.fromfile(f, "<f4" if scale < 0 else ">f4")
    data = data.reshape(h, w, 3 if color else 1)
    return np.flipud(data).astype(np.float32)


def _write_pfm(path: str, img: np.ndarray):
    color = img.ndim == 3 and img.shape[2] >= 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{img.shape[1]} {img.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        np.flipud(img[..., :3] if color else img).astype("<f4").tofile(f)
