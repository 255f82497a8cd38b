"""Image IO (counterpart of liverrenderer_tpu/io/image.py): EXR, PFM, PNG,
JPEG, PPM/PGM/PBM, BMP and TGA files through the port's own codecs, with
no PIL.

8-bit images are read as the JAX package reads them through PIL (the
format found from the file's first bytes, as PIL finds it, TGA from its
extension; `convert("RGB")`, / 255, then the sRGB curve unless
`srgb_to_linear` is false); EXR files as it reads them with its native
library built (R, G, B(, A), alpha kept).  A file PIL cannot identify,
such as an RGBE `.hdr`, raises OSError as PIL's UnidentifiedImageError
does; the other formats PIL reads (GIF, TIFF, WebP, ...) raise (ROADMAP
M9).  Written files: EXR, PFM, and after an ordered dither to 8 bits PNG,
JPEG (PIL's defaults: quality 75, 4:2:0), PPM, BMP and TGA, byte for byte
as the JAX package writes them through PIL.
"""
from __future__ import annotations

import os

import numpy as np

from ..core.spectrum import linear_to_srgb_np
from ..errors import not_ported
from . import raster
from .exr import read_exr_any, write_exr
from .jpeg import encode_jpeg, read_jpeg
from .png import read_png, write_png

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# formats PIL reads and the port does not: their first bytes
_OTHER_PIL = (b"GIF87a", b"GIF89a", b"II*\x00", b"MM\x00*", b"RIFF",
              b"\x00\x00\x01\x00", b"8BPS", b"\x8aMNG", b"DDS ", b"qoif",
              b"\x00\x00\x00\x0cjP  ", b"\xffO\xffQ", b"icns")
# writers of 8-bit files by extension (PIL's registry)
_WRITERS = {".jpg": "jpeg", ".jpeg": "jpeg", ".jpe": "jpeg", ".jfif": "jpeg",
            ".ppm": "ppm", ".pgm": "ppm", ".pbm": "ppm", ".pnm": "ppm",
            ".bmp": "bmp", ".tga": "tga", ".icb": "tga", ".vda": "tga",
            ".vst": "tga"}

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
    """A PNG, JPEG, PPM/PGM/PBM, BMP or TGA file -> (H, W, 3) uint8, as
    PIL's `Image.open(path).convert("RGB")` returns it."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_PNG_SIG):
        return read_png(path)
    if data.startswith(b"\xff\xd8\xff"):
        return read_jpeg(data)
    if data.startswith(b"BM"):
        return raster.read_bmp(data)
    if len(data) > 2 and data[:1] == b"P" and data[1:2] in b"123456" \
            and data[2:3] in b" \t\n\r\x0b\x0c":
        return raster.read_ppm(data)
    ext = os.path.splitext(path)[1].lower()
    if ext in (".tga", ".icb", ".vda", ".vst"):
        return raster.read_tga(data)
    if data.startswith(_OTHER_PIL):
        raise not_ported(f"{ext or 'extension-less'} image files",
                         "Queue 1 M9")
    raise OSError(f"cannot identify image file {path!r}")


def write_image(path: str, img: np.ndarray):
    """Write a linear RGB float image: PNG sRGB-encoded with an ordered
    dither before the 8-bit quantisation, EXR as float, PFM as float."""
    img = np.asarray(img, np.float32)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        write_exr(path, img, half=False)
        return
    if ext == ".pfm":
        _write_pfm(path, img)
        return
    kind = "png" if ext == ".png" else _WRITERS.get(ext)
    if kind is None:
        raise not_ported(f"writing {ext or 'extension-less'} image files",
                         "Queue 1 M9")
    ldr = np.clip(linear_to_srgb_np(np.clip(img, 0, None)), 0, 1)
    h, w = ldr.shape[:2]
    thresh = np.tile(_BAYER, ((h + 3) // 4, (w + 3) // 4))[:h, :w]
    if ldr.ndim == 3:
        thresh = thresh[..., None]
    px = (ldr * 255 + thresh).astype(np.uint8)
    if kind == "png":
        write_png(path, px)
        return
    if kind == "jpeg" and px.ndim == 3 and px.shape[2] == 4:
        raise OSError("cannot write mode RGBA as JPEG")
    data = {"jpeg": encode_jpeg, "ppm": raster.encode_ppm,
            "bmp": raster.encode_bmp, "tga": raster.encode_tga}[kind](px)
    with open(path, "wb") as f:
        f.write(data)


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
