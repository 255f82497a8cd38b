"""Image IO (counterpart of liverrenderer_tpu/io/image.py): EXR, PFM and
PNG files through the port's own codecs, with no PIL.

PNG pixels are read as the JAX package reads them through PIL
(`convert("RGB")`, / 255, then the sRGB curve unless `srgb_to_linear` is
false); EXR files as it reads them with its native library built
(R, G, B(, A), alpha kept).  JPEG and other formats raise (ROADMAP M9).
"""
from __future__ import annotations

import os

import numpy as np

from ..core.spectrum import linear_to_srgb_np
from ..errors import not_ported
from .exr import read_exr_any, write_exr
from .png import read_png, write_png

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
    if ext != ".png":
        raise not_ported(f"{ext or 'extension-less'} image files",
                         "Queue 1 M9")
    img = read_png(path).astype(np.float32) / 255.0
    if srgb_to_linear:
        img = np.where(img <= 0.04045, img / 12.92,
                       ((img + 0.055) / 1.055) ** 2.4).astype(np.float32)
    return img


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
    if ext != ".png":
        raise not_ported(f"writing {ext or 'extension-less'} image files",
                         "Queue 1 M9")
    ldr = np.clip(linear_to_srgb_np(np.clip(img, 0, None)), 0, 1)
    h, w = ldr.shape[:2]
    thresh = np.tile(_BAYER, ((h + 3) // 4, (w + 3) // 4))[:h, :w]
    if ldr.ndim == 3:
        thresh = thresh[..., None]
    write_png(path, (ldr * 255 + thresh).astype(np.uint8))


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
