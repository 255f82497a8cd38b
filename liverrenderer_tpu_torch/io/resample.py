"""Pillow 12.1's resampler for 8-bit L, RGB and RGBA images
(libImaging/Resample.c through Image.resize and Image.thumbnail), as the
ICO and ICNS writers use it.

The bicubic (a = -0.5, support 2) and Lanczos (support 3) filters; when
downscaling, the support widens by the scale.  Each output sample's
coefficients are the filter at the input samples' centres, normalised by
their sum (in double, summed in order) and rounded to 22-bit fixed point
(`normalize_coeffs_8bpc`).  A horizontal pass, then a vertical one, each
accumulating from 2^21 and clipping `sum >> 22` to 0..255; a pass whose
size does not change is skipped.  RGBA goes through premultiplied "RGBa"
and back (Convert.c's rgbA2rgba and rgba2rgbA).  The filter's sin is the
C library's (math.sin), as Resample.c's.
"""
from __future__ import annotations

import math

import numpy as np

BICUBIC, LANCZOS = "bicubic", "lanczos"
_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: float) -> float:
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


_FILTERS = {BICUBIC: (_bicubic, 2.0), LANCZOS: (_lanczos, 3.0)}


def _coefficients(in_size: int, out_size: int, kind: str):
    """precompute_coeffs + normalize_coeffs_8bpc for the whole input
    range -> (xmin (out,), xmax (out,), fixed-point taps (out, ksize))."""
    fn, support = _FILTERS[kind]
    scale = filterscale = float(in_size) / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    xmaxs = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = 0.0 + (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in ws:
            ww += w
        for x, w in enumerate(ws):
            if ww != 0.0:
                w /= ww
            kk[xx, x] = int(-0.5 + w * (1 << _PRECISION_BITS)) if w < 0 \
                else int(0.5 + w * (1 << _PRECISION_BITS))
        xmins[xx], xmaxs[xx] = xmin, xmax
    return xmins, xmaxs, kk


def _pass(a: np.ndarray, out_size: int, kind: str, axis: int) -> np.ndarray:
    """One 8-bit pass along `axis` (0 rows, 1 columns) of (H, W, C)."""
    xmin, xmax, kk = _coefficients(a.shape[axis], out_size, kind)
    src = np.moveaxis(a, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    for k in range(kk.shape[1]):
        live = k < xmax
        pos = np.where(live, xmin + k, 0)
        taps = np.where(live, kk[:, k], 0)
        acc += src[pos] * taps[:, None, None]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def premultiply(px: np.ndarray) -> np.ndarray:
    """RGBA -> RGBa (rgbA2rgba: MULDIV255 of each colour by alpha)."""
    t = px[..., :3].astype(np.uint32) * px[..., 3:].astype(np.uint32) + 128
    out = px.copy()
    out[..., :3] = ((t >> 8) + t) >> 8
    return out


def unpremultiply(px: np.ndarray) -> np.ndarray:
    """RGBa -> RGBA (rgba2rgbA: 255 * c / alpha, truncated and clipped;
    alpha 0 and 255 keep the colour)."""
    a = px[..., 3:].astype(np.int64)
    c = px[..., :3].astype(np.int64)
    div = np.minimum(255 * c // np.maximum(a, 1), 255)
    out = px.copy()
    out[..., :3] = np.where((a == 0) | (a == 255), c, div)
    return out


def resize(px: np.ndarray, size, kind: str = BICUBIC) -> np.ndarray:
    """Image.resize((w, h), kind) of (H, W), (H, W, 3) or (H, W, 4)
    uint8, with the default box and no reducing gap."""
    px = np.asarray(px, np.uint8)
    w, h = size
    if px.shape[:2] == (h, w):
        return px.copy()
    if px.ndim == 3 and px.shape[2] == 4:
        return unpremultiply(_resize_bands(premultiply(px), size, kind))
    return _resize_bands(px, size, kind)


def _resize_bands(px: np.ndarray, size, kind: str) -> np.ndarray:
    """ImagingResample: every band alike, the horizontal pass first."""
    w, h = size
    a = px[..., None] if px.ndim == 2 else px
    if w != a.shape[1]:
        a = _pass(a, w, kind, 1)
    if h != a.shape[0]:
        a = _pass(a, h, kind, 0)
    return a[..., 0] if px.ndim == 2 else a


def _thumbnail_size(width: int, height: int, size):
    """Image.thumbnail's aspect-preserving size for `size` (w, h), or None
    when the image already fits."""
    x, y = (math.floor(v) for v in size)
    if x >= width and y >= height:
        return None

    def round_aspect(number, key):
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    aspect = width / height
    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect,
                         key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    return x, y


def thumbnail(px: np.ndarray, size) -> np.ndarray:
    """Image.thumbnail(size, LANCZOS, reducing_gap=None) of a copy, as the
    ICO writer makes its frames."""
    px = np.asarray(px, np.uint8)
    new = _thumbnail_size(px.shape[1], px.shape[0], size)
    if new is None or new == (px.shape[1], px.shape[0]):
        return px.copy()
    return resize(px, new, LANCZOS)
