"""YCbCr and JPEG-compressed TIFF images for io/tiff.py, as Pillow 12.1's
TiffDecode.c drives libtiff 4.7 for them:

- Compression 7 (JPEG): every strip or tile is a JPEG stream decoded by
  io/jpeg.py after the JPEGTables stream (tag 347), with libtiff's
  settings: a YCbCr image in one plane is converted to RGB by libjpeg
  (Pillow sets JPEGCOLORMODE_RGB: fancy upsampling, libjpeg's tables);
  RGB and grey images are read with no colour conversion.  libtiff's
  checks of each stream (component count, precision, size against the
  strip or tile, sampling factors against YCbCrSubsampling) fail as
  Pillow's "decoder error".
- Photometric YCbCr under the other codecs: TiffDecode.c reads it through
  libtiff's TIFFRGBAImage (its `_decodeAsRGBA`): the subsampled data
  units (YCbCrSubsampling, 1, 2 or 4 each way) with each chroma pair
  shared by its whole unit, or three planes at 1 x 1, after libtiff's
  horizontal predictor where it is set, TIFFYCbCrToRGB's tables from
  YCbCrCoefficients and ReferenceBlackWhite in libtiff's float and
  fixed-point steps; the Orientation tag is left to Pillow's
  exif_transpose (the rows come out top-left first).
- Compression 6 (old-style JPEG) whose stream (JPEGInterchangeFormat's
  bytes, then the strips') is a whole JPEG stream: libtiff's tif_ojpeg.c
  hands over the stream's raw
  (not upsampled, not converted) component samples as YCbCr data units,
  which TIFFRGBAImage converts as above (libtiff takes an RGB or missing
  photometric tag of such a file for YCbCr); a grey stream is read as
  is.
"""
from __future__ import annotations

import numpy as np

from ..errors import not_ported
from . import jpeg

YCBCR_COEFFICIENTS, YCBCR_SUBSAMPLING, REFERENCE_BW = 529, 530, 532
JPEG_TABLES, JIF, JIF_LENGTH = 347, 513, 514
_BROKEN = "decoder error -2"


# --------------------------------------------------- TIFFYCbCrToRGB ----
def ycbcr_tables(tags) -> tuple:
    """TIFFYCbCrToRGBInit (tif_color.c) for 8-bit samples: the Y, Cr->R,
    Cb->B, Cr->G and Cb->G tables, from the YCbCrCoefficients (default
    0.299, 0.587, 0.114) and ReferenceBlackWhite (default 0, 255, 128,
    255, 128, 255) tags, with libtiff's float32 arithmetic."""
    f = np.float32
    luma = [f(x) for x in tags.get(YCBCR_COEFFICIENTS, (0.299, 0.587, 0.114))]
    rbw = [f(x) for x in tags.get(REFERENCE_BW, (0, 255, 128, 255, 128, 255))]
    if len(luma) < 3 or len(rbw) < 6 or luma[1] == 0 \
            or np.isnan(luma).any() or np.isnan(rbw).any():
        raise OSError(_BROKEN)

    def fix(x):                         # (int32)(x * 65536 + 0.5)
        return int(float(f(x) * f(65536)) + 0.5)

    def clamp(x, lo, hi):
        return lo if not x >= lo else (hi if x > hi else x)

    f1 = f(2) - f(2) * luma[0]
    d1 = fix(clamp(f1, f(0), f(2)))
    f2 = luma[0] * f1 / luma[1]
    d2 = -fix(clamp(f2, f(0), f(2)))
    f3 = f(2) - f(2) * luma[2]
    d3 = fix(clamp(f3, f(0), f(2)))
    f4 = luma[2] * f3 / luma[1]
    d4 = -fix(clamp(f4, f(0), f(2)))

    def code2v(c, rb, rw, cr):
        den = rw - rb
        return f(f(c - int(rb)) * f(cr)) / f(den if den != 0 else 1)

    def clampw(v):
        v = f(v)
        return int(f(-128 * 32) if v < f(-128 * 32)
                   else f(128 * 32) if v > f(128 * 32) else v)

    half, w32 = 1 << 15, jpeg._w32         # libtiff's int32 arithmetic
    tabs = np.zeros((5, 256), np.int64)
    for i in range(256):
        x = i - 128
        cr = clampw(code2v(x, rbw[4] - f(128), rbw[5] - f(128), 127))
        cb = clampw(code2v(x, rbw[2] - f(128), rbw[3] - f(128), 127))
        tabs[:, i] = (w32(d1 * cr + half) >> 16, w32(d3 * cb + half) >> 16,
                      w32(d2 * cr), w32(d4 * cb + half),
                      clampw(code2v(x + 128, rbw[0], rbw[1], 255)))
    return tuple(tabs)


def ycbcr_to_rgb(y, cb, cr, tabs) -> np.ndarray:
    """TIFFYCbCrtoRGB on uint8 arrays -> (..., 3) uint8."""
    cr_r, cb_b, cr_g, cb_g, ytab = tabs
    yv = ytab[y]
    r = yv + cr_r[cr]
    g = yv + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = yv + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _subsampling(tags) -> tuple:
    hs, vs = (tuple(tags.get(YCBCR_SUBSAMPLING, (2, 2))) + (2, 2))[:2]
    return int(hs), int(vs)


def units_to_planes(buf: bytes, rows: int, width: int, hs: int, vs: int):
    """libtiff's packed YCbCr data units (hs * vs luma, then Cb, Cr) of a
    strip or tile `rows` x `width` -> full-size Y, Cb, Cr planes, each
    unit's chroma repeated over it (TIFFRGBAImage's put routines)."""
    bh, bw = -(-rows // vs), -(-width // hs)
    n = bh * bw * (hs * vs + 2)
    u = np.frombuffer(buf, np.uint8)
    if len(u) < n:
        u = np.concatenate([u, np.zeros(n - len(u), np.uint8)])
    u = u[:n].reshape(bh, bw, hs * vs + 2)
    y = u[..., :hs * vs].reshape(bh, bw, vs, hs).transpose(0, 2, 1, 3) \
        .reshape(bh * vs, bw * hs)[:rows, :width]
    cb = np.repeat(np.repeat(u[..., -2], vs, 0), hs, 1)[:rows, :width]
    cr = np.repeat(np.repeat(u[..., -1], vs, 0), hs, 1)[:rows, :width]
    return y, cb, cr


# ------------------------------------------------- the RGBA path ----
def _hor_acc8(buf: bytes, rowsize: int, stride: int) -> bytes:
    """tif_predict.c's horAcc8 (predictor 2 on 8-bit samples) over rows of
    `rowsize` bytes: TIFFScanlineSize's, which for subsampled YCbCr is a
    row of data units over the vertical subsampling.  Where libtiff's
    checks fail ("occ0%rowsize != 0", "(cc%stride)!=0") the strip read
    fails, and TIFFRGBAImage, which does not stop on errors, converts the
    bytes as they were decompressed."""
    if rowsize <= 0 or len(buf) % rowsize or rowsize % stride:
        return buf
    a = np.frombuffer(buf, np.uint8).reshape(-1, rowsize // stride, stride)
    return (np.cumsum(a, axis=1, dtype=np.uint64) & 255) \
        .astype(np.uint8).tobytes()


def rgba_image(tags, L, decode_chunk) -> np.ndarray:
    """Pillow's _decodeAsRGBA for a photometric YCbCr file: strip or tile
    k decompressed by `decode_chunk(k, n_bytes)`, then libtiff's predictor
    2 where it is set, then TIFFRGBAImage's put routines (one plane of
    data units, or three planes at 1 x 1) -> (H, W, 3) uint8, before
    Pillow's exif_transpose."""
    if L["bps"] != (8, 8, 8):
        raise OSError(_BROKEN)      # TIFFRGBAImage finds no put routine
    hs, vs = _subsampling(tags)
    planar = L["planar"] == 2
    if vs == 0 or (hs, vs) not in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1),
                                   (4, 2), (4, 4)) \
            or (planar and (hs, vs) != (1, 1)):
        raise OSError(_BROKEN)
    # libtiff's predictors belong to the LZW and Deflate codecs
    predictor = L["predictor"] if L["kind"] in (
        "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate") else 1
    if predictor not in (1, 2):
        raise OSError(_BROKEN)
    tabs = ycbcr_tables(tags)
    xsize, ysize, w, h = L["xsize"], L["ysize"], L["w"], L["h"]
    out = np.zeros((ysize, xsize, 3), np.uint8)
    across = -(-xsize // w) if L["tiled"] else 1
    per_plane = across * -(-ysize // h)
    for ty in range(-(-ysize // h)):
        y0 = ty * h
        rows = min(h, ysize - y0)
        for tx in range(across):
            k = ty * across + tx
            cols = w if L["tiled"] else xsize
            n_rows = h if L["tiled"] else rows
            if planar:
                ycc = []
                for p in range(3):
                    buf = decode_chunk(p * per_plane + k, n_rows * cols)
                    if predictor == 2:
                        buf = _hor_acc8(buf, cols, 1)
                    ycc.append(np.frombuffer(buf, np.uint8, n_rows * cols)
                               .reshape(n_rows, cols))
            else:
                units = -(-cols // hs) * (hs * vs + 2)
                buf = decode_chunk(k, -(-n_rows // vs) * units)
                if predictor == 2:
                    buf = _hor_acc8(buf, cols * 3 if L["tiled"]
                                    else units // vs, 3)
                ycc = units_to_planes(buf, n_rows, cols, hs, vs)
            x0 = tx * w
            nc = min(cols, xsize - x0)
            out[y0:y0 + rows, x0:x0 + nc] = \
                ycbcr_to_rgb(*ycc, tabs)[:rows, :nc]
    return out


# ------------------------------------------------- compression 7 ----
def jpeg_image(data, tags, L, photo: int) -> np.ndarray:
    """Compression 7: each strip or tile's JPEG stream through io/jpeg.py
    as libtiff's JPEGPreDecode sets it up (one component per stream in
    PlanarConfiguration 2) -> (H, W, 3) uint8 before exif_transpose."""
    spp = len(L["bps"])
    planar = L["planar"] == 2
    ycc = photo == 6
    tables = tags.get(JPEG_TABLES, (b"",))[0] if JPEG_TABLES in tags else b""
    xsize, ysize, w, h = L["xsize"], L["ysize"], L["w"], L["h"]
    across = -(-xsize // w) if L["tiled"] else 1
    per_plane = across * -(-ysize // h)

    def chunk(k, ncomp, hs, vs, convert):
        """Strip or tile k -> (rows, columns, ncomp) uint8."""
        y0 = (k % per_plane) // across * h
        seg_w = w if L["tiled"] else xsize
        seg_h = h if L["tiled"] else min(h, ysize - y0)
        off = L["offsets"][k]
        cnt = L["counts"][k] if k < len(L["counts"]) else 0
        return _jpeg_chunk(data[off:off + cnt], tables, seg_w, seg_h, ncomp,
                           L["bps"][0], convert, hs, vs,
                           not L["tiled"] and y0 + seg_h == ysize)

    if planar and ycc:       # TiffDecode.c reads it through TIFFRGBAImage
        return rgba_image(tags, L, lambda k, occ: chunk(k, 1, 1, 1, False)
                          .tobytes())
    hs, vs = _subsampling(tags) if ycc else (1, 1)
    out = np.zeros((ysize, xsize, spp), np.uint8)
    for plane in range(spp if planar else 1):
        for i in range(per_plane):
            k = plane * per_plane + i
            if k >= len(L["offsets"]):
                break
            ty, tx = divmod(i, across)
            y0, x0 = ty * h, tx * w
            px = chunk(k, 1, 1, 1, False) if planar \
                else chunk(k, spp, hs, vs, ycc and spp == 3)
            rows, cols = min(h, ysize - y0), min(w, xsize - x0)
            sl = slice(plane, plane + 1) if planar else slice(None)
            out[y0:y0 + rows, x0:x0 + cols, sl] = px[:rows, :cols]
    if spp == 1:
        return np.repeat(out, 3, -1)
    return out[..., :3]


def _jpeg_chunk(stream, tables, seg_w, seg_h, spp, bits, ycc, hs, vs,
                last_strip) -> np.ndarray:
    """One strip or tile -> (seg_h, seg_w, spp) uint8 (ycc: converted to
    RGB by libjpeg), or OSError where libtiff's JPEGPreDecode or
    JPEGDecode fails."""
    try:
        d = jpeg.decode_jpeg(stream, tables=tables)
    except (OSError, ValueError) as err:   # decode_jpeg's refusals
        raise OSError(_BROKEN) from err
    fr = d["frame"]
    width, height = fr["w"], fr["h"]
    if width == seg_w and height > seg_h and last_strip:
        height = seg_h                   # libtiff trims a tall last strip
    comps = fr["comps"]
    if width > seg_w or height > seg_h or len(comps) != spp \
            or fr["precision"] != bits or (fr["lossless"] and ycc):
        raise OSError(_BROKEN)         # no colour conversion in lossless
    if (comps[0]["h"], comps[0]["v"]) != (hs, vs) \
            or any(c["h"] != 1 or c["v"] != 1 for c in comps[1:]):
        raise OSError(_BROKEN)
    if height < seg_h:                   # too few scanlines for the strip
        raise OSError(_BROKEN)
    planes = [p[:height] for p in d["planes"]]
    if ycc:
        px = jpeg.ycc_to_rgb(*planes)
    else:
        px = np.stack(planes, -1)
    out = np.zeros((seg_h, seg_w, spp), np.uint8)
    out[:height, :width] = px
    return out


# ------------------------------------------------- compression 6 ----
def ojpeg_image(data, tags, L, photo: int) -> np.ndarray:
    """Compression 6 whose stream starts with SOI, read as libtiff's
    tif_ojpeg.c reads it -> (H, W, 3) uint8 before exif_transpose."""
    if photo in (None, 2):           # TIFFReadDirectory's OJPEG fix-up
        photo = 6
    # tif_ojpeg.c reads one stream: the JPEGInterchangeFormat bytes, then
    # every strip's
    stream = b""
    if JIF in tags:
        at = tags.get(JIF)[0]
        stream = data[at:at + tags.get(JIF_LENGTH, (len(data) - at,))[0]]
    counts = list(L["counts"])
    stream += b"".join(data[o:o + (counts[k] if k < len(counts) else 0)]
                       for k, o in enumerate(L["offsets"]))
    if not stream.startswith(b"\xff\xd8"):
        raise not_ported("old-style JPEG TIFF files with their tables in "
                         "tags 519-521", "Queue 1 M9")
    spp = len(L["bps"])
    try:
        d = jpeg.decode_jpeg(stream, upsample=False)
    except (OSError, ValueError) as err:   # decode_jpeg's refusals
        raise OSError(_BROKEN) from err
    fr = d["frame"]
    if (fr["w"], fr["h"]) != (L["xsize"], L["ysize"]) \
            or len(fr["comps"]) != spp or fr["lossless"] \
            or L["planar"] != 1:
        raise not_ported("this form of old-style JPEG TIFF file",
                         "Queue 1 M9")
    if spp == 1:
        if photo == 6:
            raise OSError(_BROKEN)
        return np.repeat(d["planes"][0][..., None], 3, -1)
    if photo != 6:
        raise not_ported("old-style JPEG TIFF files of photometric "
                         f"{photo}", "Queue 1 M9")
    c0 = fr["comps"][0]
    hs, vs = c0["h"], c0["v"]
    if any(c["h"] != 1 or c["v"] != 1 for c in fr["comps"][1:]) \
            or (hs, vs) not in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1),
                                (4, 2), (4, 4)):
        raise not_ported("old-style JPEG TIFF files that libtiff "
                         "desubsamples itself", "Queue 1 M9")
    y, cb, cr = d["planes"]
    H, W = fr["h"], fr["w"]
    Hp, Wp = -(-H // vs) * vs, -(-W // hs) * hs
    y = np.pad(y, ((0, Hp - y.shape[0]), (0, Wp - y.shape[1])), "edge")
    cb = np.repeat(np.repeat(cb, vs, 0), hs, 1)[:H, :W]
    cr = np.repeat(np.repeat(cr, vs, 0), hs, 1)[:H, :W]
    return ycbcr_to_rgb(y[:H, :W], cb, cr, ycbcr_tables(tags))
