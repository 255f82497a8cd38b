"""JPEG-in-TIFF and YCbCr TIFF (liverrenderer_tpu_torch/io/tiff.py and
io/tiff_ycbcr.py, through read_image) against the JAX package, which
reads them through Pillow 12.1 and libtiff 4.7.1: equal 8-bit values bit
for bit (tolerance 0), or the same exception class.  Each decoded file is
also opened and converted by Pillow on the same bytes.

- Compression 7: Pillow's RGB, grey and YCbCr files at several qualities;
  tests/torch_jpeg_files.py's YCbCr files at 4:2:0, 4:2:2 and 4:4:4 in
  strips and tiles, with and without JPEGTables, big-endian, RGB and grey
  ones, planar ones (one stream per plane), lossless strips, and streams
  whose sampling differs from YCbCrSubsampling or lossless YCbCr
  (libtiff's "decoder error").
- Photometric YCbCr under no compression (Pillow's raw "RGBX" reader
  runs out of data: "image file is truncated"), LZW, Deflate and
  PackBits, at every subsampling TIFFRGBAImage reads, with predictor 2,
  as three planes, with ReferenceBlackWhite, YCbCrCoefficients and the
  Orientation tag.
- Compression 6 whose strip is a whole JPEG stream, through
  JPEGInterchangeFormat or not: 4:2:0, 4:2:2, 4:4:4, grey and a file
  whose photometric tag says RGB.
"""
import io

import numpy as np
import pytest
from PIL import Image

from liverrenderer_tpu_torch.io import jpeg
import torch_jpeg_files as jf
from test_torch_tiff import same_as_jax
from torch_threads import torch_threads_per_worker  # noqa: F401

H, W = 37, 45


def _rgb(seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 5 + yy * 3) % 256, (xx * xx + yy) % 256,
                    (yy * 7) % 256], -1)
    return np.clip(img + rng.integers(-20, 20, img.shape), 0,
                   255).astype(np.uint8)


def _check(tmp_path, data: bytes, decodes=True):
    p = tmp_path / "t.tif"
    p.write_bytes(data)
    if decodes:
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = same_as_jax(p)
    assert (got is not None) == decodes
    return got


# ----------------------------------------------------- compression 7 ----
@pytest.mark.parametrize("quality", [30, 75, 95])
@pytest.mark.parametrize("mode", ["RGB", "L", "YCbCr"])
def test_pillow_jpeg_tiffs(tmp_path, mode, quality):
    f = io.BytesIO()
    Image.fromarray(_rgb(quality)).convert(mode).save(
        f, "TIFF", compression="jpeg", quality=quality)
    _check(tmp_path, f.getvalue())


_JPEG_TIFFS = {
    "ycc_420": dict(),
    "ycc_422": dict(sampling=(2, 1)),
    "ycc_444": dict(sampling=(1, 1)),
    "ycc_420_strips": dict(rows=16),
    "ycc_422_strips_odd": dict(sampling=(2, 1), rows=8),
    "ycc_420_tiles": dict(tile=(16, 16)),
    "ycc_422_tiles": dict(sampling=(2, 1), tile=(32, 16)),
    "ycc_420_no_tables": dict(tables=False, rows=24),
    "ycc_420_mm": dict(order="MM", rows=16),
    "rgb": dict(photometric=2),
    "rgb_tiles": dict(photometric=2, tile=(16, 32)),
    "grey": dict(photometric=1, grey=True, rows=8),
    "grey_tiles": dict(photometric=1, grey=True, tile=(16, 16)),
    "tag_11_stream_22": dict(extra={530: (3, [1, 1])}),
    "tag_22_stream_11": dict(sampling=(1, 1), extra={530: (3, [2, 2])}),
    "tag_22_stream_21": dict(sampling=(2, 1), extra={530: (3, [2, 2])}),
    "planar_rgb": dict(photometric=2, planar=True, rows=16),
    "planar_ycc_444": dict(sampling=(1, 1), planar=True),
    "planar_ycc_420_refused": dict(planar=True),
    "lossless_rgb": dict(photometric=2, lossless=True, rows=16),
    "lossless_grey": dict(photometric=1, grey=True, lossless=True),
    "lossless_ycc_refused": dict(sampling=(1, 1), lossless=True),
}


@pytest.mark.parametrize("case", sorted(_JPEG_TIFFS))
def test_jpeg_tiffs(tmp_path, case):
    kw = dict(_JPEG_TIFFS[case])
    img = _rgb(7)
    if kw.pop("grey", False):
        img = img[..., 0]
    _check(tmp_path, jf.tiff_jpeg(img, **kw),
           decodes=not case.startswith("tag_")
           and not case.endswith("refused"))


@pytest.mark.parametrize("precision", [2, 12, 16])
def test_lossless_precision_refused(tmp_path, precision):
    """A lossless grey strip whose frame says another precision than
    BitsPerSample's 8: libtiff's "Improper JPEG data precision"."""
    data = jf.tiff_jpeg(_rgb(7)[..., 0], photometric=1, lossless=True)
    sof = b"\xff\xc3\x00\x0b\x08"
    assert data.count(sof) == 1
    _check(tmp_path, data.replace(sof, sof[:4] + bytes([precision])),
           decodes=False)


# --------------------------------------------------- YCbCr, no JPEG ----
def _ycc(seed):
    return np.stack(jpeg._rgb_to_ycc(_rgb(seed)), -1).astype(np.uint8)


@pytest.mark.parametrize("sampling", [(1, 1), (2, 1), (1, 2), (2, 2),
                                      (4, 1), (4, 2), (4, 4)])
@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
def test_ycbcr_tiffs(tmp_path, compression, sampling):
    rows = 8 if sampling[1] <= 2 else 12
    data = jf.tiff_ycbcr(_ycc(5), sampling, rows=rows,
                         compression=compression)
    _check(tmp_path, data, decodes=compression != 1)


@pytest.mark.parametrize("compression", [None, "tiff_lzw",
                                         "tiff_adobe_deflate", "packbits"])
def test_pillow_ycbcr_tiffs(tmp_path, compression):
    """Pillow's own YCbCr TIFF (1 x 1): libtiff's RGBA path, or, with no
    compression, Pillow's raw reader running out of data."""
    f = io.BytesIO()
    kw = {"compression": compression} if compression else {}
    Image.fromarray(_rgb(6)).convert("YCbCr").save(f, "TIFF", **kw)
    _check(tmp_path, f.getvalue(), decodes=compression is not None)


@pytest.mark.parametrize("case", ["420", "421", "422", "444", "planar_444",
                                  "planar_420_refused", "predictor_3"])
@pytest.mark.parametrize("compression", [5, 8])
def test_ycbcr_predictor_and_planes(tmp_path, compression, case):
    """Predictor 2 on libtiff's scanline rows (a 4:2:2 row of 92 bytes
    fails its stride check, and the undifferenced bytes are converted),
    three planes at 1 x 1 (subsampled planes have no put routine), and
    predictor 3 on integer samples (refused)."""
    samp = {"420": (2, 2), "421": (4, 2), "422": (2, 1), "444": (1, 1),
            "planar_444": (1, 1)}.get(case, (2, 2))
    data = jf.tiff_ycbcr(_ycc(11), samp, rows=8, compression=compression,
                         predictor=3 if case == "predictor_3" else 2,
                         planar=case.startswith("planar"))
    _check(tmp_path, data, decodes=case not in ("planar_420_refused",
                                                "predictor_3"))


@pytest.mark.parametrize("tag", ["refbw", "coefficients", "both"])
def test_ycbcr_conversion_tags(tmp_path, tag):
    kw = {}
    if tag in ("refbw", "both"):
        kw["refbw"] = (16, 235, 128, 240, 128, 240)
    if tag in ("coefficients", "both"):
        kw["coefficients"] = (0.2126, 0.7152, 0.0722)
    _check(tmp_path, jf.tiff_ycbcr(_ycc(8), (2, 2), rows=8, compression=5,
                                   **kw))


@pytest.mark.parametrize("orientation", [2, 3, 4, 6])
def test_ycbcr_orientation(tmp_path, orientation):
    """The Orientation tag on the RGBA path: applied once, by Pillow's
    exif_transpose."""
    data = jf.tiff_ycbcr(_ycc(9), (2, 2), rows=8, compression=8,
                         orientation=orientation)
    _check(tmp_path, data)


# ----------------------------------------------------- compression 6 ----
@pytest.mark.parametrize("case", ["420", "422", "444", "grey",
                                  "photometric_rgb", "no_jif_420",
                                  "no_jif_444"])
def test_old_style_jpeg(tmp_path, case):
    img = _rgb(10)
    if case.startswith("no_jif"):
        data = jf.tiff_ojpeg(img, (2, 2) if case.endswith("420") else (1, 1),
                             jif=False)
    elif case == "grey":
        data = jf.tiff_ojpeg(img[..., 0], photometric=1)
    elif case == "photometric_rgb":
        data = jf.tiff_ojpeg(img, (1, 1), photometric=2)
    else:
        samp = {"420": (2, 2), "422": (2, 1), "444": (1, 1)}[case]
        data = jf.tiff_ojpeg(img, samp)
    _check(tmp_path, data)
