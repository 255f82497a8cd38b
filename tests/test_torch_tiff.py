"""The port's TIFF reader and writer (liverrenderer_tpu_torch/io/tiff.py,
through read_image / write_image) against the JAX package's, which reads
and writes TIFF through Pillow (and libtiff for compressed files): equal
bit for bit (tolerance 0) on files Pillow writes and on files
tests/torch_raster_files.py builds in the layouts Pillow cannot save (big
endian, BigTIFF, tiles, planar configuration 2, PackBits, predictors 2
and 3, fill order 2, every sample kind of Pillow's mode table).  Where
Pillow refuses a file (a big-endian BigTIFF, say) the port raises the
same exception class.  The C++ LZW loop equals its plain version, and a
source that does not compile raises.
"""
import io

import numpy as np
import pytest
from PIL import Image, TiffImagePlugin

import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu.io import image as jimage
from liverrenderer_tpu_torch.io import lzw, tiff
import torch_raster_files as rf
from torch_threads import torch_threads_per_worker  # noqa: F401

H, W = 11, 13
TOL = 0           # bit for bit


def _expected_error(e: Exception):
    """Pillow's UnidentifiedImageError is an OSError; the port raises
    OSError there."""
    return OSError if isinstance(e, OSError) else type(e)


def same_as_jax(path, srgb=False):
    """The port reads `path` as the JAX package does, or raises the same
    exception class."""
    try:
        ref = jimage.read_image(str(path), srgb_to_linear=srgb)
    except Exception as e:               # noqa: BLE001 - held to the port
        with pytest.raises(_expected_error(e)):
            lrt.read_image(str(path), srgb_to_linear=srgb)
        return None
    img = lrt.read_image(str(path), srgb_to_linear=srgb)
    assert img.dtype == ref.dtype and img.shape == ref.shape
    np.testing.assert_allclose(img, ref, rtol=0, atol=TOL)
    return img


def _samples(kind, rng):
    """(samples, write_tiff's keywords) of one sample kind."""
    if kind == "rgb8":
        return rng.integers(0, 256, (H, W, 3)).astype(np.uint8), \
            dict(photometric=2)
    if kind.startswith("rgba8"):
        extra = {"rgba8_unassoc": (2,), "rgba8_assoc": (1,),
                 "rgba8_x": (0,)}[kind]
        return rng.integers(0, 256, (H, W, 4)).astype(np.uint8), \
            dict(photometric=2, extra=extra)
    if kind == "rgb16":
        return rng.integers(0, 65536, (H, W, 3)).astype(np.uint16), \
            dict(photometric=2)
    if kind == "rgba16_assoc":
        return rng.integers(0, 65536, (H, W, 4)).astype(np.uint16), \
            dict(photometric=2, extra=(1,))
    if kind == "grey16":
        return rng.integers(0, 700, (H, W)).astype(np.uint16), \
            dict(photometric=1)
    if kind == "int16":
        return rng.integers(-200, 400, (H, W)).astype(np.int16), \
            dict(photometric=1, sample_format=2)
    if kind == "int32":
        return rng.integers(-200, 400, (H, W)).astype(np.int32), \
            dict(photometric=1, sample_format=2)
    if kind == "float32":
        f = rng.uniform(-20, 300, (H, W)).astype(np.float32)
        f[0, :3] = (np.nan, np.inf, -np.inf)
        return f, dict(photometric=1, sample_format=3)
    if kind == "cmyk8":
        return rng.integers(0, 256, (H, W, 4)).astype(np.uint8), \
            dict(photometric=5)
    raise ValueError(kind)


_KINDS = ["rgb8", "rgba8_unassoc", "rgba8_assoc", "rgba8_x", "rgb16",
          "rgba16_assoc", "grey16", "int16", "int32", "float32", "cmyk8"]
_CODECS = [(1, 1), (5, 1), (5, 2), (8, 1), (8, 2), (32946, 2), (32773, 1),
           (32773, 2)]


@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("compression,predictor", _CODECS)
def test_sample_kinds_and_codecs(tmp_path, kind, compression, predictor):
    """Every sample kind under every codec (PackBits ignores a predictor,
    as libtiff does), little-endian strips of 4 rows."""
    rng = np.random.default_rng(19)
    s, kw = _samples(kind, rng)
    p = tmp_path / "t.tif"
    p.write_bytes(rf.write_tiff(s, compression=compression,
                                predictor=predictor, rows_per_strip=4, **kw))
    same_as_jax(p)


@pytest.mark.parametrize("order", ["II", "MM"])
@pytest.mark.parametrize("bigtiff", [False, True])
@pytest.mark.parametrize("layout", ["one_strip", "strips", "tiles"])
@pytest.mark.parametrize("planar", [1, 2])
@pytest.mark.parametrize("compression", [1, 5, 8])
def test_layouts(tmp_path, order, bigtiff, layout, planar, compression):
    """Byte order, classic and BigTIFF (Pillow reads a big-endian one as
    classic and gives it up), strips and 16 x 16 tiles with padded edge
    tiles, both planar configurations, raw, LZW (predictor 2) and
    Deflate."""
    rng = np.random.default_rng(20)
    rgb = rng.integers(0, 256, (19, 23, 3)).astype(np.uint8)
    kw = {"one_strip": {}, "strips": {"rows_per_strip": 5},
          "tiles": {"tile": (16, 16)}}[layout]
    pred = 2 if compression == 5 else 1
    p = tmp_path / "t.tif"
    p.write_bytes(rf.write_tiff(rgb, 2, order, bigtiff, planar=planar,
                                compression=compression, predictor=pred,
                                **kw))
    same_as_jax(p)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("photometric", [0, 1, 3])
@pytest.mark.parametrize("compression", [1, 5, 32773])
def test_low_bit_depths(tmp_path, bits, photometric, compression):
    """1-, 2-, 4- and 8-bit min-is-white, min-is-black and palette images
    (the palette's 16-bit entries >> 8, as Pillow reads them)."""
    rng = np.random.default_rng(21)
    v = rng.integers(0, 1 << bits, (H, W)).astype(np.uint8)
    cmap = rng.integers(0, 65536, (1 << bits, 3)) if photometric == 3 \
        else None
    p = tmp_path / "t.tif"
    p.write_bytes(rf.write_tiff(v, photometric, bits=bits, colormap=cmap,
                                compression=compression, rows_per_strip=7))
    same_as_jax(p)


_PLANAR_KINDS = {"rgb16": (2, (), np.uint16), "rgba_assoc": (2, (1,), None),
                 "rgba": (2, (2,), None), "rgbx": (2, (0,), None),
                 "grey_alpha": (1, (2,), None), "cmyk": (5, (), None)}


@pytest.mark.parametrize("kind", sorted(_PLANAR_KINDS))
@pytest.mark.parametrize("compression", [1, 5, 32773])
@pytest.mark.parametrize("layout", ["strips", "tiles"])
def test_planar_2_samples(tmp_path, kind, compression, layout):
    """PlanarConfiguration 2 beyond 8-bit RGB: Pillow's own decoder (raw
    files) unpacks each layer with one letter of the rawmode, 8 bits a
    sample, and refuses alpha's and pad's letters; its libtiff decoder
    refuses a planar pad sample."""
    photo, extra, dt = _PLANAR_KINDS[kind]
    rng = np.random.default_rng(33)
    n = {2: 3, 1: 1, 5: 4}[photo] + len(extra)
    s = rng.integers(0, 65536 if dt else 256, (19, 23, n)).astype(
        dt or np.uint8)
    kw = {"strips": {"rows_per_strip": 5}, "tiles": {"tile": (16, 16)}}
    p = tmp_path / "t.tif"
    p.write_bytes(rf.write_tiff(s, photo, planar=2, extra=extra,
                                compression=compression, **kw[layout]))
    same_as_jax(p)


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("compression", [1, 5])
def test_low_bit_tiles(tmp_path, bits, compression):
    rng = np.random.default_rng(34)
    p = tmp_path / "t.tif"
    p.write_bytes(rf.write_tiff(rng.integers(0, 1 << bits, (19, 23)).astype(
        np.uint8), 1, bits=bits, compression=compression, tile=(16, 16)))
    same_as_jax(p)


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
@pytest.mark.parametrize("kind", ["rgb", "bilevel"])
def test_fill_order_2(tmp_path, compression, kind):
    """FillOrder 2: Pillow reverses the bits of raw samples; libtiff those
    of the coded bytes."""
    rng = np.random.default_rng(22)
    if kind == "rgb":
        data = rf.write_tiff(rng.integers(0, 256, (H, W, 3)).astype(
            np.uint8), 2, compression=compression, fill_order=2)
    else:
        data = rf.write_tiff(rng.integers(0, 2, (H, W)).astype(np.uint8), 1,
                             bits=1, compression=compression, fill_order=2)
    p = tmp_path / "t.tif"
    p.write_bytes(data)
    same_as_jax(p)


@pytest.mark.parametrize("order", ["II", "MM"])
@pytest.mark.parametrize("compression", [5, 8])
def test_float_predictor_3(tmp_path, order, compression):
    rng = np.random.default_rng(23)
    f = rng.uniform(-20, 300, (H, W)).astype(np.float32)
    p = tmp_path / "t.tif"
    p.write_bytes(rf.write_tiff(f, 1, order, compression=compression,
                                predictor=3, sample_format=3,
                                rows_per_strip=4))
    same_as_jax(p)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_tag(tmp_path, orientation):
    """The Orientation tag applied as Pillow's exif_transpose does."""
    rng = np.random.default_rng(24)
    p = tmp_path / "t.tif"
    p.write_bytes(rf.write_tiff(rng.integers(0, 256, (H, W, 3)).astype(
        np.uint8), 2, orientation=orientation, compression=5))
    same_as_jax(p)


_PIL_MODES = ["RGB", "RGBA", "L", "1", "P", "I;16", "I", "F", "CMYK", "LA"]


@pytest.mark.parametrize("compression", [None, "tiff_lzw",
                                         "tiff_adobe_deflate", "packbits"])
def test_pil_written_files(tmp_path, compression):
    """Every mode Pillow saves as TIFF, uncompressed and with libtiff's
    codecs, LZW also with predictor 2 (not on 1-bit samples, which
    libtiff's predictor refuses)."""
    rng = np.random.default_rng(25)
    rgb = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    for mode in _PIL_MODES:
        if mode == "I;16":
            im = Image.fromarray(rng.integers(0, 600, (H, W)).astype(
                np.uint16))
        elif mode == "I":
            im = Image.fromarray(rng.integers(-9, 600, (H, W)).astype(
                np.int32))
        elif mode == "F":
            im = Image.fromarray(rng.uniform(-9, 300, (H, W)).astype(
                np.float32))
        elif mode == "P":
            im = Image.fromarray(rgb).convert(
                "P", palette=Image.Palette.ADAPTIVE, colors=60)
        else:
            im = Image.fromarray(rgb).convert(mode)
        kw = {} if compression is None else {"compression": compression}
        if compression == "tiff_lzw" and mode != "1":   # libtiff: 8+ bits
            kw["tiffinfo"] = {317: 2}
        p = tmp_path / f"{mode.replace(';', '')}.tif"
        im.save(p, **kw)
        same_as_jax(p)


def test_open_info_is_pillows():
    """The port's copy of Pillow's TIFF mode table equals Pillow's."""
    mine = {(k[0].encode(),) + k[1:]: v for k, v in tiff.OPEN_INFO.items()}
    assert mine == dict(TiffImagePlugin.OPEN_INFO)


@pytest.mark.parametrize("shape", [(5, 7, 3), (6, 8, 4), (5, 7),
                                   (300, 230, 3)])
def test_writer_bytes_equal_pillows(tmp_path, shape):
    """write_image(.tif / .tiff) writes the bytes JAX's write_image writes
    (Pillow's default save: uncompressed, one strip)."""
    rng = np.random.default_rng(26)
    img = rng.uniform(0, 1.2, shape).astype(np.float32)
    for ext in (".tif", ".tiff"):
        a, b = tmp_path / f"port{ext}", tmp_path / f"jax{ext}"
        lrt.write_image(str(a), img)
        if len(shape) == 3:
            jimage.write_image(str(b), img)
        else:          # the port's grey write (ROADMAP Queue 3):
            # Pillow's bytes for the port's own 8-bit pixels
            b.write_bytes(_pil_bytes(np.asarray(Image.open(a)), "TIFF"))
        assert a.read_bytes() == b.read_bytes()
        same_as_jax(a)


def _pil_bytes(px, fmt):
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, fmt)
    return buf.getvalue()


# ------------------------------------------------------------- LZW ----
def _streams():
    rng = np.random.default_rng(27)
    out = [b"", bytes(1), bytes(rng.integers(0, 256, 5000, dtype=np.uint8)),
           bytes(20000),                      # long runs: KwKwK codes
           bytes(np.repeat(rng.integers(0, 4, 3000), 3).astype(np.uint8)),
           bytes(rng.integers(0, 256, 12000, dtype=np.uint8))]  # clears
    return out


@pytest.mark.parametrize("k", range(6))
def test_lzw_tiff_native_equals_plain(k):
    raw = _streams()[k]
    code = rf.lzw_encode_tiff(raw)
    for occ in (len(raw), max(len(raw) - 7, 0), len(raw) + 10):
        a = lzw.lzw_tiff(code, occ)
        assert a == lzw._lzw_tiff_plain(code, occ)
        assert a == raw[:occ]
    # a stream cut short stops short, both ways
    cut = code[:len(code) // 2]
    assert lzw.lzw_tiff(cut, len(raw)) == lzw._lzw_tiff_plain(cut, len(raw))


def test_lzw_failed_compile_raises(tmp_path, monkeypatch):
    bad = tmp_path / "lzw_broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(lzw, "_SRC", bad)
    monkeypatch.setattr(lzw, "_LIB", None)
    with pytest.raises(RuntimeError, match="LZW decode"):
        lzw.lzw_tiff(b"\x80\x00", 1)
