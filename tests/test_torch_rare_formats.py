"""The rarer Pillow plugins the port decodes since its twenty-second slice,
held to the JAX package's read_image (Pillow 12.1's Image.open(path) and
convert("RGB")) bit for bit, on files tests/torch_rare_files writes at a
few pixels: FITS (each BITPIX raw, GZIP_1), SPIDER (both byte orders, a
stack), McIdas (each word size, line prefixes), PIXAR, XV thumbnails,
IMT, GIMP brushes (versions 1 and 2, grey and RGBA), IPTC (raw and JPEG
data, whole and one band), PhotoCD (each orientation), the PPM extensions
(Pf, P0CMYK, PyCMYK, PyRGBA, PyP), IM of every type in ImImagePlugin's
table (with and without a grey or colour Lut) and indexed PSD without a
colour table.  Where Pillow raises (a short file, a band out of range, a
mode mismatch, a type without an unpacker) the port raises the same
class: a short file opened by path is Pillow's memory map's ValueError
for the mappable modes and "image file is truncated" (OSError) for the
rest, as the port's rawmode.raw_tile mirrors."""
import io

import numpy as np
import pytest
from PIL import Image, ImImagePlugin, UnidentifiedImageError

import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu.io import image as jimage
from liverrenderer_tpu_torch.io import rawmode
import torch_rare_files as rf
import torch_raster_files as rr
from torch_threads import torch_threads_per_worker  # noqa: F401

RNG = np.random.default_rng(23)
W, H = 5, 3
GREY = RNG.integers(0, 256, (H, W)).astype(np.uint8)
FLOATS = (RNG.random((H, W)) * 300 - 20).astype(np.float32)
RGB = RNG.integers(0, 256, (H, W, 3)).astype(np.uint8)
RGBA = RNG.integers(0, 256, (H, W, 4)).astype(np.uint8)


def _same(tmp_path, data: bytes, name="f.bin", ok=True):
    """The port reads the file as the JAX package does, or raises its
    class (UnidentifiedImageError: the port's OSError); `ok`: Pillow must
    decode (True) or refuse (False) the file, or either (None)."""
    p = tmp_path / name
    p.write_bytes(data)
    try:
        ref = jimage.read_image(str(p), False)
    except Exception as e:                   # noqa: BLE001 - compared below
        assert ok is not True, f"Pillow refused the file: {e!r}"
        want = OSError if isinstance(e, UnidentifiedImageError) else type(e)
        with pytest.raises(want):
            lrt.read_image(str(p), False)
        return None
    assert ok is not False, "Pillow decoded the file"
    np.testing.assert_array_equal(lrt.read_image(str(p), False), ref)
    return ref


# ---------------------------------------------------------------- FITS ----
@pytest.mark.parametrize("bitpix,dt", [(8, ">u1"), (16, ">i2"), (32, ">i4"),
                                       (-32, ">f4"), (-64, ">f8")])
def test_fits_raw(tmp_path, bitpix, dt):
    """BITPIX's mode is Pillow's rawmode: little-endian samples."""
    v = (RNG.random((H, W)) * 300 - 20).astype(dt)
    _same(tmp_path, rf.fits(v.tobytes(), bitpix, W, H))


def test_fits_one_axis_and_short(tmp_path):
    _same(tmp_path, rf.fits(GREY.tobytes(), 8, W * H, 1, naxis=1))
    big = RNG.integers(0, 256, (10, 20)).astype(np.uint8)
    # short: the memory map's ValueError (L), truncated (F)
    _same(tmp_path, rf.fits(big.tobytes()[:120], 8, 20, 10, pad=False),
          ok=False)
    _same(tmp_path, rf.fits(big.astype(">f4").tobytes()[:400], -32, 20, 10,
                            pad=False), ok=False)
    # a data unit under 80 bytes: Pillow's offset falls back into the
    # header's padding, and it decodes from there
    _same(tmp_path, rf.fits(FLOATS.tobytes()[:-8], -32, W, H, pad=False))
    _same(tmp_path, rf.fits_cards(["SIMPLE  = T", "NAXIS   = 0", "END"])
          + b"X" * 80, ok=False)                              # no image


@pytest.mark.parametrize("zbitpix", [8, 16, 32])
def test_fits_gzip(tmp_path, zbitpix):
    words = RNG.integers(-5, 70000, (H, W)).astype(np.int32)
    _same(tmp_path, rf.fits_gzip(words, zbitpix))


def test_fits_gzip_refusals(tmp_path):
    """Negative ZBITPIX keeps no bytes; a short or broken stream."""
    words = RNG.integers(0, 255, (H, W)).astype(np.int32)
    _same(tmp_path, rf.fits_gzip(words, -32), ok=False)
    _same(tmp_path, rf.fits_gzip(words[:2], 8).replace(
        b"ZNAXIS2 =                    2", b"ZNAXIS2 =                    3"),
        ok=False)                                    # too few words
    _same(tmp_path, rf.fits_gzip(words, 8)[:2 * 2880 + 30], ok=False)
    data = bytearray(rf.fits_gzip(words, 8))
    data[2 * 2880 + 8 + 12] ^= 0xFF                  # inside the deflate
    _same(tmp_path, bytes(data), ok=False)


# ---------------------------------------------- SPIDER, McIdas, PIXAR ----
@pytest.mark.parametrize("big", [True, False])
@pytest.mark.parametrize("stack", [False, True])
def test_spider(tmp_path, big, stack):
    data = rf.spider(FLOATS, big, stack)
    _same(tmp_path, data)
    _same(tmp_path, data[:-5], ok=False)


@pytest.mark.parametrize("word", [1, 2, 4])
@pytest.mark.parametrize("prefix", [0, 3])
def test_mcidas(tmp_path, word, prefix):
    v = GREY if word == 1 else RNG.integers(-3, 700, (H, W))
    if word == 2:
        v = np.abs(v)
    data = rf.mcidas(v, word, prefix, 256 + 8 * prefix)
    _same(tmp_path, data)
    _same(tmp_path, data[:-4], ok=False)


def test_pixar_xv_imt(tmp_path):
    _same(tmp_path, rf.pixar(RGB))
    _same(tmp_path, rf.pixar(RGB)[:-2], ok=False)
    ref = _same(tmp_path, rf.xvthumb(GREY))
    pal = np.array([(r * 255 // 7, g * 255 // 7, b * 255 // 3)
                    for r in range(8) for g in range(8) for b in range(4)])
    np.testing.assert_array_equal(ref * 255, pal[GREY] / 1.0)
    _same(tmp_path, rf.xvthumb(GREY)[:-1], ok=False)       # mapped
    _same(tmp_path, rf.imt(GREY))
    _same(tmp_path, rf.imt(GREY, comment=False)[:-2], ok=False)
    _same(tmp_path, rf.imt(GREY)[:-W * H - 1], ok=False)   # no 0x0c: no tile


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("rgba", [False, True])
def test_gbr(tmp_path, version, rgba):
    data = rf.gbr(RGBA if rgba else GREY, version)
    _same(tmp_path, data)
    _same(tmp_path, data[:-1], ok=False)


# ---------------------------------------------------------------- IPTC ----
def _jpeg(img):
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", quality=90)
    return b.getvalue()


JPEG_GREY = _jpeg(np.kron(GREY, np.ones((3, 3), np.uint8)))
JPEG_RGB = _jpeg(RNG.integers(0, 256, (9, 15, 3)).astype(np.uint8))


@pytest.mark.parametrize("case", [
    ("raw L", dict(payload=GREY.tobytes()), True),
    ("raw L in 4-byte fields", dict(payload=GREY.tobytes(), chunk=4), True),
    ("raw short", dict(payload=GREY.tobytes()[:-2]), False),
    ("raw RGB band 0 (3:65 absent)", dict(payload=GREY.tobytes(), layers=3,
                                          component=1), True),
    ("raw RGB band 2", dict(payload=GREY.tobytes(), layers=3, component=1,
                            band=2), True),
    ("raw RGB band 0 (3:65 = 0: the last)", dict(
        payload=GREY.tobytes(), layers=3, component=1, band=0), True),
    ("raw CMYK band 4", dict(payload=GREY.tobytes(), layers=4, component=1,
                             band=4), True),
    ("raw RGB band 4", dict(payload=GREY.tobytes(), layers=3, component=1,
                            band=4), False),
    ("jpeg grey", dict(payload=JPEG_GREY, size=(15, 9), compression=5),
     True),
    ("jpeg colour as L", dict(payload=JPEG_RGB, size=(15, 9),
                              compression=5), True),
    ("jpeg grey band 3", dict(payload=JPEG_GREY, size=(15, 9), layers=3,
                              component=1, compression=5, band=3), True),
    ("jpeg colour band 1", dict(payload=JPEG_RGB, size=(15, 9), layers=3,
                                component=1, compression=5, band=1), False),
    ("jpeg colour band 2", dict(payload=JPEG_RGB, size=(15, 9), layers=3,
                                component=1, compression=5, band=2), False),
], ids=lambda c: c[0])
def test_iptc(tmp_path, case):
    _, kw, ok = case
    kw = dict(kw)
    _same(tmp_path, rf.iptc(kw.pop("payload"), kw.pop("size", (W, H)),
                            **kw), ok=ok)


# ----------------------------------------------------------------- PCD ----
@pytest.mark.parametrize("orientation", [0, 1, 2, 3])
def test_pcd(tmp_path, orientation):
    """PhotoYCC through Pillow's YCC;P tables, then load_end's rotation."""
    ycc = RNG.integers(0, 256, (512, 768, 3)).astype(np.uint8)
    ref = _same(tmp_path, rf.pcd(ycc, orientation))
    assert ref.shape == ((768, 512, 3) if orientation % 2 else
                         (512, 768, 3))


def test_pcd_short_and_ycc_tables(tmp_path):
    _same(tmp_path, rf.pcd(np.zeros((512, 768, 3), np.uint8))[:-100],
          ok=False)
    v = np.arange(1 << 24, dtype=np.uint32)[::97]
    px = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1) \
        .astype(np.uint8)
    pil = Image.frombytes("RGB", (len(px), 1), px.tobytes(), "raw", "YCC;P")
    np.testing.assert_array_equal(rawmode.photoycc_to_rgb(px),
                                  np.asarray(pil)[0])
    pil = Image.frombytes("YCbCr", (len(px), 1), px.tobytes()) \
        .convert("RGB")
    np.testing.assert_array_equal(rawmode.ycbcr_to_rgb(px),
                                  np.asarray(pil)[0])


# ---------------------------------------------------------------- PPM ----
C4 = RNG.integers(0, 256, (H, W, 4)).astype(np.uint8)


@pytest.mark.parametrize("magic", [b"P0CMYK", b"PyCMYK", b"PyRGBA"])
@pytest.mark.parametrize("maxval", [255, 200, 1000])
def test_ppm_four_bands(tmp_path, magic, maxval):
    s = np.minimum(C4, 200) if maxval == 200 else \
        C4.astype(np.int64) * 3 if maxval == 1000 else C4
    data = rf.ppm_ext(magic, s, maxval)
    _same(tmp_path, data, "f.ppm")
    _same(tmp_path, data[:-3], "f.ppm", ok=False)


@pytest.mark.parametrize("scale", [-1.0, 2.5])
def test_ppm_pf_and_pyp(tmp_path, scale):
    data = rf.ppm_ext(b"Pf", FLOATS, scale=scale)
    _same(tmp_path, data, "f.ppm")
    _same(tmp_path, data[:-1], "f.ppm", ok=False)
    _same(tmp_path, rf.ppm_ext(b"PyP", GREY, 255 if scale < 0 else 100),
          "f.ppm")
    for bad in (b"0", b"nan", b"x"):
        _same(tmp_path, b"Pf\n5 3\n" + bad + b"\n" + bytes(60), "f.ppm",
              ok=False)


# ------------------------------------------------------------------ IM ----
BODY = RNG.integers(0, 256, 4 * W * H * 3).astype(np.uint8).tobytes()
LUTS = {"none": None, "grey": bytes(range(256)) * 3,
        "grey nonlinear": bytes(range(255, -1, -1)) * 3,
        "colour": RNG.integers(0, 256, 768).astype(np.uint8).tobytes()}


@pytest.mark.parametrize("kind", list(ImImagePlugin.OPEN)
                         + ["Foo image", "P", "RGB", "L"])
def test_im_types(tmp_path, kind):
    """Every type of ImImagePlugin.OPEN (and bare mode names), with each
    kind of Lut, whole and short."""
    for lut in LUTS.values():
        for body in (BODY, BODY[:7]):
            _same(tmp_path, rf.im(kind, body, (W, H), lut), "f.im",
                  ok=None)


# -------------------------------------------------------------- PSD ----
@pytest.mark.parametrize("rle", [False, True])
def test_psd_indexed_without_table(tmp_path, rle):
    ref = _same(tmp_path, rr.write_psd(GREY[None], 2, rle=rle))
    assert not ref.any()                  # Pillow's empty palette: black
