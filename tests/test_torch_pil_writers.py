"""The writers that need Pillow's quantisers and resampler
(liverrenderer_tpu_torch/io/gif.py, ico.py, eps.py, pdf.py, quantize.py,
resample.py and lzw.py's GIF encoder), each against the JAX package's
write_image (which saves through Pillow 12.1) or against Pillow itself on
seeded inputs: tolerance 0 throughout.

- write_image at (H, W, 3) and (H, W, 4) against the JAX write_image:
  GIF, EPS, MPO byte for byte; PDF byte for byte once both files' dates
  carry one value; ICO byte for byte outside its PNG entries, whose
  decoded pixels are equal (Pillow's PNG entries are zlib-ng's deflate
  bytes, the port's the standard zlib's).  Where Pillow refuses, the
  same exception class.  A (H, W) image: the bytes Pillow saves for the
  port's grey pixels (mode L).
- quantize: median cut and fast octree at up to 256 and more colours
  (past 65,536 colours median cut drops low bits), palette and indices
  equal to Image.quantize's; resize and thumbnail with both filters, up
  and down, in L, RGB and RGBA, equal to Image.resize / Image.thumbnail.
- The C++ quantisers and GIF LZW encoder equal their plain versions.
ICNS's case is in tests/test_torch_pil_writers_icns.py.
"""
import io
import os
import re
import time

import numpy as np
import pytest
from PIL import Image

import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu.io import image as jimage
from liverrenderer_tpu_torch.io import gif, image as timage, lzw, pdf
from liverrenderer_tpu_torch.io import quantize, resample
from torch_threads import torch_threads_per_worker  # noqa: F401

SHAPES = [(1, 1, 3), (5, 7, 3), (37, 53, 4), (40, 52, 3)]
_DATE = re.compile(rb"\(D:\d{14}Z\)")


def _image(shape, seed=41):
    """A float image whose 8-bit pixels hold flat runs, smooth ramps and
    noise, with some fully transparent pixels when it has alpha."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1.2, shape).astype(np.float32)
    h, w = shape[:2]
    img[: h // 2, : w // 3] = 0.25
    img[h // 2:, : w // 3] = np.linspace(0, 1, w // 3)[None, :, None]
    if shape[-1] == 4:
        img[..., 3] = np.where(rng.uniform(size=(h, w)) < 0.2, 0.0,
                               img[..., 3])
    return img


def _undate(data: bytes) -> bytes:
    return _DATE.sub(b"(D:20000101000000Z)", data)


def _png_entries_ico(data: bytes):
    """(directory with the entry sizes and offsets zeroed, entries)."""
    n = int.from_bytes(data[4:6], "little")
    head = bytearray(data[:6 + 16 * n])
    entries = []
    for i in range(n):
        o = 6 + 16 * i
        size = int.from_bytes(data[o + 8:o + 12], "little")
        off = int.from_bytes(data[o + 12:o + 16], "little")
        entries.append(data[off:off + size])
        head[o + 8:o + 16] = bytes(8)
    return bytes(head), entries


def _pixels(png: bytes):
    im = Image.open(io.BytesIO(png))
    return im.mode, np.asarray(im)


def assert_ico_equal(got: bytes, want: bytes):
    """The same directory (but for entry sizes and offsets, which follow
    the entries), entries in sequence, and equal decoded PNG pixels."""
    gh, ge = _png_entries_ico(got)
    wh, we = _png_entries_ico(want)
    assert gh == wh
    off = len(gh)
    for i, e in enumerate(ge):
        o = 6 + 16 * i
        assert int.from_bytes(got[o + 8:o + 12], "little") == len(e)
        assert int.from_bytes(got[o + 12:o + 16], "little") == off
        off += len(e)
    assert off == len(got)
    for a, b in zip(ge, we):
        ma, pa = _pixels(a)
        mb, pb = _pixels(b)
        assert ma == mb
        np.testing.assert_array_equal(pa, pb)


def _write_both(tmp_path, ext, img):
    """write_image through both packages to files of the same name ->
    (port bytes, JAX bytes), or None when both refuse alike."""
    os.makedirs(tmp_path / "port", exist_ok=True)
    os.makedirs(tmp_path / "jax", exist_ok=True)
    a, b = tmp_path / "port" / f"out{ext}", tmp_path / "jax" / f"out{ext}"
    try:
        jimage.write_image(str(b), img)
    except Exception as e:               # noqa: BLE001 - Pillow refuses
        with pytest.raises(type(e)):
            lrt.write_image(str(a), img)
        return None
    lrt.write_image(str(a), img)
    return a.read_bytes(), b.read_bytes()


@pytest.mark.parametrize("ext", [".gif", ".eps", ".mpo", ".pdf", ".ico"])
@pytest.mark.parametrize("shape", SHAPES)
def test_writers_match_jax(tmp_path, ext, shape):
    """The port's write_image against the JAX package's (both name the
    file out<ext>: PDF's title)."""
    pair = _write_both(tmp_path, ext, _image(shape))
    if pair is None:
        assert ext in (".eps", ".mpo") and shape[-1] == 4
        return
    got, want = pair
    if ext == ".pdf":
        got, want = _undate(got), _undate(want)
    if ext == ".ico":
        assert_ico_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("ext", [".gif", ".eps", ".mpo", ".pdf", ".ico"])
def test_grey_writes_are_pillows_l_mode(tmp_path, ext):
    """A (H, W) image: the bytes Pillow saves for the port's 8-bit grey
    pixels (mode L)."""
    img = _image((37, 53, 3))[..., 0]
    p = tmp_path / f"out{ext}"
    lrt.write_image(str(p), img)
    q = tmp_path / "pil" / f"out{ext}"          # the same name: PDF's title
    os.makedirs(q.parent)
    Image.fromarray(timage.dither_8bit(img)).save(q)
    got, want = p.read_bytes(), q.read_bytes()
    if ext == ".pdf":
        got, want = _undate(got), _undate(want)
    if ext == ".ico":
        assert_ico_equal(got, want)
    else:
        assert got == want


def test_pdf_dates_are_the_clock(tmp_path):
    """/CreationDate and /ModDate are time.gmtime() at the call."""
    before = time.strftime("%Y%m%d%H%M%S", time.gmtime())
    data = pdf.encode_pdf(np.zeros((4, 5, 3), np.uint8), "x.pdf")
    after = time.strftime("%Y%m%d%H%M%S", time.gmtime())
    dates = [m[3:-2].decode() for m in _DATE.findall(data)]
    assert len(dates) == 2 and all(before <= d <= after for d in dates)
    assert pdf.embedded_stream(data)[0] == "DCTDecode"


# ------------------------------------------------------------ quantisers ----
def _quant_case(name):
    rng = np.random.default_rng(43)
    y, x = np.mgrid[0:120, 0:160]
    if name == "rgb_few":                    # 64 colours
        return (rng.integers(0, 4, (30, 40, 3)) * 60).astype(np.uint8)
    if name == "rgb_noise":                  # 4,096 colours
        return rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    if name == "rgb_ramps":
        return np.stack([x * 255 // 159, y * 255 // 119, (x + y) % 256],
                        -1).astype(np.uint8)
    if name == "rgb_past_65536":             # three low bits dropped
        return rng.integers(0, 256, (300, 300, 3)).astype(np.uint8)
    if name == "rgba_noise":
        a = rng.integers(0, 256, (64, 64, 4)).astype(np.uint8)
        a[::3, ::2, 3] = 0
        return a
    if name == "rgba_few":                   # palette entries left over
        a = (rng.integers(0, 3, (30, 40, 4)) * 120).astype(np.uint8)
        a[..., 3] = np.where(rng.uniform(size=(30, 40)) < 0.3, 0, 255)
        return a
    return np.dstack([np.stack([x * 255 // 159, y * 255 // 119,
                                (x * y) % 256], -1),
                      np.full((120, 160), 255)]).astype(np.uint8)


@pytest.mark.parametrize("name", ["rgb_few", "rgb_noise", "rgb_ramps",
                                  "rgb_past_65536", "rgba_noise",
                                  "rgba_few", "rgba_opaque_ramps"])
def test_quantize_matches_pillow(name):
    """Median cut (RGB) and fast octree (RGBA): Image.quantize's palette
    and indices, from the C++ loops and from their plain versions."""
    px = _quant_case(name)
    im = Image.fromarray(px).quantize()
    bands = 4 if px.shape[2] == 4 else 3
    want_pal = np.frombuffer(bytes(im.palette.palette), np.uint8).reshape(
        -1, bands)
    want_idx = np.asarray(im)
    for pal, idx in (quantize.quantize(px), quantize._quantize_plain(px)):
        np.testing.assert_array_equal(pal, want_pal)
        np.testing.assert_array_equal(idx, want_idx)
    if name == "rgb_past_65536":
        assert quantize._scale(px.reshape(-1, 3)) == 3


@pytest.mark.parametrize("case", ["few", "noise", "past_65536", "rgba"])
def test_gif_bytes_match_pillow(case):
    """encode_gif against Pillow's GIF writer on the quantiser's cases
    (the largest is past 512^2 pixels: no palette optimisation)."""
    px = {"few": lambda: _quant_case("rgb_few"),
          "noise": lambda: _quant_case("rgb_ramps"),
          "past_65536": lambda: np.random.default_rng(44).integers(
              0, 256, (600, 520, 3)).astype(np.uint8),
          "rgba": lambda: _quant_case("rgba_few")}[case]()
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "GIF")
    assert gif.encode_gif(px) == buf.getvalue()


@pytest.mark.parametrize("shape,interlace", [
    ((40, 52), True), ((15, 300), False), ((180, 200), True),
    ((2, 16500), False)])
def test_lzw_gif_encoder_plain_equals_cpp(shape, interlace):
    """The C++ GIF LZW encoder against its plain version: a clear past
    4,096 codes (180 x 200 noise), an encoder buffer wider than 64 KiB
    (16,500 columns), and the decoder reading the codes back."""
    rng = np.random.default_rng(45)
    idx = rng.integers(0, 256 if shape[0] > 100 else 7, shape).astype(
        np.uint8)
    a = lzw.lzw_gif_encode(idx, interlace)
    assert a == lzw._lzw_gif_encode_plain(idx, interlace)
    back = np.zeros(shape, np.uint8)
    lzw.lzw_gif(a + b"\0;", 8, interlace, back)
    np.testing.assert_array_equal(back, idx)


# ------------------------------------------------------------- resampler ----
@pytest.mark.parametrize("kind", [resample.BICUBIC, resample.LANCZOS])
@pytest.mark.parametrize("bands", [0, 3, 4])
@pytest.mark.parametrize("size", [(16, 11), (128, 128), (7, 90)])
def test_resize_matches_pillow(kind, bands, size):
    """Image.resize of a 37 x 53 image down (16 x 11), up (128 x 128) and
    both ways (7 x 90), in L, RGB and RGBA."""
    rng = np.random.default_rng(46)
    shape = (37, 53) if bands == 0 else (37, 53, bands)
    px = rng.integers(0, 256, shape).astype(np.uint8)
    if bands == 4:
        px[..., 3] = np.where(px[..., 3] < 40, 0, px[..., 3])
    f = {resample.BICUBIC: Image.Resampling.BICUBIC,
         resample.LANCZOS: Image.Resampling.LANCZOS}[kind]
    want = np.asarray(Image.fromarray(px).resize(size, f))
    np.testing.assert_array_equal(resample.resize(px, size, kind), want)


@pytest.mark.parametrize("size", [(16, 16), (24, 24), (48, 48), (64, 30),
                                  (256, 256)])
def test_thumbnail_matches_pillow(size):
    """Image.thumbnail(size, LANCZOS, reducing_gap=None) of a 37 x 53 RGBA
    image and a 240 x 428 RGB one: the size kept in aspect, the pixels."""
    rng = np.random.default_rng(47)
    for shape in ((37, 53, 4), (240, 428, 3)):
        px = rng.integers(0, 256, shape).astype(np.uint8)
        im = Image.fromarray(px)
        im.thumbnail(size, Image.Resampling.LANCZOS, reducing_gap=None)
        got = resample.thumbnail(px, size)
        np.testing.assert_array_equal(got, np.asarray(im))


def test_premultiply_round_trip_is_pillows():
    """RGBA -> RGBa -> RGBA on every (colour, alpha) pair, as Pillow's
    convert does."""
    c, a = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    px = np.stack([c, 255 - c, c, a], -1).astype(np.uint8)
    pre = np.asarray(Image.fromarray(px, "RGBA").convert("RGBa"))
    np.testing.assert_array_equal(resample.premultiply(px), pre)
    back = np.asarray(Image.frombytes("RGBa", (256, 256),
                                      px.tobytes()).convert("RGBA"))
    np.testing.assert_array_equal(resample.unpremultiply(px), back)
