"""JPEG 2000 files (tests/torch_j2k_files), held to the JAX package's
read_image (Pillow 12.1 through OpenJPEG 2.5.4) bit for bit:

- every file of torch_j2k_files.files(): Pillow's writer over its options
  (5/3 and 9/7, MCT, layers, tiles with offsets, precincts, the five
  progressions, code-block sizes, resolutions, signed, PLT, cinema) and
  the composer's (the six code-block style switches, SOP / EPH, POC,
  PPM, PPT, tile-parts, RGN, COC / QCC, precisions 1 to 16, 4:2:0 sYCC,
  pclr palettes, CMYK, ICC colours), through lrt.read_image against
  jimage.read_image, and the image before convert("RGB") against
  Pillow's (mode and pixels); the files Pillow refuses, refused with its
  class;
- cuts and single-byte mutations of some of them: the same stage and
  exception class as Pillow's, or the same pixels;
- the plain tier-1 loops (`j2k_t1._t1_plain`, `_t1_enc_plain`) equal to
  csrc/j2k_t1.cpp: decoding every code-block of the small files, and
  encoding seeded code-blocks under every style switch.
"""
import io

import numpy as np
import pytest
from PIL import Image

import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu.io import image as jimage
from liverrenderer_tpu_torch.io import j2k_t1, jpeg2000, pil_open
import torch_j2k_files as j2f
import torch_tiff_files as tf
from torch_threads import torch_threads_per_worker  # noqa: F401

FILES = j2f.files()


def _raw(data: bytes) -> np.ndarray:
    """The port's image before convert("RGB"), as Pillow's array shows
    it (LA / PA as two bands, RGB as three)."""
    codec = "j2k" if data.startswith(b"\xff\x4f") else "jp2"
    im = Image.open(io.BytesIO(data))
    px = jpeg2000.decode(data, codec, im.mode, im.size)
    mode = im.mode
    if mode in ("LA", "PA"):
        return px[..., [0, 3]]
    return px[..., :3] if mode == "RGB" else px


@pytest.mark.parametrize("name", sorted(FILES))
def test_file(tmp_path, name):
    p = tmp_path / ("f.j2k" if FILES[name][:2] == b"\xff\x4f" else "f.jp2")
    p.write_bytes(FILES[name])
    if name.endswith("_fails"):
        with pytest.raises(OSError):
            jimage.read_image(str(p), False)
        with pytest.raises(OSError):
            lrt.read_image(str(p), False)
        return
    ref = jimage.read_image(str(p), False)
    np.testing.assert_array_equal(lrt.read_image(str(p), False), ref)
    im = Image.open(str(p))
    got = _raw(FILES[name])
    np.testing.assert_array_equal(got, np.asarray(im))


def _agree(data: bytes) -> bool:
    want, got = tf.stage(data, True), tf.stage(data, False)
    if want[0] == "ok":
        return got[0] == "ok" and np.array_equal(got[1], want[1])
    return want == got


@pytest.mark.parametrize("name", ["rev_L", "irr_mct", "sty_all", "ppm",
                                  "sop_eph", "pclr", "ycc420_jp2",
                                  "tile_parts"])
def test_cuts_and_mutations(name):
    good = FILES[name]
    for cut in range(0, len(good), max(1, len(good) // 40)):
        assert _agree(good[:cut]), cut
    rng = np.random.default_rng(9)
    for _ in range(80):
        d = bytearray(good)
        k = int(rng.integers(0, len(d)))
        d[k] = int(rng.integers(0, 256))
        assert _agree(bytes(d)), k


def test_plain_tier1_equals_cpp():
    """Every code-block of the small files, as tier-2 hands them over:
    the same coefficients from both loops."""
    seen = 0
    for name in ("rev_RGB", "irr_mct", "layers", "sty_all", "sty_lazy",
                 "sty_vsc", "rgn", "prec16", "floor"):
        data = FILES[name]
        blocks = []
        real = jpeg2000.j2k_t1.decode_blocks

        def grab(bl):
            blocks.extend(bl)
            return real(bl)
        jpeg2000.j2k_t1.decode_blocks = grab
        try:
            pil_open.open_jpeg2000(data)()
        finally:
            jpeg2000.j2k_t1.decode_blocks = real
        for blk, cpp in zip(blocks, j2k_t1.decode_blocks(blocks)):
            np.testing.assert_array_equal(j2k_t1._t1_plain(*blk), cpp)
            seen += 1
    assert seen > 100


@pytest.mark.parametrize("style", [0, 1, 2, 4, 8, 16, 32, 63])
def test_plain_encoder_equals_cpp(style):
    """Each orientation and a few shapes (a partial stripe, a 4-row
    stripe, a full code-block): the same passes, rates and bytes."""
    rng = np.random.default_rng(style)
    for shape in ((1, 1), (3, 7), (4, 4), (13, 9), (64, 64)):
        for orient in range(4):
            c = rng.integers(-300, 300, shape) * (rng.random(shape) < 0.6)
            assert j2k_t1._t1_enc_plain(c, orient, style) == \
                j2k_t1.encode_block(c, orient, style), (shape, orient)
