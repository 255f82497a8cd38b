"""The port's JPEG 2000 writer held to the JAX package's write_image
(Pillow 12.1's save through OpenJPEG 2.5.4 with its defaults) byte for
byte: RGB and RGBA float images from 1 x 1 up to 300 x 200 (six
resolution levels), to each of Pillow's six JPEG 2000 extensions (only
.j2k a bare codestream), and grey (mode L) images through encode_8bit
against Image.fromarray(px).save (the JAX package writes no grey 8-bit
image).  Every file reads back through Pillow as the dithered pixels."""
import numpy as np
import pytest
from PIL import Image

import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu.io import image as jimage
from liverrenderer_tpu_torch.io.image import dither_8bit, encode_8bit
from torch_threads import torch_threads_per_worker  # noqa: F401

EXTS = [".jp2", ".j2k", ".jpc", ".jpf", ".jpx", ".j2c"]
SIZES = [(1, 1), (2, 3), (7, 5), (17, 12), (64, 33), (300, 200)]


@pytest.mark.parametrize("ext", EXTS)
def test_write_matches_jax(tmp_path, ext):
    rng = np.random.default_rng(len(ext) + ord(ext[-1]))
    for w, h in SIZES:
        for ch in (3, 4):
            img = (rng.random((h, w, ch)) ** 2 * 1.3).astype(np.float32)
            if w > 30:
                img[: h // 2, : w // 3] = 0.25       # a smooth patch
            mine, ref = tmp_path / f"t{ext}", tmp_path / f"j{ext}"
            lrt.write_image(str(mine), img)
            jimage.write_image(str(ref), img)
            assert mine.read_bytes() == ref.read_bytes(), (w, h, ch)
            back = np.asarray(Image.open(str(mine)))
            np.testing.assert_array_equal(back, dither_8bit(img))


@pytest.mark.parametrize("ext", [".jp2", ".j2k"])
def test_grey_matches_pillow(tmp_path, ext):
    rng = np.random.default_rng(3)
    for w, h in SIZES:
        px = rng.integers(0, 256, (h, w)).astype(np.uint8)
        ref = tmp_path / f"p{ext}"
        Image.fromarray(px).save(str(ref))
        assert encode_8bit(px, "JPEG2000", str(ref)) == ref.read_bytes()
        np.testing.assert_array_equal(np.asarray(Image.open(str(ref))), px)
