"""The slice as a whole: bench.py's workload path (tests/torch_xml_files)
written as Mitsuba XML with a ZSTD-compressed height map (predictor 2,
BUMP's codes) and a floor textured with a Group 4 fax bitmap, loaded by
the port's load_file and by the JAX package's (Pillow and its libtiff read
the files there), on the CPU: every buffer equal as
tests/test_torch_xml_slice holds them, the height map and the floor's
bitmap equal bit for bit, and the 16 x 12 images equal per pixel at that
file's tolerance (>= 99 % of pixels within rtol 1e-3 / atol 1e-4, means
within 1e-3).  The committed files the card's phases read
(tests/data/torch_height*_zstd.tif, torch_height_lzma.tif,
torch_floor_g4.tif and its PNG twin torch_floor_g4.png) hold the pixels
their writer (tests/torch_tiff_files.committed) gives, the port reads them
as the JAX package does, and the plain fax and Zstandard loops equal the
C++ ones on them."""
import os

import numpy as np
import pytest

import liverrenderer_tpu as lr
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu.io import image as jimage
from liverrenderer_tpu_torch.io import tiff_fax, zstd
from liverrenderer_tpu_torch.io.image import read_8bit
from liverrenderer_tpu_torch.scene.liver_proxy import BUMP, height_map
import torch_tiff_files as tf
import torch_xml_files as xf
from test_torch_xml_slice import _assert_images_agree, _assert_scene_equal
from torch_threads import torch_threads_per_worker  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "data")
FILES = ["torch_height_zstd.tif", "torch_height32_zstd.tif",
         "torch_height_lzma.tif", "torch_floor_g4.tif", "torch_floor_g4.png"]


def _data(name):
    return os.path.join(DATA, name)


@pytest.fixture(scope="module")
def m9e_files(tmp_path_factory):
    """The proxy's scene.xml with height.tif (32^2, ZSTD) and floor.tif
    (G4)."""
    root = tmp_path_factory.mktemp("m9e")
    xml, _ = xf.write_proxy_files(str(root / "m9e"), 16, 12, 4, subdiv=2,
                                  bump_res=32, sky=(64, 32), max_depth=6,
                                  height_file=_data("torch_height32_zstd.tif"),
                                  floor_file=_data("torch_floor_g4.tif"))
    return xml


@pytest.fixture(scope="module")
def loaded(m9e_files):
    return lr.load_file(m9e_files), lrt.load_file(m9e_files, device="cpu")


def test_m9e_buffers_match_jax(loaded, m9e_files):
    js, ts = loaded
    _assert_scene_equal(ts, js)
    assert ts.has_heightmap and ts.emitters.env_index >= 0
    d = os.path.dirname(m9e_files)
    height = jimage.read_image(os.path.join(d, "height.tif"), False)
    floor = jimage.read_image(os.path.join(d, "floor.tif"))
    maps = ts.textures.bitmaps.numpy()
    assert any(np.array_equal(m[:32, :32], height) for m in maps)
    assert any(np.array_equal(m[:256, :256], floor) for m in maps)


def test_m9e_render_matches_jax(loaded):
    js, ts = loaded
    ref = np.asarray(lr.render(js, spp=4, seed=0))
    img = lrt.render(ts, spp=4, seed=0).numpy()
    _assert_images_agree(img, ref)
    assert img.mean() > 1e-2


@pytest.mark.parametrize("name", FILES)
def test_committed_files(name):
    """The card's machine has no Pillow: the files hold their writer's
    pixels, and the port reads them as the JAX package does."""
    got = read_8bit(_data(name))
    if name.startswith("torch_height"):
        res = 32 if "32" in name else BUMP[0]
        codes = np.round(height_map(res, 0) * 255.0).astype(np.uint8)
        np.testing.assert_array_equal(got, np.repeat(codes[..., None], 3, -1))
    else:
        np.testing.assert_array_equal(
            got, np.repeat(((1 - tf.floor_bits()) * 255)[..., None], 3, -1))
    np.testing.assert_array_equal(lrt.read_image(_data(name), False),
                                  jimage.read_image(_data(name), False))


def test_plain_loops_equal_cpp_on_committed():
    strip = tf.first_strip(_data("torch_height_zstd.tif"))
    assert zstd.decode(strip, 64 * 1024) == \
        zstd._decode_plain(strip, 64 * 1024)
    g4 = tf.first_strip(_data("torch_floor_g4.tif"))
    outs = []
    for fn in (tiff_fax.decode, tiff_fax._decode_plain):
        runs = np.zeros(2 * tiff_fax.nruns(256, tiff_fax.G4), np.uint32)
        strip = np.zeros(32 * 256, np.uint8)
        assert fn(g4, tiff_fax.G4, 256, 256, 32, False, False, runs, strip,
                  np.zeros(1, np.int32)) == 1
        outs.append(strip.copy())
    np.testing.assert_array_equal(outs[0], outs[1])
