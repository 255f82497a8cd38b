"""The slice as a whole: bench.py's workload path (tests/torch_xml_files)
written as Mitsuba XML with a TIFF height map (LZW, predictor 2, as
Pillow writes it) and a floor textured with a GIF bitmap, loaded by the
port's load_file and by the JAX package's (Pillow reads the files there),
on the CPU: every buffer equal as tests/test_torch_xml_slice holds them,
the height map and the floor's bitmap equal bit for bit, and the 16 x 12
images equal per pixel at that file's tolerance (>= 99 % of pixels within
rtol 1e-3 / atol 1e-4, means within 1e-3).  The committed files the
card's phases read (tests/data/torch_height.tif, torch_floor.gif) are
the bytes Pillow writes for them, and the port reads them as the JAX
package does.
"""
import os

import numpy as np
import pytest
from PIL import Image

import liverrenderer_tpu as lr
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu.io import image as jimage
from liverrenderer_tpu_torch.scene.liver_proxy import height_map
import torch_xml_files as xf
from test_torch_xml_slice import _assert_images_agree, _assert_scene_equal
from torch_threads import torch_threads_per_worker  # noqa: F401

RES = 32
DATA = os.path.join(os.path.dirname(__file__), "data")


def _save_height_tif(path, res):
    Image.fromarray(np.round(height_map(res, 0) * 255.0).astype(np.uint8)) \
        .save(path, compression="tiff_lzw", tiffinfo={317: 2})


@pytest.fixture(scope="module")
def m9b_files(tmp_path_factory):
    """The proxy's scene.xml with height.tif and floor.gif."""
    root = tmp_path_factory.mktemp("m9b")
    tif, gif = root / "h.tif", root / "f.gif"
    _save_height_tif(tif, RES)
    Image.fromarray(xf.floor_texture()).save(gif)
    xml, _ = xf.write_proxy_files(str(root / "m9b"), 16, 12, 4, subdiv=2,
                                  bump_res=RES, sky=(64, 32), max_depth=6,
                                  height_file=tif, floor_file=gif)
    return xml


@pytest.fixture(scope="module")
def loaded(m9b_files):
    return lr.load_file(m9b_files), lrt.load_file(m9b_files, device="cpu")


def test_m9b_buffers_match_jax(loaded, m9b_files):
    js, ts = loaded
    _assert_scene_equal(ts, js)
    assert ts.has_heightmap and ts.emitters.env_index >= 0
    d = os.path.dirname(m9b_files)
    height = jimage.read_image(os.path.join(d, "height.tif"), False)
    floor = jimage.read_image(os.path.join(d, "floor.gif"))
    maps = ts.textures.bitmaps.numpy()
    assert any(np.array_equal(m[:RES, :RES], height) for m in maps)
    assert any(np.array_equal(m[:64, :64], floor) for m in maps)


def test_m9b_render_matches_jax(loaded):
    js, ts = loaded
    ref = np.asarray(lr.render(js, spp=4, seed=0))
    img = lrt.render(ts, spp=4, seed=0).numpy()
    _assert_images_agree(img, ref)
    assert img.mean() > 1e-2


@pytest.mark.parametrize("name", ["torch_height.tif", "torch_floor.gif"])
def test_committed_files_are_pillows(tmp_path, name):
    """The card's phases read these files (the card's machine has no
    Pillow): they are Pillow's bytes for height_map(1024, 0) and
    floor_texture(), and the port reads them as the JAX package does."""
    p = tmp_path / name
    if name.endswith(".tif"):
        _save_height_tif(p, 1024)
    else:
        Image.fromarray(xf.floor_texture()).save(p)
    committed = os.path.join(DATA, name)
    with open(committed, "rb") as fh:
        assert fh.read() == p.read_bytes()
    np.testing.assert_array_equal(lrt.read_image(committed, False),
                                  jimage.read_image(committed, False))
