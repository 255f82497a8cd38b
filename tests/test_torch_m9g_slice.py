"""The slice as a whole: bench.py's workload path (tests/torch_xml_files)
written as Mitsuba XML with a lossless JP2 height map (BUMP's codes) and
a floor textured with a lossy JPEG 2000 codestream (9/7, ICT, three
layers, offset tiles, RPCL), loaded by the port's load_file and by the
JAX package's (Pillow reads the files there), on the CPU: every buffer
equal as tests/test_torch_xml_slice holds them, the height map and the
floor's bitmap equal bit for bit, and the 16 x 12 images equal per pixel
at that file's tolerance (>= 99 % of pixels within rtol 1e-3 / atol
1e-4, means within 1e-3).  The render has test_torch_m9f_slice's shape
(16 x 12, 4 spp, subdiv 2, a 32^2 map, a 64 x 32 sky, depth 6), so the
JAX side reuses its compiled programs.  The committed files the card's
phases read (tests/data/torch_height*_j2k.jp2, torch_floor.j2k and its
PNG twin torch_floor_j2k.png) are their writers' bytes
(tests/torch_j2k_files.committed), the port reads them as the JAX
package does, and the plain tier-1 loop equals the C++ one on the 32^2
map's code-blocks and on one floor tile's."""
import os

import numpy as np
import pytest

import liverrenderer_tpu as lr
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu.io import image as jimage
from liverrenderer_tpu_torch.io import j2k_t1, jpeg2000
from liverrenderer_tpu_torch.io.image import read_8bit
from liverrenderer_tpu_torch.scene.liver_proxy import BUMP, height_map
import torch_j2k_files as j2f
import torch_xml_files as xf
from test_torch_xml_slice import _assert_images_agree, _assert_scene_equal
from torch_threads import torch_threads_per_worker  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "data")
FILES = ["torch_height_j2k.jp2", "torch_height32_j2k.jp2",
         "torch_floor.j2k", "torch_floor_j2k.png"]


def _data(name):
    return os.path.join(DATA, name)


@pytest.fixture(scope="module")
def m9g_files(tmp_path_factory):
    """The proxy's scene.xml with height.jp2 (32^2, lossless) and
    floor.j2k (256^2, lossy)."""
    root = tmp_path_factory.mktemp("m9g")
    xml, _ = xf.write_proxy_files(
        str(root / "m9g"), 16, 12, 4, subdiv=2, bump_res=32, sky=(64, 32),
        max_depth=6, height_file=_data("torch_height32_j2k.jp2"),
        floor_file=_data("torch_floor.j2k"))
    return xml


@pytest.fixture(scope="module")
def loaded(m9g_files):
    return lr.load_file(m9g_files), lrt.load_file(m9g_files, device="cpu")


def test_m9g_buffers_match_jax(loaded, m9g_files):
    js, ts = loaded
    _assert_scene_equal(ts, js)
    assert ts.has_heightmap and ts.emitters.env_index >= 0
    d = os.path.dirname(m9g_files)
    height = jimage.read_image(os.path.join(d, "height.jp2"), False)
    floor = jimage.read_image(os.path.join(d, "floor.j2k"))
    maps = ts.textures.bitmaps.numpy()
    assert any(np.array_equal(m[:32, :32], height) for m in maps)
    assert any(np.array_equal(m[:256, :256], floor) for m in maps)


def test_m9g_render_matches_jax(loaded):
    js, ts = loaded
    ref = np.asarray(lr.render(js, spp=4, seed=0))
    img = lrt.render(ts, spp=4, seed=0).numpy()
    _assert_images_agree(img, ref)
    assert img.mean() > 1e-2


@pytest.mark.parametrize("name", FILES)
def test_committed_files(name):
    """The card's machine has no Pillow: the files are their writers'
    bytes, hold the codes or the floor's decode, and the port reads them
    as the JAX package does."""
    with open(_data(name), "rb") as fh:
        assert fh.read() == j2f.committed(name)
    got = read_8bit(_data(name))
    if name.startswith("torch_height"):
        res = 32 if "32" in name else BUMP[0]
        codes = np.round(height_map(res, 0) * 255.0).astype(np.uint8)
        np.testing.assert_array_equal(got, np.repeat(codes[..., None], 3, -1))
    else:
        np.testing.assert_array_equal(got,
                                      read_8bit(_data("torch_floor_j2k.png")))
    np.testing.assert_array_equal(lrt.read_image(_data(name), False),
                                  jimage.read_image(_data(name), False))


def test_plain_tier1_equals_cpp_on_committed():
    blocks = jpeg2000.committed_blocks(_data("torch_height32_j2k.jp2"))
    blocks += jpeg2000.committed_blocks(_data("torch_floor.j2k"), tiles=1)
    assert len(blocks) > 20
    for blk, cpp in zip(blocks, j2k_t1.decode_blocks(blocks)):
        np.testing.assert_array_equal(j2k_t1._t1_plain(*blk), cpp)
