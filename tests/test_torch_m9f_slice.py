"""The slice as a whole: bench.py's workload path (tests/torch_xml_files)
written as Mitsuba XML with a GZIP_1 FITS height map (ZBITPIX 8, BUMP's
codes) and a floor textured with a 256-colour FLC animation, loaded by
the port's load_file and by the JAX package's (Pillow reads the files
there), on the CPU: every buffer equal as tests/test_torch_xml_slice holds
them, the height map and the floor's bitmap equal bit for bit, and the
16 x 12 images equal per pixel at that file's tolerance (>= 99 % of pixels
within rtol 1e-3 / atol 1e-4, means within 1e-3).  The render has
test_torch_m9e_slice's shape (16 x 12, 4 spp, subdiv 2, a 32^2 map, a
64 x 32 sky, depth 6), so the JAX side reuses its compiled programs.  The
committed files the card's phases read (tests/data/torch_height*_gzip.fits,
torch_floor.flc and its PNG twin torch_floor_flc.png) hold their writer's
pixels (tests/torch_rare_files.committed), the port reads them as the JAX
package does, and the plain FLI loop equals the C++ one on the floor."""
import os

import numpy as np
import pytest

import liverrenderer_tpu as lr
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu.io import image as jimage
from liverrenderer_tpu_torch.io import fli
from liverrenderer_tpu_torch.io.image import read_8bit
from liverrenderer_tpu_torch.scene.liver_proxy import BUMP, height_map
import torch_rare_files as rf
import torch_xml_files as xf
from test_torch_xml_slice import _assert_images_agree, _assert_scene_equal
from torch_threads import torch_threads_per_worker  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "data")
FILES = ["torch_height_gzip.fits", "torch_height32_gzip.fits",
         "torch_floor.flc", "torch_floor_flc.png"]


def _data(name):
    return os.path.join(DATA, name)


@pytest.fixture(scope="module")
def m9f_files(tmp_path_factory):
    """The proxy's scene.xml with height.fits (32^2, GZIP_1) and floor.flc
    (256^2, 256 colours)."""
    root = tmp_path_factory.mktemp("m9f")
    xml, _ = xf.write_proxy_files(
        str(root / "m9f"), 16, 12, 4, subdiv=2, bump_res=32, sky=(64, 32),
        max_depth=6, height_file=_data("torch_height32_gzip.fits"),
        floor_file=_data("torch_floor.flc"))
    return xml


@pytest.fixture(scope="module")
def loaded(m9f_files):
    return lr.load_file(m9f_files), lrt.load_file(m9f_files, device="cpu")


def test_m9f_buffers_match_jax(loaded, m9f_files):
    js, ts = loaded
    _assert_scene_equal(ts, js)
    assert ts.has_heightmap and ts.emitters.env_index >= 0
    d = os.path.dirname(m9f_files)
    height = jimage.read_image(os.path.join(d, "height.fits"), False)
    floor = jimage.read_image(os.path.join(d, "floor.flc"))
    maps = ts.textures.bitmaps.numpy()
    assert any(np.array_equal(m[:32, :32], height) for m in maps)
    assert any(np.array_equal(m[:256, :256], floor) for m in maps)


def test_m9f_render_matches_jax(loaded):
    js, ts = loaded
    ref = np.asarray(lr.render(js, spp=4, seed=0))
    img = lrt.render(ts, spp=4, seed=0).numpy()
    _assert_images_agree(img, ref)
    assert img.mean() > 1e-2


@pytest.mark.parametrize("name", FILES)
def test_committed_files(name):
    """The card's machine has no Pillow: the files hold the codes or the
    floor's pixels, the FLC and PNG files are their writer's bytes (the
    FITS tables' zlib streams may differ between zlib versions), and the
    port reads them as the JAX package does."""
    if not name.endswith(".fits"):
        with open(_data(name), "rb") as fh:
            assert fh.read() == rf.committed(name)
    got = read_8bit(_data(name))
    if name.startswith("torch_height"):
        res = 32 if "32" in name else BUMP[0]
        codes = np.round(height_map(res, 0) * 255.0).astype(np.uint8)
        np.testing.assert_array_equal(got, np.repeat(codes[..., None], 3, -1))
    else:
        idx, pal = rf.floor_indexed()
        np.testing.assert_array_equal(got, pal[idx])
    np.testing.assert_array_equal(lrt.read_image(_data(name), False),
                                  jimage.read_image(_data(name), False))


def test_plain_fli_loop_equals_cpp_on_committed():
    with open(_data("torch_floor.flc"), "rb") as fh:
        data = fh.read()
    framesize = int.from_bytes(data[128:132], "little")
    outs = [fli.decode_first_frame(data, (256, 256), framesize, fn)
            for fn in (fli.frame, fli._frame_plain)]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], rf.floor_indexed()[0])
