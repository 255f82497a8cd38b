"""The slice as a whole: bench.py's workload path (tests/torch_xml_files)
written as Mitsuba XML with a lossy WebP height map and a floor textured
with a BC7 DDS bitmap, loaded by the port's load_file and by the JAX
package's (Pillow reads the files there), on the CPU: every buffer equal
as tests/test_torch_xml_slice holds them, the height map and the floor's
bitmap equal bit for bit, and the 16 x 12 images equal per pixel at that
file's tolerance (>= 99 % of pixels within rtol 1e-3 / atol 1e-4, means
within 1e-3).  The committed files the card's phases read
(tests/data/torch_height*.webp, torch_alpha64.webp, torch_anim.webp,
torch_floor_bc7.dds and its PNG twin torch_floor_bc7.png) are the bytes
Pillow and the test writers give for them, the port reads them as the
JAX package does, the plain loops equal the C++ ones on them, and the
WebP height map stays within the bound of the PNG's codes that the card's
m9c_decode phase holds (measured here: max 8, mean 0.6917 codes)."""
import os

import numpy as np
import pytest
from PIL import Image

import liverrenderer_tpu as lr
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu.io import image as jimage
from liverrenderer_tpu_torch.io import bcn, dds, webp
from liverrenderer_tpu_torch.io.image import read_8bit
import torch_bcn_files as bf
import torch_webp_files as wf
import torch_xml_files as xf
from test_torch_xml_slice import _assert_images_agree, _assert_scene_equal
from torch_threads import torch_threads_per_worker  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "data")
WEBPS = ["torch_height.webp", "torch_height32.webp", "torch_height_crop.webp",
         "torch_alpha64.webp", "torch_anim.webp"]
# the gates chip_smoke.py's m9c_decode holds the WebP height map to
HEIGHT_MAX_CODES, HEIGHT_MEAN_CODES = 8, 0.70


def _data(name):
    return os.path.join(DATA, name)


@pytest.fixture(scope="module")
def m9c_files(tmp_path_factory):
    """The proxy's scene.xml with height.webp (32^2) and floor.dds."""
    root = tmp_path_factory.mktemp("m9c")
    xml, _ = xf.write_proxy_files(str(root / "m9c"), 16, 12, 4, subdiv=2,
                                  bump_res=32, sky=(64, 32), max_depth=6,
                                  height_file=_data("torch_height32.webp"),
                                  floor_file=_data("torch_floor_bc7.dds"))
    return xml


@pytest.fixture(scope="module")
def loaded(m9c_files):
    return lr.load_file(m9c_files), lrt.load_file(m9c_files, device="cpu")


def test_m9c_buffers_match_jax(loaded, m9c_files):
    js, ts = loaded
    _assert_scene_equal(ts, js)
    assert ts.has_heightmap and ts.emitters.env_index >= 0
    d = os.path.dirname(m9c_files)
    height = jimage.read_image(os.path.join(d, "height.webp"), False)
    floor = jimage.read_image(os.path.join(d, "floor.dds"))
    maps = ts.textures.bitmaps.numpy()
    assert any(np.array_equal(m[:32, :32], height) for m in maps)
    assert any(np.array_equal(m[:256, :256], floor) for m in maps)


def test_m9c_render_matches_jax(loaded):
    js, ts = loaded
    ref = np.asarray(lr.render(js, spp=4, seed=0))
    img = lrt.render(ts, spp=4, seed=0).numpy()
    _assert_images_agree(img, ref)
    assert img.mean() > 1e-2


@pytest.mark.parametrize("name", WEBPS + ["torch_floor_bc7.dds",
                                          "torch_floor_bc7.png"])
def test_committed_files(tmp_path, name):
    """The card's machine has no Pillow: the files are the writers' bytes,
    and the port reads them as the JAX package does."""
    if name.endswith(".webp"):
        fresh = wf.committed_webp(name)
    elif name.endswith(".dds"):
        fresh = bf.committed_floor_dds()
    else:
        p = tmp_path / name
        Image.fromarray(np.asarray(Image.open(_data("torch_floor_bc7.dds"))
                                   .convert("RGB"))).save(p)
        fresh = p.read_bytes()
    with open(_data(name), "rb") as fh:
        assert fh.read() == fresh
    np.testing.assert_array_equal(lrt.read_image(_data(name), False),
                                  jimage.read_image(_data(name), False))


def test_height_webp_within_its_bound():
    got = read_8bit(_data("torch_height.webp"))[..., 0].astype(int)
    diff = np.abs(got - wf.height_codes(1024))
    assert diff.max() <= HEIGHT_MAX_CODES
    assert diff.mean() <= HEIGHT_MEAN_CODES


@pytest.mark.parametrize("name", ["torch_height_crop.webp",
                                  "torch_alpha64.webp", "torch_anim.webp"])
def test_plain_loops_equal_cpp_on_committed(name):
    with open(_data(name), "rb") as fh:
        data = fh.read()
    cw, ch, frame = webp.demux(data)
    np.testing.assert_array_equal(
        webp.first_frame(data, cw, ch, frame),
        webp.first_frame(data, cw, ch, frame, plain=True))


def test_floor_dds_plain_equals_cpp_and_png():
    with open(_data("torch_floor_bc7.dds"), "rb") as fh:
        data = fh.read()
    body = data[148:]
    a = bcn.decode(body, 256, 256, 7, "BC7")
    b = bcn.decode(body[:16 * 64 * 4], 256, 16, 7, "BC7", plain=True)
    np.testing.assert_array_equal(a[:16], b)
    np.testing.assert_array_equal(dds.open_dds(data)(),
                                  read_8bit(_data("torch_floor_bc7.png")))
