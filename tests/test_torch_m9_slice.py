"""The slice as a whole: bench.py's workload path (tests/torch_xml_files)
written as Mitsuba XML with a JPEG height map and a DWAA sky, loaded by
the port's load_file and by the JAX package's (PIL and OpenEXR read the
files there), on the CPU: every buffer equal as tests/test_torch_xml_slice
holds them (the envmap CDF within CDF_MAX_ULPS, the BVH keyed by triangle
id), the height map and sky equal bit for bit, and the 16 x 12 images
equal per pixel at that file's tolerance (>= 99 % of pixels within rtol
1e-3 / atol 1e-4, means within 1e-3).
"""
import numpy as np
import pytest
from PIL import Image

import liverrenderer_tpu as lr
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu.io import image as jimage
from liverrenderer_tpu_torch.scene.liver_proxy import height_map, sky_map
import torch_xml_files as xf
from test_torch_exr_codecs import (_native_available, exr_writer,  # noqa
                                   write_with_openexr)
from test_torch_xml_slice import _assert_images_agree, _assert_scene_equal
from torch_threads import torch_threads_per_worker  # noqa: F401

RES = 32
SKY = (64, 32)


@pytest.fixture(scope="module")
def m9_files(exr_writer, tmp_path_factory):
    """The proxy's scene.xml with height.jpg (PIL, quality 75) and a DWAA
    sky (OpenEXR, level 45), and its PNG + ZIP twin."""
    _native_available()
    root = tmp_path_factory.mktemp("m9")
    jpg = root / "h.jpg"
    Image.fromarray(np.round(height_map(RES, 0) * 255.0).astype(np.uint8)) \
        .save(jpg)
    sky = sky_map(*SKY).astype(np.float16)
    dwa = root / "sky_dwa.exr"
    write_with_openexr(exr_writer, dwa, {"R": sky[..., 0], "G": sky[..., 1],
                                         "B": sky[..., 2]}, "dwaa:45")
    kw = dict(subdiv=2, bump_res=RES, sky=SKY, max_depth=6)
    m9, _ = xf.write_proxy_files(str(root / "m9"), 16, 12, 4, sky_file=dwa,
                                 height_file=jpg, **kw)
    twin, _ = xf.write_proxy_files(str(root / "twin"), 16, 12, 4, **kw)
    return m9, twin


@pytest.fixture(scope="module")
def loaded(m9_files):
    m9, _ = m9_files
    return lr.load_file(m9), lrt.load_file(m9, device="cpu")


def test_m9_buffers_match_jax(loaded, m9_files):
    js, ts = loaded
    _assert_scene_equal(ts, js)
    assert ts.has_heightmap and ts.emitters.env_index >= 0
    # the JPEG height map and the DWA sky reached the bitmaps as read
    import os
    d = os.path.dirname(m9_files[0])
    height = jimage.read_image(os.path.join(d, "height.jpg"), False)
    sky = jimage.read_exr_any(os.path.join(d, "sky.exr"))
    maps = ts.textures.bitmaps.numpy()
    assert any(np.array_equal(m[:RES, :RES], height) for m in maps)
    assert any(np.array_equal(m[:SKY[1], :SKY[0]], sky[..., :3])
               for m in maps)


def test_m9_render_matches_jax(loaded):
    js, ts = loaded
    ref = np.asarray(lr.render(js, spp=4, seed=0))
    img = lrt.render(ts, spp=4, seed=0).numpy()
    _assert_images_agree(img, ref)
    assert img.mean() > 1e-2


def test_m9_render_near_its_png_piz_twin(m9_files):
    """The lossy files change the image little: the same scene from the
    PNG height map and the lossless sky, within 5 % in the mean."""
    m9, twin = m9_files
    a = lrt.render(lrt.load_file(m9, device="cpu"), spp=4, seed=0).numpy()
    b = lrt.render(lrt.load_file(twin, device="cpu"), spp=4,
                   seed=0).numpy()
    assert abs(a.mean() - b.mean()) <= 0.05 * b.mean()
