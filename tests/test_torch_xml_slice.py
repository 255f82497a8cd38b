"""The scene loader as a whole: Mitsuba XML files with their PLY, OBJ and
serialized meshes, PNG height map and EXR sky, loaded by the port's
load_file and by the JAX package's, on the CPU.

Buffers: every array the port's Scene holds equals the JAX package's,
integers exactly and floats at rtol 1e-6 (the same numpy operations),
but for two sets of arrays that the packages build otherwise: the BVH and
the packed triangle rows, which the JAX package builds natively (compared
keyed by the triangle id baked into the rows, as
tests/test_torch_scene.py does), and the envmap's 2-D CDF, which XLA sums
in another order (within CDF_MAX_ULPS float32 ulps, as
tests/test_torch_texture.py).  Images: >= 99 % of pixels within rtol
1e-3 / atol 1e-4 and means within 1e-3 relative (the other port tests'
bound; measured: every pixel, 39 % of the proxy's bit-identical).
Gradients of the mean image with respect to media.params: within 4e-7 of
the largest entry on the sphere (no bump map; measured 3e-8 to 2.2e-7 over
seeds 0-2); within 3e-6 on the bumped proxy, whose bump frame jumps at
texel edges so that an ulp of hit uv can bend a path
(tests/test_torch_bump_env_slice.py; measured at 16 x 12, 4 spp, seeds
0-3: 8.3e-8, 5.9e-7, 6.1e-4 and 5.1e-6 of the largest entry, seed 2
after one such path's flip; the test runs seed 1, as that file does).

The gradients of loaded scenes run from tests/test_torch_xml_grad.py,
which shares this file's scenes and tolerances, so that xdist's file
scheduler can start them apart from this file (a long file holds one
worker to its end).
"""
import os

import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu.scene import builder as jbuilder
from liverrenderer_tpu.scene import xml as jxml
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.bridge import numpy_tree
from liverrenderer_tpu_torch.scene import builder as tbuilder
from liverrenderer_tpu_torch.scene import meshio as tmeshio
from liverrenderer_tpu_torch.scene import xml as txml
from liverrenderer_tpu_torch.scene.liver_proxy import liver_mesh
import torch_xml_files as xf
from test_torch_io import _serialized
from torch_threads import torch_threads_per_worker  # noqa: F401

PIX_RTOL, PIX_ATOL, PIX_FRAC, MEAN_RTOL = 1e-3, 1e-4, 0.99, 1e-3
CDF_MAX_ULPS = 16
CDF_KEYS = ("emitters.env_distr.cond_cdf", "emitters.env_distr.marg_cdf",
            "emitters.env_distr.total")
BVH_KEYS = ("tri_buf", "tri_boxes", "tri_kperm", "bvh.node_min",
            "bvh.node_max", "bvh.right", "bvh.first", "bvh.count",
            "bvh.perm")
# the proxy at test size: 16 x 12, 4 spp, 320 triangles, a 32^2 height
# map and a 64 x 32 sky
SMALL = dict(width=16, height=12, spp=4, subdiv=2, bump_res=32,
             sky=(64, 32))


def _assert_dicts_equal(t, j, path=""):
    """parse_xml's dicts: the same keys, values, and transforms."""
    if isinstance(j, dict):
        assert isinstance(t, dict) and list(t) == list(j), (path, t, j)
        for k in j:
            _assert_dicts_equal(t[k], j[k], f"{path}.{k}")
    elif hasattr(j, "matrix"):
        np.testing.assert_array_equal(t.matrix, j.matrix, err_msg=path)
    else:
        assert type(t) is type(j) and t == j, (path, t, j)


def _assert_scene_equal(ts, js):
    pa, ps = numpy_tree(ts)
    ja, jss = numpy_tree(js)
    for k, v in pa.items():
        ref = ja[k]
        assert v.shape == ref.shape, k
        if k in BVH_KEYS:
            continue
        if k in CDF_KEYS:
            ulps = np.abs(v.view(np.int32).astype(np.int64)
                          - ref.astype(np.float32).view(np.int32))
            assert ulps.max() <= CDF_MAX_ULPS, (k, ulps.max())
        elif np.issubdtype(ref.dtype, np.floating):
            np.testing.assert_allclose(v, ref, rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(v, ref.astype(v.dtype), err_msg=k)
    for k, v in ps.items():
        assert v == jss[k], (k, v, jss[k])
    T = ts.n_tris
    if T:
        tb, jb = pa["tri_buf"], ja["tri_buf"]
        np.testing.assert_allclose(tb[np.argsort(tb[:T, 12])],
                                   jb[np.argsort(jb[:T, 12])], rtol=1e-6,
                                   atol=0)


def _assert_images_agree(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.abs(img - ref) <= PIX_ATOL + PIX_RTOL * np.abs(ref)
    assert close.all(-1).mean() >= PIX_FRAC
    assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    """{name: path of scene.xml}: the proxy (PLY + PNG + EXR) and the
    liver sphere."""
    root = tmp_path_factory.mktemp("scenes")
    proxy, _ = xf.write_proxy_files(str(root / "proxy"), **SMALL)
    sphere = root / "sphere.xml"
    sphere.write_text(xf.sphere_liver_xml(12, 4))
    return {"proxy": proxy, "sphere": str(sphere)}


@pytest.fixture(scope="module")
def loaded(scene_files):
    return {k: (lr.load_file(p), lrt.load_file(p, device="cpu"))
            for k, p in scene_files.items()}


# every tag branch of the parser: scalars (a legacy lambda:value float),
# vector and point (value, x/y/z), rgb (one value, three, lambda:value
# tokens), spectrum (constant, one pair, a table, junk), transform
# (translate, scale as value and x/y/z, rotate, lookat, a matrix with
# commas), refs with and without a name, the slot names of nested
# plugins (a medium not named interior/exterior), duplicate keys,
# capitalised types, <default>s, $var and overrides
_ALL_TAGS = """<scene version="3.0.0">
  <default name="w" value="8"/>
  <default name="tint" value="0.5"/>
  <integrator type="volpath">
    <integer name="max_depth" value="$w"/>
    <boolean name="hide_emitters" value="True"/>
    <float name="legacy" value="550:0.25"/>
  </integrator>
  <sensor type="perspective">
    <string name="fov_axis" value="smaller"/>
    <transform name="to_world">
      <translate x="1" z="-2"/>
      <scale value="2"/>
      <scale x="1" y="3" z="0.5"/>
      <scale value="1, 2 3"/>
      <rotate x="1" y="1" angle="30"/>
      <lookat origin="0 0 4" target="0,0,0" up="0, 1, 0"/>
      <matrix value="1,0,0,0.5, 0,1,0,0 0,0,1,0, 0,0,0,1"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="$w"/>
      <rfilter type="Gaussian"/>
    </film>
    <sampler type="stratified"><integer name="sample_count" value="4"/>
    </sampler>
    <medium type="homogeneous" name="camera_fog"/>
  </sensor>
  <point name="where" value="1 2, 3"/>
  <vector name="up" x="0.5" z="2"/>
  <bsdf type="Diffuse" id="grey">
    <rgb name="reflectance" value="$tint"/>
  </bsdf>
  <bsdf type="roughconductor" id="metal">
    <rgb name="eta" value="0.2, 0.9, 1.1"/>
    <rgb name="k" value="450:3.9 550:2.4 650:2.1"/>
  </bsdf>
  <medium type="homogeneous" id="fog">
    <spectrum name="sigma_t" value="0.75"/>
    <spectrum name="albedo" value="500:0.5"/>
    <spectrum name="sigma_s" value="400:0.1, 500:0.4,600:0.2"/>
    <spectrum name="sigma_n" value="junk"/>
    <phase type="hg"><float name="g" value="0.3"/></phase>
  </medium>
  <shape type="rectangle">
    <ref id="grey"/>
    <ref name="exterior" id="fog"/>
    <medium type="homogeneous"/>
    <emitter type="area"><rgb name="radiance" value="1 2 3"/></emitter>
    <texture type="checkerboard" name="pattern"/>
    <volume type="gridvolume" name="density"/>
    <integer name="n" value="1"/>
    <integer name="n" value="2"/>
  </shape>
  <shape type="rectangle"/>
  <emitter type="constant"/>
</scene>
"""


@pytest.mark.parametrize("overrides", [{}, {"w": 12, "tint": "0.25"}])
def test_parse_xml_matches_jax(tmp_path, overrides):
    p = tmp_path / "tags.xml"
    p.write_text(_ALL_TAGS)
    t = txml.parse_xml(str(p), overrides)
    _assert_dicts_equal(t, jxml.parse_xml(str(p), overrides))
    # spot checks of what the branches produce
    assert t["integrator"]["max_depth"] == (12 if overrides else 8)
    assert t["integrator"]["legacy"] == 0.25
    assert t["fog"]["albedo"] == {"type": "rgb", "value": [0.5] * 3}
    assert t["fog"]["sigma_s"]["type"] == "irregular"
    assert t["grey"]["type"] == "diffuse" and "shape_1" in t
    assert t["shape"]["interior"]["type"] == "homogeneous"
    assert t["shape"]["n_1"] == 2


@pytest.mark.parametrize("name", ["proxy", "sphere"])
def test_load_file_buffers_match_jax(loaded, name):
    js, ts = loaded[name]
    _assert_scene_equal(ts, js)
    if name == "proxy":
        assert ts.n_tris == 320 and ts.has_heightmap \
            and ts.emitters.env_index >= 0
        assert tuple(ts.textures.bitmaps.shape) == (2, 32, 64, 3)
    # the liver medium's irregular sigma_blood reached the table
    p = ts.media.params[0].numpy()
    np.testing.assert_allclose(
        p[40:43], tbuilder._spectrum_to_rgb(
            {"type": "irregular", "value": xf.SIGMA_BLOOD}), rtol=1e-6)
    assert p[40] < p[41] < p[42] and p[48] == p[49] == p[50] == 0.001


@pytest.mark.parametrize("name", ["proxy", "sphere"])
def test_load_file_render_matches_jax(loaded, name):
    js, ts = loaded[name]
    ref = np.asarray(lr.render(js, spp=4, seed=0))
    img = lrt.render(ts, spp=4, seed=0).numpy()
    _assert_images_agree(img, ref)
    assert img.mean() > 1e-2


def test_load_file_equals_load_dict_of_the_arrays_read_back(scene_files):
    """chip_smoke.py's xml_render check at test size: the dict that holds
    the decoded PNG and EXR and the PLY mesh inline builds the same
    buffers, so the two renders are bit-identical."""
    path = scene_files["proxy"]
    base = os.path.dirname(path)
    d = xf.inline_files(txml.parse_xml(path), base, lrt.read_image,
                        tmeshio.load_mesh)
    assert "filename" not in str(d.keys())
    a = lrt.load_file(path, device="cpu")
    b = lrt.load_dict(d, device="cpu")
    pa, sa = numpy_tree(a)
    pb, sb = numpy_tree(b)
    assert sa == sb and pa.keys() == pb.keys()
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
    assert torch.equal(lrt.render(a, spp=2, seed=3),
                       lrt.render(b, spp=2, seed=3))
    # the mesh is the proxy's, through the PLY file bit for bit
    v, f, n, uv = liver_mesh(SMALL["subdiv"], 0)
    m = tmeshio.load_mesh(os.path.join(base, "liver.ply"))
    for x, y in ((m.vertices, v), (m.faces, f), (m.normals, n),
                 (m.uvs, uv)):
        np.testing.assert_array_equal(x, y)


def test_load_file_overrides_and_devices(scene_files):
    path = scene_files["proxy"]
    ts = lrt.load_file(path, device="cpu", res_width=8, res_height=6,
                       spp=2, max_depth=5, integrator="volpath")
    assert (ts.film_w, ts.film_h, ts.spp, ts.max_depth, ts.integrator) \
        == (8, 6, 2, 5, "volpath")
    sp = lrt.load_file(path, device="cpu", variant="spectral")
    assert sp.spectral and sp.integrator == "biovolpath"
    if torch.cuda.is_available():
        assert lrt.load_file(path).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lrt.load_file(path)


@pytest.mark.parametrize("spec", [
    {"type": "blackbody", "temperature": 3200.0},
    {"type": "blackbody", "temperature": 6504, "scale": 2.0},
    {"type": "regular", "values": [0.1, 0.5, 0.9, 0.4],
     "lambda_min": 400.0, "lambda_max": 700.0},
    {"type": "regular", "value": [0.3, 0.3]},
    {"type": "irregular", "wavelengths": [420.0, 530.0, 640.0],
     "values": [0.9, 0.2, 0.05]},
    {"type": "irregular", "value": "400:0.1, 550 : 0.7,700:0.2"},
    {"type": "srgb", "value": [0.2, 0.5, 0.9]},
    {"type": "srgb", "value": 0.04}])
def test_spectra_match_jax(spec):
    t = tbuilder._spectrum_to_rgb(spec)
    j = jbuilder._spectrum_to_rgb(spec)
    assert t.dtype == np.float32 and t.shape == (3,)
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-9)


def _shapes_xml(tmp_path):
    """A disk, a cylinder, an OBJ and a serialized mesh, a blender mesh
    and two rectangles inside a merge, under directional, spot and
    projector lights, a stratified sampler and a lanczos filter."""
    (tmp_path / "quad.obj").write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 1 1\n"
        "vt 0 1\nvn 0 0 1\nf 1/1/1 2/2/1 3/3/1 4/4/1\n")
    rng = np.random.default_rng(2)
    _serialized(str(tmp_path / "tri.serialized"), 4, [
        (0x0002, rng.uniform(-1, 1, (3, 3)), [[0, 1, 2]], None,
         rng.uniform(size=(3, 2)), None)])
    proj = tmp_path / "slide.png"
    lrt.write_image(str(proj), rng.uniform(size=(6, 6, 3)))
    (tmp_path / "shapes.xml").write_text("""<scene version="3.0.0">
  <integrator type="path"><integer name="max_depth" value="3"/></integrator>
  <sensor type="perspective">
    <transform name="to_world">
      <lookat origin="0, 0.5, 4" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="10"/><integer name="height" value="8"/>
      <rfilter type="lanczos"/>
    </film>
    <sampler type="stratified"><integer name="sample_count" value="4"/>
    </sampler>
  </sensor>
  <shape type="disk">
    <transform name="to_world"><translate x="-1.2"/></transform>
  </shape>
  <shape type="cylinder">
    <point name="p0" x="0" y="0" z="-0.5"/>
    <point name="p1" x="0" y="0" z="0.7"/>
    <float name="radius" value="0.4"/>
  </shape>
  <shape type="obj">
    <string name="filename" value="quad.obj"/>
    <boolean name="face_normals" value="true"/>
    <transform name="to_world"><translate x="1" y="-1"/></transform>
  </shape>
  <shape type="serialized">
    <string name="filename" value="tri.serialized"/>
  </shape>
  <shape type="merge">
    <shape type="rectangle">
      <transform name="to_world"><translate z="-1"/><scale value="3"/>
      </transform>
    </shape>
    <shape type="rectangle">
      <transform name="to_world"><translate y="-1.5"/>
        <rotate x="1" angle="-90"/></transform>
    </shape>
  </shape>
  <emitter type="directional">
    <vector name="direction" x="0.3" y="-1" z="-0.6"/>
    <rgb name="irradiance" value="2"/>
  </emitter>
  <emitter type="spot">
    <transform name="to_world">
      <lookat origin="0, 2, 2" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <float name="cutoff_angle" value="25"/>
    <spectrum name="intensity" value="400:6, 700:9"/>
  </emitter>
  <emitter type="projector">
    <transform name="to_world">
      <lookat origin="1, 1, 3" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <float name="fov" value="40"/>
    <float name="scale" value="4"/>
    <texture type="bitmap" name="irradiance">
      <string name="filename" value="slide.png"/>
    </texture>
  </emitter>
</scene>
""")
    return str(tmp_path / "shapes.xml")


def test_shapes_emitters_and_files_match_jax(tmp_path):
    path = _shapes_xml(tmp_path)
    js, ts = lr.load_file(path), lrt.load_file(path, device="cpu")
    _assert_scene_equal(ts, js)
    assert ts.n_shapes == 6 and ts.sampler_kind == "stratified"
    ref = np.asarray(lr.render(js, spp=4, seed=0))
    img = lrt.render(ts, spp=4, seed=0).numpy()
    _assert_images_agree(img, ref)
    assert img.mean() > 1e-2
    # a blender shape is an in-memory mesh
    d = {"type": "scene", "m": {"type": "blender", "vertices": [
        [0, 0, 0], [1, 0, 0], [0, 1, 0]], "faces": [[0, 1, 2]]}}
    _assert_scene_equal(lrt.load_dict(d, device="cpu"), lr.load_dict(d))


def test_rgba_exr_envmap_and_bitmap_match_jax(tmp_path):
    """An RGBA EXR as the envmap and as a bitmap texture: read_image keeps
    alpha (as the JAX package's native reader does) and both builders keep
    R, G, B of it in the bitmap stack and the env importance map."""
    from liverrenderer_tpu_torch.io.exr import write_exr
    rng = np.random.default_rng(4)
    write_exr(str(tmp_path / "sky.exr"),
              rng.uniform(0.1, 4.0, (16, 32, 4)).astype(np.float32))
    assert lrt.read_image(str(tmp_path / "sky.exr")).shape == (16, 32, 4)
    d = {"type": "scene",
         "plane": {"type": "rectangle",
                   "bsdf": {"type": "diffuse", "reflectance": {
                       "type": "bitmap", "filename": "sky.exr"}}},
         "env": {"type": "envmap", "filename": "sky.exr", "scale": 0.5}}
    ts = lrt.load_dict(d, device="cpu", base_dir=str(tmp_path))
    _assert_scene_equal(ts, lr.load_dict(d, base_dir=str(tmp_path)))
    assert tuple(ts.textures.bitmaps.shape) == (2, 16, 32, 3)
