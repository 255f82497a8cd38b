"""The port's scene loading and bridge against the JAX package.

Buffers are compared exactly where both packages run the same numpy code
(integers exactly, floats at rtol 1e-6: every float is produced by the
same float64/float32 numpy operations; 1e-6 is a few float32 ulps).  The JAX package builds its BVH natively when its C++
library is built; the port always uses the numpy builder, so the exact
comparison patches the JAX side onto the numpy builder too, and a second
comparison keys the packed triangle rows by their baked triangle id.
"""
import ast
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
import liverrenderer_tpu._native as jnative
from liverrenderer_tpu.accel import pallas_intersect as jpk
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.accel import cuda_intersect as tci
from liverrenderer_tpu_torch.bridge import numpy_tree, scene_from_numpy
from liverrenderer_tpu_torch.bsdf.measured import write_tensor_file
from liverrenderer_tpu_torch.scene import builder as tbuilder
from liverrenderer_tpu_torch.scene import ir
from liverrenderer_tpu_torch.scene import cornell as tcornell
from liverrenderer_tpu_torch.scene.liver_proxy import liver_proxy_dict
from liverrenderer_tpu_torch.scene.transform import Transform
from torch_m10_scenes import synthetic_measured
from torch_threads import torch_threads_per_worker  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# image tolerance of tests/test_torch_render.py
PIX_RTOL, PIX_ATOL, PIX_FRAC, MEAN_RTOL = 1e-3, 1e-4, 0.99, 1e-3


def _assert_tree_equal(port_scene, jax_scene, skip=()):
    """Every array and static the port holds equals the JAX scene's."""
    pa, ps = numpy_tree(port_scene)
    ja, js = numpy_tree(jax_scene)
    for k, v in pa.items():
        if k in skip:
            continue
        ref = ja[k]
        assert v.shape == ref.shape, k
        if np.issubdtype(ref.dtype, np.floating):
            np.testing.assert_allclose(v, ref, rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(v, ref.astype(v.dtype), err_msg=k)
    for k, v in ps.items():
        assert v == js[k], (k, v, js[k])
    return pa, ja


def test_liver_proxy_scene_buffers_equal(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    d = liver_proxy_dict(16, 12, 4, 2, 0)
    js = lr.load_dict(d)
    ts = lrt.load_dict(d, device="cpu")
    assert ts.n_tris == 320 and not ts.needs_surface_nee \
        and not ts.needs_medium_nee
    pa, _ = _assert_tree_equal(ts, js)
    assert "tri_buf" in pa and "media.params" in pa


def test_liver_proxy_tri_rows_keyed_by_id():
    """Under whichever BVH builder the JAX side uses here, the packed rows
    agree once keyed by the triangle id baked into column 12."""
    d = liver_proxy_dict(16, 12, 4, 2, 0)
    js = lr.load_dict(d)
    ts = lrt.load_dict(d, device="cpu")
    _assert_tree_equal(ts, js, skip=("tri_buf", "tri_boxes", "tri_kperm",
                                     "bvh.node_min", "bvh.node_max",
                                     "bvh.right", "bvh.first", "bvh.count",
                                     "bvh.perm"))
    tb = ts.tri_buf.numpy()
    jb = np.asarray(js.tri_buf)
    T = ts.n_tris
    t_rows = tb[np.argsort(tb[:T, 12])]
    j_rows = jb[np.argsort(jb[:T, 12])]
    np.testing.assert_allclose(t_rows, j_rows, rtol=1e-6, atol=0)


def test_bridge_cornell_box():
    js = lr.cornell_box()
    js["sensor"]["film"]["width"] = 8
    js["sensor"]["film"]["height"] = 8
    jscene = lr.load_dict(js)
    arrays, statics = numpy_tree(jscene)
    ts = scene_from_numpy(arrays, statics, "cpu")
    _assert_tree_equal(ts, jscene)
    assert ts.n_tris == jscene.n_tris and ts.faces.dtype == torch.int64
    # the cornell box's own integrator, the surface path tracer, renders
    # the bridged scene (its gaussian filter on the fixed wavefront)
    assert ts.needs_surface_nee and ts.integrator == "path"
    img = lrt.render(ts, spp=1)
    assert img.shape == (8, 8, 3) and torch.isfinite(img).all() \
        and img.mean() > 0


def test_bridge_missing_array_raises():
    arrays, statics = numpy_tree(lrt.load_dict(liver_proxy_dict(4, 4, 1, 0),
                                                 device="cpu"))
    del arrays["media.params"]
    with pytest.raises(KeyError, match="media.params"):
        scene_from_numpy(arrays, statics, "cpu")


@pytest.mark.parametrize("T,with_perm", [(300, False), (1000, True)])
def test_pack_tris_equal(np_rng, T, with_perm):
    v0 = np_rng.uniform(-3, 3, (T, 3)).astype(np.float32) + 50.0
    v1 = v0 + np_rng.uniform(-0.3, 0.3, (T, 3)).astype(np.float32)
    v2 = v0 + np_rng.uniform(-0.3, 0.3, (T, 3)).astype(np.float32)
    perm = np_rng.permutation(T) if with_perm else None
    for a, b in zip(tci.pack_tris(v0, v1, v2, perm),
                    jpk.pack_tris(v0, v1, v2, perm)):
        np.testing.assert_array_equal(a, b)


def test_unported_plugins_raise(tmp_path):
    # principled, principledthin, measured, hair and the sunsky load
    mfile = str(tmp_path / "m.bsdf")
    write_tensor_file(mfile, synthetic_measured())
    for bsdf, code in (("principled", ir.BSDF_PRINCIPLED),
                       ("principledthin", ir.BSDF_PRINCIPLEDTHIN),
                       ("measured", ir.BSDF_MEASURED)):
        d = liver_proxy_dict(4, 4, 1, 0)
        d["liver"]["bsdf"] = {"type": bsdf, "filename": mfile}
        assert code in lrt.load_dict(d, device="cpu").bsdfs.types_present
    # hair and the sunsky load (the M10 item's last plugins)
    d = liver_proxy_dict(4, 4, 1, 0)
    d["liver"]["bsdf"] = {"type": "hair"}
    assert ir.BSDF_HAIR in lrt.load_dict(d, device="cpu").bsdfs.types_present
    d = liver_proxy_dict(4, 4, 1, 0)
    # the spectral variant loads
    assert lrt.load_dict(d, device="cpu", variant="spectral").spectral
    d = liver_proxy_dict(4, 4, 1, 0)
    d["env"] = {"type": "sunsky"}
    assert lrt.load_dict(d, device="cpu").emitters.env_index >= 0
    d = liver_proxy_dict(4, 4, 1, 0)
    d["sensor"]["sampler"]["type"] = "halton"
    with pytest.raises(ValueError, match="unknown plugin"):
        lrt.load_dict(d, device="cpu")


def test_load_dict_defaults_to_the_card():
    """Without `device` the scene goes to the card; on a machine without
    one load_dict raises instead of building on the CPU."""
    d = liver_proxy_dict(4, 4, 1, 0)
    if torch.cuda.is_available():
        assert lrt.load_dict(d).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lrt.load_dict(d)
    assert lrt.load_dict(d, device="cpu").device.type == "cpu"


def test_port_imports_no_jax():
    """Importing the port and every module in it loads no jax, flax or
    liverrenderer_tpu module (the port runs where JAX is absent)."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import liverrenderer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'liverrenderer_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _glisson_sphere():
    """The glissonCapsule sphere of tests/test_spectral.py (RGB)."""
    return {
        "type": "scene",
        "integrator": {"type": "biovolpath", "max_depth": 6},
        "sensor": {"type": "perspective", "fov": 40.0,
                   "to_world": Transform().look_at(
                       [0, 0, 4], [0, 0, 0], [0, 1, 0]).matrix.copy(),
                   "film": {"type": "hdrfilm", "width": 12, "height": 12,
                            "rfilter": {"type": "box"}}},
        "blob": {"type": "sphere",
                 "bsdf": {"type": "dielectric", "int_ior": 1.36},
                 "interior": {
                     "type": "glissonCapsule",
                     "layer1Limit": 0.001, "layer2Limit": 0.002,
                     "layer3Limit": 0.003, "layer4Limit": 10.0,
                     "sigma_collagen1_R": 8.0, "sigma_collagen1_G": 10.0,
                     "sigma_collagen1_B": 12.0,
                     "sigma_elastin1_R": 2.0, "sigma_elastin1_G": 2.5,
                     "sigma_elastin1_B": 3.0}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [1.0] * 3}},
    }


@pytest.mark.parametrize("kind", ["glisson_sphere", "proxy_biovolpath06",
                                  "prbvolpath_fog_cube"])
def test_carried_plugins_render_as_jax(kind):
    """Plugin names whose code the port carried before its builder took
    them: a glissonCapsule medium, the proxy under biovolpath06 (which
    differs from biovolpath in its bounce), and prbvolpath (the volpath
    bounce on the fixed wavefront, as in the JAX package)."""
    if kind == "glisson_sphere":
        d, spp = _glisson_sphere(), 4
    elif kind == "proxy_biovolpath06":
        d, spp = liver_proxy_dict(16, 12, 4, 2, 0), 4
        d["integrator"]["type"] = "biovolpath06"
    else:
        d, spp = tcornell.plane_light_dict(8, integrator="prbvolpath",
                                           fog_cube=True), 4
    js, ts = lr.load_dict(d), lrt.load_dict(d, device="cpu")
    assert ts.integrator == js.integrator
    ref = np.asarray(lr.render(js, spp=spp, seed=0))
    img = lrt.render(ts, spp=spp, seed=0).numpy()
    assert np.isfinite(img).all() and img.mean() > 1e-2
    close = np.abs(img - ref) <= PIX_ATOL + PIX_RTOL * np.abs(ref)
    assert close.all(-1).mean() >= PIX_FRAC
    assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())


def _roadmap_labels():
    """The item labels that ROADMAP.md's open items declare (`label "..."`
    and `labels "...", "..."` on the items still to do)."""
    text = (pathlib.Path(REPO) / "ROADMAP.md").read_text()
    left = text[text.index("**Left, in this order:**"):
                text.index("### Queue 3")]
    labels = set()
    for m in re.finditer(r'labels? ((?:"[^"]+"(?:, )?)+)', left):
        labels.update(re.findall(r'"([^"]+)"', m.group(1)))
    return labels


def _source_items():
    """The ROADMAP item of every not_ported(...) call written with a
    literal item in the package."""
    items = set()
    for path in (pathlib.Path(REPO) / "liverrenderer_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", None) == "not_ported" \
                    and len(node.args) == 2 \
                    and isinstance(node.args[1], ast.Constant):
                items.add(node.args[1].value)
    return items


def test_every_raise_names_an_open_roadmap_item():
    """Every item a raise of the port names (the builder's plugin table,
    the emitter dispatch's table, and every literal not_ported call) is an
    open item that ROADMAP.md declares, and none is one this slice
    closed."""
    items = set(tbuilder._OTHER_TYPES.values()) | _source_items()
    labels = _roadmap_labels()
    assert "M9" in labels \
        and not {"M2", "M3", "M5", "M8", "M10", "M11", "M12"} & labels
    for item in items:
        m = re.fullmatch(r"Queue (\d) (.+)", item)
        assert m, item
        for part in m.group(2).split("/") if m.group(2).startswith("M") \
                else [m.group(2)]:
            assert part in labels, (item, sorted(labels))
        assert not re.search(r"bumpmap|directional|_bvh_tris|M[23578]\b"
                             r"|M1[012]", item), item
    # the plugins the slices ported load; names they did not still raise
    for t in ("bumpmap", "normalmap", "bitmap", "checkerboard", "envmap",
              "biovolpath06", "prbvolpath", "glissonCapsule", "glisson",
              "parenchyma", "path", "direct", "prb", "prb_basic",
              "thindielectric", "conductor", "roughconductor", "plastic",
              "roughplastic", "pplastic", "roughdielectric", "twosided",
              "blendbsdf", "mask", "directional", "directionalarea", "spot",
              "projector", "obj", "ply", "serialized", "disk", "cylinder",
              "blender", "merge", "srgb", "blackbody", "regular",
              "irregular", "heterogeneous", "volpathmis", "vaescatter",
              "dipole", "thinlens", "orthographic", "distant",
              "radiancemeter", "irradiancemeter", "batch", "aov", "depth",
              "moment", "ptracer", "stokes", "volprim_rf_basic",
              "ellipsoids", "ellipsoidsmesh", "polarizer", "retarder",
              "circular", "principled", "principledthin", "measured",
              "sunsky", "sun", "sky", "timed_sunsky", "hair", "linearcurve",
              "bsplinecurve", "sdfgrid", "instance", "shapegroup",
              "mesh_attribute", "volume", "gridvolume"):
        assert t not in tbuilder._OTHER_TYPES, t
    # the phase plugins load; a gridvolume is a medium's sigma_t and, since
    # the M10 item, a 3-D texture too
    for phase in ("rayleigh", "blendphase", "tabphase", "sggx"):
        assert f'"{phase}"' in pathlib.Path(tbuilder.__file__).read_text()
    d = liver_proxy_dict(4, 4, 1, 0)
    d["liver"]["bsdf"] = {"type": "diffuse", "reflectance": {
        "type": "gridvolume", "data": np.ones((2, 2, 2), np.float32)}}
    assert ir.TEX_VOLUME in lrt.load_dict(
        d, device="cpu").textures.types_present
    with pytest.raises(ValueError, match="unknown plugin"):
        lrt.load_dict({"type": "scene",
                       "s": {"type": "rectangle",
                             "bsdf": {"type": "no_such_bsdf"}}},
                      device="cpu")
