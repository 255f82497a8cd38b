"""The port's scene loading and bridge against the JAX package.

Buffers are compared exactly where both packages run the same numpy code
(integers exactly, floats at rtol 1e-6: every float is produced by the
same float64/float32 numpy operations; 1e-6 is a few float32 ulps).  The JAX package builds its BVH natively when its C++
library is built; the port always uses the numpy builder, so the exact
comparison patches the JAX side onto the numpy builder too, and a second
comparison keys the packed triangle rows by their baked triangle id.
"""
import os
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
from liverrenderer_tpu_torch.scene.liver_proxy import liver_proxy_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    # the cornell box's own integrator is the surface path tracer, which
    # the port does not carry yet (its NEE and BSDFs it does)
    assert ts.needs_surface_nee and ts.integrator == "path"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lrt.render(ts, spp=1)


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


def test_unported_plugins_raise():
    d = liver_proxy_dict(4, 4, 1, 0)
    d["liver"]["bsdf"] = {"type": "roughconductor"}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lrt.load_dict(d, device="cpu")
    d = liver_proxy_dict(4, 4, 1, 0)
    d["env"] = {"type": "envmap", "filename": "sky.exr"}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
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
