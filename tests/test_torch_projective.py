"""Shape gradients of the port against the JAX package on identical inputs
(made with numpy from a seed): the vertex refresh, the edge table, the
film projection, the silhouette weights, the primary boundary term per
sample on tests/test_projective.py's occluder, rough-mirror and
two-mirror scenes (both boundary terms with and without guiding:
tests/test_torch_projective_terms.py; render_grad of the vertices:
tests/test_torch_vertex_grad.py).

The port runs on scenes bridged from the JAX-built ones (the same BVH
leaf order, so the same packed rows).  Tolerances are stated per test:
gradients within 1e-4 of their largest |entry| (per-lane fp32 differences
summed over 4,096-65,536 samples), derived buffers bit-equal where both
packages compute them in the same float32 order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu.integrators import projective as jproj
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.bridge import numpy_tree, scene_from_numpy
from liverrenderer_tpu_torch.integrators import projective as tproj
from liverrenderer_tpu_torch.scene.liver_proxy import liver_proxy_dict
from torch_m10_scenes import mirror_dict, occluder_dict, two_mirror_dict
from torch_threads import torch_threads_per_worker  # noqa: F401

SCENES = {"occluder": occluder_dict, "mirror": mirror_dict,
          "two_mirror": two_mirror_dict}


def _scenes(d):
    js = lr.load_dict(d)
    return js, scene_from_numpy(*numpy_tree(js), "cpu")


@pytest.fixture(scope="module")
def shape_scenes():
    return {k: _scenes(f(16)) for k, f in SCENES.items()}


def _delta(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (h, w, 3)).astype(np.float32) / (h * w * 3)


def _grad_close(t, j, name, frac=1e-4):
    t, j = t.numpy(), np.asarray(j)
    scale = np.abs(j).max()
    np.testing.assert_allclose(t, j, rtol=0, atol=frac * max(scale, 1e-30),
                               err_msg=name)


def test_refresh_vertex_geometry_matches():
    """A seeded displacement of the bumped, sky-lit proxy's vertices:
    tri_si and normals within 1e-6, the re-packed kernel buffers equal,
    the displaced scene's image equal per pixel; tri_area_cdf, shape_area
    and the BVH keep their stale values, as in the JAX package."""
    js, ts = _scenes(liver_proxy_dict(16, 12, 4, 2, 0))
    rng = np.random.default_rng(1)
    V0 = np.asarray(js.vertices)
    V = V0 + rng.normal(0, 0.01, V0.shape).astype(np.float32)
    js2 = lr.apply_params(js, {"vertices": jnp.asarray(V)})
    ts2 = lrt.apply_params(ts, {"vertices": torch.from_numpy(V)})
    for k in ("tri_si", "normals"):
        np.testing.assert_allclose(getattr(ts2, k).numpy(),
                                   np.asarray(getattr(js2, k)), rtol=0,
                                   atol=1e-6, err_msg=k)
    for k in ("tri_buf", "tri_boxes", "tri_center"):
        np.testing.assert_array_equal(getattr(ts2, k).numpy(),
                                      np.asarray(getattr(js2, k)),
                                      err_msg=k)
    for k in ("tri_area_cdf", "shape_area"):
        assert getattr(ts2, k) is getattr(ts, k)
        np.testing.assert_array_equal(getattr(ts2, k).numpy(),
                                      np.asarray(getattr(js2, k)))
    assert ts2.bvh is ts.bvh
    img_t = lrt.render(ts2, spp=4, seed=3).numpy()
    img_j = np.asarray(lr.render(js2, spp=4, seed=3))
    rel = np.abs(img_t - img_j) / np.maximum(np.abs(img_j), 1e-3)
    assert (rel <= 1e-4).mean() >= 0.99
    np.testing.assert_allclose(img_t.mean(), img_j.mean(), rtol=1e-5)


@pytest.mark.parametrize("write", ["numpy", "tensor_data"])
def test_refresh_after_in_place_vertex_write(write):
    """Vertices written in place between two apply_params calls (a numpy
    array the tensor shares memory with, or a `.data` write that leaves
    the tensor's version alone) re-pack the kernel buffers from the new
    values: they equal the JAX package's for the written vertices."""
    js, ts = _scenes(liver_proxy_dict(8, 8, 1, 2, 0))
    rng = np.random.default_rng(4)
    V = np.asarray(js.vertices).copy()
    Vt = torch.from_numpy(V) if write == "tensor_data" else V
    lrt.apply_params(ts, {"vertices": Vt})
    dv = rng.normal(0, 0.02, V.shape).astype(np.float32)
    if write == "numpy":
        V += dv
    else:
        Vt.data += torch.from_numpy(dv)
    ts2 = lrt.apply_params(ts, {"vertices": Vt})
    js2 = lr.apply_params(js, {"vertices": jnp.asarray(V)})
    for k in ("tri_buf", "tri_boxes", "tri_center"):
        np.testing.assert_array_equal(getattr(ts2, k).numpy(),
                                      np.asarray(getattr(js2, k)),
                                      err_msg=k)
    np.testing.assert_allclose(ts2.tri_si.numpy(), np.asarray(js2.tri_si),
                               rtol=0, atol=1e-6)


def test_edge_table_bit_equal():
    js, ts = _scenes(liver_proxy_dict(8, 8, 1, 2, 0))
    F = np.asarray(js.faces)
    jv, jf = jproj.edge_table(F, js.n_tris)
    tv, tf = tproj.edge_table(ts.faces, ts.n_tris)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    # a closed mesh: every edge has two faces
    assert (tf[:, 1] >= 0).all() and len(tv) == 3 * ts.n_tris // 2


@pytest.mark.parametrize("sensor", ["perspective", "orthographic"])
def test_project_to_film_matches(sensor):
    d = occluder_dict(16)
    d["sensor"]["type"] = sensor
    js, ts = _scenes(d)
    rng = np.random.default_rng(2)
    p = rng.uniform(-0.8, 0.8, (2048, 3)).astype(np.float32)
    a = tproj.project_to_film(ts, torch.from_numpy(p)).numpy()
    b = np.asarray(jproj.project_to_film(js, jnp.asarray(p)))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_silhouette_weights_match(shape_scenes):
    for name, (js, ts) in shape_scenes.items():
        jv, jf = jproj.edge_table(np.asarray(js.faces), js.n_tris)
        tv, tf = tproj.edge_table(ts.faces, ts.n_tris)
        jw, jl = jproj.silhouette_weights(js, js.vertices, jv, jf)
        tw, tl = tproj.silhouette_weights(ts, ts.vertices, tv, tf)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6,
                                   err_msg=name)
