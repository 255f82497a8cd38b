"""The lockstep BVH traversal and the C++ BVH build of the port against
the JAX package and the numpy build, on the CPU.

`_bvh_tris` runs on the JAX-built scene's own BVH (bridged), so both
packages traverse the same nodes: hits must be equal (prim exactly; t
within fp32 rtol 1e-6 / atol 1e-7 and the barycentrics u, v within 1e-5:
both run the same Moeller-Trumbore formulas, in which XLA and PyTorch may
sum the three products of a dot in another order, and u and v divide by
the determinant).  The C++ build must give the numpy build's nodes exactly
and the same triangles in each leaf (their order inside a leaf may
differ), and so the same closest hits.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu.accel import intersect as jint
from liverrenderer_tpu.core.types import Ray as JRay
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.accel import bvh as tbvh
from liverrenderer_tpu_torch.accel import cuda_intersect
from liverrenderer_tpu_torch.accel import intersect as tint
from liverrenderer_tpu_torch.bridge import numpy_tree, scene_from_numpy
from liverrenderer_tpu_torch.core.types import Ray
from liverrenderer_tpu_torch.scene.liver_proxy import (liver_mesh,
                                                       liver_proxy_dict)
from torch_threads import torch_threads_per_worker  # noqa: F401


def _rays(rng, n, spread=0.4):
    o = (rng.normal(size=(n, 3)) * spread).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxt = np.where(rng.uniform(size=n) < 0.3,
                    rng.uniform(0.05, 1.0, n), np.inf).astype(np.float32)
    return o, d, maxt


def _tray(o, d, maxt):
    return Ray(o=torch.from_numpy(o), d=torch.from_numpy(d),
               maxt=torch.from_numpy(maxt))


def test_bvh_tris_matches_jax():
    """The JAX package's `_bvh_tris` and the port's on the same BVH of the
    5,120-triangle liver proxy (intersector="bvh"), rays inside and
    around the mesh, some with a finite maxt."""
    js = lr.load_dict(liver_proxy_dict(8, 8, 1, 4, 0)).replace(
        intersector="bvh")
    ts = scene_from_numpy(*numpy_tree(js), "cpu")
    assert ts.intersector == "bvh" and ts.n_tris == 5120
    assert tint._tri_strategy(ts) is tint._bvh_tris
    o, d, maxt = _rays(np.random.default_rng(1), 2048)
    tb = np.where(np.isfinite(maxt), maxt, np.inf).astype(np.float32)
    jt, jp, ju, jv = jint._bvh_tris(
        js, JRay(o=jnp.asarray(o), d=jnp.asarray(d), maxt=jnp.asarray(maxt)),
        jnp.asarray(tb), False)
    tt, tp, tu, tv = tint._bvh_tris(ts, _tray(o, d, maxt),
                                    torch.from_numpy(tb), False)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    hit = np.asarray(jp) >= 0
    assert 0.3 < hit.mean() < 1.0
    np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit],
                               rtol=1e-6, atol=1e-7)
    for t, j in ((tu, ju), (tv, jv)):
        np.testing.assert_allclose(t.numpy()[hit], np.asarray(j)[hit],
                                   atol=1e-5)
    assert np.isinf(tt.numpy()[~hit & ~np.isfinite(maxt)]).all()


def _mesh_vertices(subdiv):
    verts, faces = liver_mesh(subdiv, 0)[:2]
    return verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]


def test_native_build_matches_numpy_build():
    """csrc/bvh_build.cpp against the numpy build on the 20,480-triangle
    proxy: the same nodes bit for bit, the same triangles in every leaf,
    and the same closest hits when the port traverses either."""
    v0, v1, v2 = _mesh_vertices(5)
    a = tbvh.build_bvh_numpy(v0, v1, v2)
    b = tbvh.build_bvh_native(v0, v1, v2)
    for k in ("node_min", "node_max", "right", "first", "count"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k), k)
    assert a.depth == b.depth
    for i in np.nonzero(a.right < 0)[0]:
        s = slice(a.first[i], a.first[i] + a.count[i])
        np.testing.assert_array_equal(np.sort(b.perm[s]), np.sort(a.perm[s]))
    np.testing.assert_array_equal(np.sort(b.perm), np.arange(len(v0)))
    ts = lrt.load_dict(liver_proxy_dict(8, 8, 1, 5, 0), device="cpu")

    def with_bvh(x):
        return ts.replace(intersector="bvh", bvh=dataclasses.replace(
            ts.bvh, **{k: torch.from_numpy(getattr(x, k).astype(
                np.float32 if k.startswith("node") else np.int64))
                for k in ("node_min", "node_max", "right", "first", "count",
                          "perm")}, depth=x.depth))

    o, d, maxt = _rays(np.random.default_rng(2), 2048)
    tb = torch.from_numpy(np.where(np.isfinite(maxt), maxt, np.inf)
                          .astype(np.float32))
    ra = tint._bvh_tris(with_bvh(a), _tray(o, d, maxt), tb, False)
    rb = tint._bvh_tris(with_bvh(b), _tray(o, d, maxt), tb, False)
    for x, y in zip(ra, rb):
        assert torch.equal(x, y)


def test_large_meshes_take_the_native_build(monkeypatch):
    """Past NATIVE_MIN_TRIS triangles the builder's BVH is the C++ one;
    at or below it, the numpy one (the leaf order every existing image
    was rendered with)."""
    from liverrenderer_tpu_torch.scene.builder import build_numpy
    v0, v1, v2 = _mesh_vertices(3)
    for limit, want in ((1 << 16, tbvh.build_bvh_numpy(v0, v1, v2)),
                        (1000, tbvh.build_bvh_native(v0, v1, v2))):
        monkeypatch.setattr(tbvh, "NATIVE_MIN_TRIS", limit)
        arrays, _ = build_numpy(liver_proxy_dict(4, 4, 1, 3, 0))
        np.testing.assert_array_equal(arrays["bvh.perm"], want.perm)


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """A source the compiler rejects raises; nothing falls back."""
    bad = tmp_path / "bvh_build.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tbvh, "_LIB", None)
    monkeypatch.setattr(tbvh, "_SRC", bad)
    monkeypatch.setattr(tbvh, "_BUILD_DIR", tmp_path / "build")
    v0, v1, v2 = _mesh_vertices(1)
    with pytest.raises(RuntimeError, match="compiling bvh_build.cpp failed"):
        tbvh.build_bvh_native(v0, v1, v2)


@pytest.mark.parametrize("route", ["intersector_bvh", "past_stream_limit"])
def test_bvh_route_renders_as_the_sweep(monkeypatch, route):
    """intersector="bvh", and a mesh past the sweep's triangle limit
    (the limit lowered below the proxy's 5,120 triangles), render the
    image the closest-hit sweep renders."""
    ts = lrt.load_dict(liver_proxy_dict(12, 8, 2, 4, 0), device="cpu")
    ref = lrt.render(ts, spp=2, seed=3)
    if route == "intersector_bvh":
        sc = ts.replace(intersector="bvh")
    else:
        monkeypatch.setattr(cuda_intersect, "MAX_STREAM_TRIS", 4096)
        sc = ts
    assert tint._tri_strategy(sc) is tint._bvh_tris
    img = lrt.render(sc, spp=2, seed=3)
    assert torch.equal(img, ref) and img.mean() > 0.1
