"""The port's closest-hit sweep against the JAX package's Pallas kernels.

The JAX side runs its kernel in TPU interpret mode on the CPU
(`pltpu.force_tpu_interpret_mode`); the port runs the kernel's plain
PyTorch version, which is what a CPU tensor takes.  The cases are those of
tests/test_pallas_intersect.py.  Tolerances: hit sets equal (both sweep the
same packed Baldwin-Weber rows with the same fp32 operations); t at rtol
1e-5 (XLA and PyTorch may round a fused expression differently in the last
ulp); prims >= 99 % equal (a ray through a shared edge may take either
triangle at an equal t).  The CUDA kernel itself is held against the plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import liverrenderer_tpu as lr
from liverrenderer_tpu.accel import intersect as jint
from liverrenderer_tpu.accel import pallas_intersect as jpk
from liverrenderer_tpu.core.types import Ray as JRay
from liverrenderer_tpu_torch.accel import cuda_intersect as tci
from liverrenderer_tpu_torch.accel import intersect as tint
from liverrenderer_tpu_torch.bridge import numpy_tree, scene_from_numpy
from liverrenderer_tpu_torch.core.types import Ray as TRay


def _cornell(scene_fn=None):
    d = lr.cornell_box()
    d["sensor"]["film"]["width"] = 8
    d["sensor"]["film"]["height"] = 8
    js = lr.load_dict(d)
    if scene_fn is not None:
        js = scene_fn(js)
    return js, scene_from_numpy(*numpy_tree(js), "cpu")


def _rays(np_rng, n, offset=None):
    o = np_rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    if offset is not None:
        o = (o + offset).astype(np.float32)
    d = np_rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _both(js, ts, o, d, maxt):
    jray = JRay(o=jnp.asarray(o), d=jnp.asarray(d), maxt=jnp.asarray(maxt))
    with pltpu.force_tpu_interpret_mode():
        jt, jp, _, _, _ = jint.ray_intersect_preliminary(
            js.replace(intersector="pallas"), jray)
    tray = TRay(o=torch.from_numpy(o), d=torch.from_numpy(d),
                maxt=torch.from_numpy(np.asarray(maxt, np.float32)))
    tt, tp, _, _, _ = tint.ray_intersect_preliminary(ts, tray)
    return (np.asarray(jt), np.asarray(jp)), (tt.numpy(), tp.numpy()), \
        jray, tray


def _assert_hits_agree(j, t, min_hits, atol=0.0):
    (jt, jp), (tt, tp) = j, t
    hit = jp >= 0
    assert hit.sum() >= min_hits
    np.testing.assert_array_equal(tp >= 0, hit)
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=1e-5, atol=atol)
    assert (tp[hit] == jp[hit]).mean() >= 0.99


def test_random_rays_match_pallas(np_rng):
    js, ts = _cornell()
    o, d = _rays(np_rng, 512)
    j, t, jray, tray = _both(js, ts, o, d, np.full(512, np.inf, np.float32))
    _assert_hits_agree(j, t, min_hits=100)
    with pltpu.force_tpu_interpret_mode():
        jocc = jint.ray_test(js.replace(intersector="pallas"), jray)
    np.testing.assert_array_equal(tint.ray_test(ts, tray).numpy(),
                                  np.asarray(jocc))
    # compute_si through both packages on the lanes with the same winner
    with pltpu.force_tpu_interpret_mode():
        jsi = jint.ray_intersect(js.replace(intersector="pallas"), jray)
    tsi = tint.ray_intersect(ts, tray)
    same = (j[1] == t[1]) & (j[1] >= 0)
    for name in ("t", "p", "ng", "uv", "wi", "shape", "prim"):
        a = getattr(tsi, name).numpy()[same]
        b = np.asarray(getattr(jsi, name))[same]
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(tsi.sh_frame.n.numpy()[same],
                               np.asarray(jsi.sh_frame.n)[same],
                               rtol=1e-5, atol=1e-6)


def test_far_from_origin_matches_pallas(np_rng):
    """The scene ~1e4 units from the origin: the local-frame re-centring
    of pack_tris keeps both sweeps precise, and they agree."""
    from liverrenderer_tpu.util import refresh_vertex_geometry
    off = np.array([1.0e4, -7.0e3, 5.0e3], np.float32)
    js, ts = _cornell(lambda s: refresh_vertex_geometry(
        s, s.vertices + jnp.asarray(off)[None]))
    o, d = _rays(np_rng, 512, offset=off)
    j, t, _, _ = _both(js, ts, o, d, np.full(512, np.inf, np.float32))
    _assert_hits_agree(j, t, min_hits=100)


def test_maxt_rejection_matches_pallas(np_rng):
    js, ts = _cornell()
    o, d = _rays(np_rng, 256)
    (jt, _), _, _, _ = _both(js, ts, o, d, np.full(256, np.inf, np.float32))
    near = np.where(np.isfinite(jt), jt * 0.5, 1e-3).astype(np.float32)
    j, t, _, _ = _both(js, ts, o, d, near)
    assert (j[1] < 0).all() and (t[1] < 0).all()


def test_streaming_regime_matches_pallas(np_rng, monkeypatch):
    """Past the VMEM-resident cap the JAX package streams triangle blocks
    (K2); block sizes shrunk to 512 so interpret mode walks three blocks.
    The port packs the same buffer and its one sweep gives the same hits."""
    for mod in (jpk, tci):
        monkeypatch.setattr(mod, "MAX_VMEM_TRIS", 512)
        monkeypatch.setattr(mod, "SUPER_T", 512)
    T, R = 1500, 256
    v0 = np_rng.uniform(-1, 1, (T, 3)).astype(np.float32)
    v1 = v0 + np_rng.uniform(-0.2, 0.2, (T, 3)).astype(np.float32)
    v2 = v0 + np_rng.uniform(-0.2, 0.2, (T, 3)).astype(np.float32)
    jbuf = jpk.pack_tris(v0, v1, v2)
    tbuf = tci.pack_tris(v0, v1, v2)
    assert tbuf[0].shape[0] == 1536
    for a, b in zip(tbuf, jbuf):
        np.testing.assert_array_equal(a, b)
    o = np_rng.uniform(-2, 2, (R, 3)).astype(np.float32)
    aim = np_rng.uniform(-0.6, 0.6, (R, 3)).astype(np.float32)
    d = aim - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    inf = np.full(R, np.inf, np.float32)
    buf, boxes, kperm, center = jbuf
    with pltpu.force_tpu_interpret_mode():
        jt, jp, _, _ = jpk.intersect_tris(
            jnp.asarray(buf), jnp.asarray(boxes), jnp.asarray(kperm),
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(inf),
            jnp.asarray(inf), center=jnp.asarray(center))
    tt, tp, _, _ = tci.intersect_tris(
        *(torch.from_numpy(x) for x in tbuf[:3]), torch.from_numpy(o),
        torch.from_numpy(d), torch.from_numpy(inf), torch.from_numpy(inf),
        center=torch.from_numpy(tbuf[3]))
    _assert_hits_agree((np.asarray(jt), np.asarray(jp)),
                       (tt.numpy(), tp.numpy()), min_hits=50)


def test_ray_sort_keeps_results(np_rng):
    """The optional coherence sort reorders the query, not its answers."""
    _, ts = _cornell()
    o, d = _rays(np_rng, 300)
    ray = TRay(o=torch.from_numpy(o), d=torch.from_numpy(d),
               maxt=torch.full((300,), float("inf")))
    a = tint.ray_intersect_preliminary(ts, ray)
    b = tint.ray_intersect_preliminary(ts.replace(ray_sort=True), ray)
    for x, y in zip(a[:2], b[:2]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_brute_strategy_matches_sweep(np_rng):
    _, ts = _cornell()
    o, d = _rays(np_rng, 512)
    ray = TRay(o=torch.from_numpy(o), d=torch.from_numpy(d),
               maxt=torch.full((512,), float("inf")))
    tk, pk, _, _, _ = tint.ray_intersect_preliminary(ts, ray)
    tb, pb, _, _, _ = tint.ray_intersect_preliminary(
        ts.replace(intersector="brute"), ray)
    # Moeller-Trumbore and Baldwin-Weber round differently: the JAX
    # package's own brute-vs-kernel tolerance (rtol 1e-5, atol 1e-6)
    _assert_hits_agree((tb.numpy(), pb.numpy()), (tk.numpy(), pk.numpy()),
                       min_hits=100, atol=1e-6)


def test_wrapper_checks_inputs():
    tris = torch.zeros((128, 16))
    boxes = torch.zeros((1, 8))
    with pytest.raises(ValueError, match="rays"):
        tci.intersect_closest(torch.zeros((7, 4)), tris, boxes)
    with pytest.raises(ValueError, match="Tpad"):
        tci.intersect_closest(torch.zeros((8, 4)), tris[:100], boxes)
    with pytest.raises(TypeError, match="float32"):
        tci.intersect_closest(torch.zeros((8, 4), dtype=torch.float64),
                              tris, boxes)
    # a CPU tensor takes the plain version and never counts a launch
    before = tci.LAUNCHES
    t, p = tci.intersect_closest(torch.zeros((8, 4)), tris, boxes)
    assert tci.LAUNCHES == before
    assert (p == -1).all() and torch.isinf(t).all()
