"""Instanced shapegroups and SDF grids: the port against the JAX package on
the CPU (tests/test_instancing.py's five tests and tests/test_sdfgrid.py's
four, each against JAX as well as on its own terms).

Tolerances:
- the builders' tables (group streams, instance rows, SDF grids) bit
  for bit;
- the instance pass per lane: the same hit set and prim code on every
  lane, t within rtol 1e-6 (both move the group triangles to world space
  with the same float32 operations, but XLA contracts a*b + c to an FMA
  and PyTorch does not);
- compute_si's instance decode per lane (p, t and the normals within
  2e-6) and the instanced interaction against the flattened twin's with
  the JAX test's criteria;
- the SDF march per lane: the same hit set and t within 4 ulps (2.4e-7
  at t ~ 2), the SDF normal within 1e-5;
- images >= 99 % of pixels within rtol 1e-3 / atol 1e-4 and the means
  within 1e-3 relative, the bsdfs.params gradient within 3e-6 of the
  largest entry.  The SDF scenes hold >= 97 % of pixels: a secondary ray
  leaving an SDF surface starts inside the march's 1e-3 shell, converges
  on its first step, and counts as a self-hit only when its t, rounded
  through t + s - s, lands above 1e-5: an ulp of the march (the FMA
  above) decides it, and 4 of 256 pixels of the 16^2 sphere flip (the
  means still agree within 1e-3).

The bsdfs.params gradient runs from tests/test_torch_instancing_grad.py,
which shares this file's scenes and tolerances, so that xdist's file
scheduler can start it apart from this file (a long file holds one
worker to its end).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu.accel import intersect as jint
from liverrenderer_tpu.core.types import Ray as JRay
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.accel import intersect as tint
from liverrenderer_tpu_torch.bridge import numpy_tree
from liverrenderer_tpu_torch.core.types import Ray as TRay
from torch_m10_scenes import (blobs_dict, instancing_dict, sdf_dict,
                              sphere_sdf)
from torch_threads import torch_threads_per_worker  # noqa: F401

PIX_RTOL, PIX_ATOL, PIX_FRAC, MEAN_RTOL = 1e-3, 1e-4, 0.99, 1e-3
SDF_PIX_FRAC = 0.97
G_ATOL_REL = 3e-6
N = 4096
_INST_KEYS = ("inst_tris", "inst_si", "inst_xf", "inst_face_start",
              "inst_n_chunks", "inst_bmin", "inst_bmax", "faces",
              "vertices", "tri_si", "shape_bsdf", "shape_prim_offset",
              "shape_prim_count", "sensor.bsphere")


def _rays(n, seed, origin, lo, hi):
    """n rays from about `origin` toward uniform targets in [lo, hi]."""
    rng = np.random.default_rng(seed)
    o = (np.asarray(origin, np.float32)
         + rng.normal(0, 0.02, (n, 3))).astype(np.float32)
    tgt = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=-1, keepdims=True)
    mx = np.where(rng.uniform(size=n) < 0.2, rng.uniform(1, 8, n),
                  np.inf).astype(np.float32)
    return (JRay(o=jnp.asarray(o), d=jnp.asarray(d), maxt=jnp.asarray(mx)),
            TRay(o=torch.from_numpy(o), d=torch.from_numpy(d),
                 maxt=torch.from_numpy(mx)))


def _assert_images_agree(img, ref, frac=PIX_FRAC):
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.abs(img - ref) <= PIX_ATOL + PIX_RTOL * np.abs(ref)
    assert close.all(-1).mean() >= frac
    assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())


@pytest.mark.parametrize("flatten", [False, True])
def test_instanced_scene_builds(flatten):
    """The counts of tests/test_instancing.py::test_instanced_scene_builds
    and the JAX builder's tables."""
    d = instancing_dict(3)
    js = lr.load_dict(d, flatten_instances=flatten)
    ts = lrt.load_dict(d, device="cpu", flatten_instances=flatten)
    ja, jst = numpy_tree(js)
    ta, tst = numpy_tree(ts)
    for k in _INST_KEYS:
        np.testing.assert_array_equal(ta[k], np.asarray(ja[k]), err_msg=k)
    for k in ("n_instances", "n_inst_tris", "inst_max_chunks", "n_tris"):
        assert tst[k] == jst[k], k
    if flatten:
        assert ts.n_instances == 0 and ts.n_tris == 2 + 3 * 14
    else:
        assert ts.n_instances == 3 and ts.inst_max_chunks >= 1
        assert ts.n_inst_tris >= 14 and ts.n_tris == 2


def test_geometry_memory_is_o1_in_instances():
    s10 = lrt.load_dict(instancing_dict(10), device="cpu")
    s40 = lrt.load_dict(instancing_dict(40), device="cpu")
    assert s10.inst_tris.shape == s40.inst_tris.shape
    assert s10.inst_si.shape == s40.inst_si.shape
    assert s10.vertices.shape == s40.vertices.shape
    assert s40.inst_xf.shape == (40, 21)
    f10 = lrt.load_dict(instancing_dict(10), device="cpu",
                        flatten_instances=True)
    f40 = lrt.load_dict(instancing_dict(40), device="cpu",
                        flatten_instances=True)
    assert f40.n_tris - f10.n_tris == 30 * 14


def test_instance_pass_matches_jax_per_lane():
    """_instances on seeded rays into 12 instances, from the same
    t_best: every lane's hit and prim code equal, t within fp32."""
    d = instancing_dict(12)
    js = lr.load_dict(d)
    ts = lrt.load_dict(d, device="cpu")
    jr, tr = _rays(N, 0, [0, -6, 2], [-2.6, -1.6, -0.4], [2.6, 1.6, 0.5])
    t0 = np.where(np.isfinite(np.asarray(jr.maxt)), np.asarray(jr.maxt),
                  np.inf).astype(np.float32)
    j = jint._instances(js, jr, jnp.asarray(t0), jnp.full(N, -1, jnp.int32),
                        jnp.zeros(N), jnp.zeros(N))
    t = tint._instances(ts, tr, torch.from_numpy(t0),
                        torch.full((N,), -1, dtype=torch.int64),
                        torch.zeros(N), torch.zeros(N))
    jt, jp = np.asarray(j[0]), np.asarray(j[1])
    tt, tp = t[0].numpy(), t[1].numpy()
    np.testing.assert_array_equal(tp, jp)
    hit = jp >= 0
    assert hit.mean() > 0.2
    np.testing.assert_array_equal(np.isfinite(tt), np.isfinite(jt))
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=1e-6)
    for a, b in zip(t[2:], j[2:]):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                   rtol=1e-4, atol=1e-5)


def test_instanced_matches_flattened_intersection():
    """ray_intersect on the instanced scene against JAX (per lane) and
    against the port's flattened twin (the JAX test's criteria)."""
    d = instancing_dict(5)
    js = lr.load_dict(d)
    ts = lrt.load_dict(d, device="cpu")
    tf = lrt.load_dict(d, device="cpu", flatten_instances=True)
    jr, tr = _rays(N, 1, [0, -6, 2], [-2.6, -1.6, -0.4], [2.6, 1.6, 0.5])
    a = jint.ray_intersect(js, jr)
    b = tint.ray_intersect(ts, tr)
    hit = np.isfinite(np.asarray(a.t))
    np.testing.assert_array_equal(b.valid.numpy(), hit)
    np.testing.assert_array_equal(b.prim.numpy(), np.asarray(a.prim))
    np.testing.assert_array_equal(b.shape.numpy(), np.asarray(a.shape))
    for k in ("t", "p", "ng", "uv"):
        np.testing.assert_allclose(getattr(b, k).numpy()[hit],
                                   np.asarray(getattr(a, k))[hit],
                                   rtol=2e-6, atol=2e-6, err_msg=k)
    np.testing.assert_allclose(b.sh_frame.n.numpy()[hit],
                               np.asarray(a.sh_frame.n)[hit], atol=2e-6)
    inst = b.prim.numpy() >= ts.n_tris
    assert (inst & hit).mean() > 0.1
    c = tint.ray_intersect(tf, tr)
    hc = c.valid.numpy()
    assert (hc != hit).mean() < 2e-3
    both = hit & hc
    np.testing.assert_allclose(b.t.numpy()[both], c.t.numpy()[both],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b.sh_frame.n.numpy()[both],
                               c.sh_frame.n.numpy()[both], atol=1e-4)
    # both bind the same reflectance
    for s, x in ((ts, b), (tf, c)):
        bs = s.shape_bsdf.numpy()[x.shape.numpy()[both]]
        x.refl = s.textures.data.numpy()[s.bsdfs.tex0.numpy()[bs], :3]
    np.testing.assert_allclose(b.refl, c.refl, atol=1e-6)


@pytest.mark.parametrize("light", ["point", "constant"])
def test_instanced_render_matches_jax(light):
    """4 instances at 24 x 18, 8 spp: the port's image against JAX's per
    pixel, and against its own flattened twin (the JAX test's gates)."""
    d = instancing_dict(4, light=light, res=(24, 18))
    ref = np.asarray(lr.render(lr.load_dict(d), spp=8, seed=0))
    img = lrt.render(lrt.load_dict(d, device="cpu"), spp=8, seed=0).numpy()
    _assert_images_agree(img, ref)
    flat = lrt.render(lrt.load_dict(d, device="cpu", flatten_instances=True),
                      spp=8, seed=0).numpy()
    assert np.abs(img - flat).mean() < 2e-3
    assert np.abs(img - flat).max() < 0.2


def test_many_instances_render():
    """100 instances under the constant light at 24 x 18, 4 spp."""
    d = instancing_dict(100, light="constant", res=(24, 18))
    ts = lrt.load_dict(d, device="cpu")
    assert ts.n_instances == 100
    img = lrt.render(ts, spp=4, seed=0).numpy()
    assert np.isfinite(img).all() and img.mean() > 0.01
    _assert_images_agree(img, np.asarray(lr.render(lr.load_dict(d), spp=4,
                                                   seed=0)))


def test_refusals_match_jax():
    """An instance of an unknown shapegroup: KeyError in both builders."""
    d = instancing_dict(2)
    d["inst0"]["grp_ref"]["id"] = "no_such_group"
    with pytest.raises(KeyError):
        lr.load_dict(d)
    with pytest.raises(KeyError):
        lrt.load_dict(d, device="cpu")


# ---------------------------------------------------------------------------
# SDF grids
# ---------------------------------------------------------------------------

def test_sdf_builder_tables():
    d = sdf_dict(sphere_sdf(12), 8, to_world=np.diag(
        [2.0, 1.5, 1.0, 1.0]).astype(np.float32))
    d["sdf2"] = dict(d["sdf"], grid=sphere_sdf(16, 0.2))
    ja, jst = numpy_tree(lr.load_dict(d))
    ta, tst = numpy_tree(lrt.load_dict(d, device="cpu"))
    for k in ("sdf_grids", "sdf_whd", "sdf_to_local", "sdf_shape",
              "shape_type", "shape_area", "sensor.bsphere"):
        np.testing.assert_array_equal(ta[k], np.asarray(ja[k]), err_msg=k)
    assert tst["n_sdfs"] == jst["n_sdfs"] == 2


def test_sdf_march_and_normals_match_jax_per_lane():
    """_sdfs and ray_intersect's SDF branch on seeded rays through a 32^3
    sphere SDF: the hit set and SDF index on every lane, t, p and the
    central-difference normal within fp32."""
    d = sdf_dict(sphere_sdf(32), 8)
    js = lr.load_dict(d)
    ts = lrt.load_dict(d, device="cpu")
    jr, tr = _rays(N, 2, [0.5, 0.5, 2.5], [0.1] * 3, [0.9] * 3)
    t0 = np.full(N, np.inf, np.float32)
    jt, jk = jint._sdfs(js, jr, jnp.asarray(t0))
    tt, tk = tint._sdfs(ts, tr, torch.from_numpy(t0))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    hit = np.asarray(jk) >= 0
    assert 0.2 < hit.mean() < 0.95
    np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit],
                               rtol=2.4e-7 / 2.0, atol=2.4e-7)
    a = jint.ray_intersect(js, jr)
    b = tint.ray_intersect(ts, tr)
    hit = np.isfinite(np.asarray(a.t))         # within maxt
    np.testing.assert_array_equal(b.valid.numpy(), hit)
    np.testing.assert_array_equal(b.shape.numpy()[hit],
                                  np.asarray(a.shape)[hit])
    for k, tol in (("p", 3e-7), ("uv", 3e-7), ("ng", 1e-5)):
        np.testing.assert_allclose(getattr(b, k).numpy()[hit],
                                   np.asarray(getattr(a, k))[hit],
                                   rtol=0, atol=tol, err_msg=k)


def test_sdf_normals_and_shadow():
    """tests/test_sdfgrid.py's ray checks: the front of the sphere at t ~
    1.7 with normal +z, and ray_test sees the SDF as an occluder."""
    ts = lrt.load_dict(sdf_dict(sphere_sdf(48), 8), device="cpu")
    ray = TRay(o=torch.tensor([[0.5, 0.5, 2.5]] * 2),
               d=torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0]]),
               maxt=torch.tensor([float("inf"), 5.0]))
    si = tint.ray_intersect(ts, ray)
    assert bool(si.valid[0]) and not bool(si.valid[1])
    assert abs(float(si.t[0]) - (2.5 - 0.8)) < 0.02
    assert float(si.sh_frame.n[0, 2]) > 0.95
    hit = tint.ray_test(ts, TRay(o=ray.o, d=ray.d,
                                 maxt=torch.tensor([5.0, 5.0])))
    assert hit.tolist() == [True, False]


@pytest.mark.parametrize("scene", ["sdf_sphere", "ellipsoids"])
def test_sdf_and_ellipsoid_renders_match_jax(scene):
    """tests/test_sdfgrid.py's two images at 16^2, 8 spp, per pixel, with
    the JAX tests' checks (a green sphere in the middle, the env in the
    corner; two red blobs around a gap)."""
    d = sdf_dict(sphere_sdf(32), 16) if scene == "sdf_sphere" \
        else blobs_dict(16)
    ref = np.asarray(lr.render(lr.load_dict(d), spp=8, seed=0))
    img = lrt.render(lrt.load_dict(d, device="cpu"), spp=8, seed=0).numpy()
    _assert_images_agree(img, ref, SDF_PIX_FRAC if scene == "sdf_sphere"
                         else PIX_FRAC)
    if scene == "sdf_sphere":
        assert img[8, 8, 1] > 2.0 * img[8, 8, 0]
        assert abs(img[1, 1].mean() - 1.0) < 0.1
    else:
        assert img[8, 5, 0] > 2 * img[8, 5, 1]
        assert img[8, 10, 0] > 2 * img[8, 10, 1]
        assert abs(img[2, 8].mean() - 1.0) < 0.1
