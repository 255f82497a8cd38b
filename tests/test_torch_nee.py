"""Next-event estimation's components in the port against the JAX package
on identical inputs (made with numpy from a seed; scenes built by the JAX
builder and bridged, or built by both builders from one dict).

Tolerance: fp32, rtol 1e-5 with atol 1e-6 unless stated.  Both packages
run the same formulas in float32; XLA and PyTorch may differ by an ulp in
a transcendental (sqrt, exp, sin, cos) or a fused expression.  Discrete
outcomes (emitter and triangle picks, masks, sampler dimensions) must be
equal.  Scene buffers built by both builders are compared bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
import liverrenderer_tpu._native as jnative
from liverrenderer_tpu.bsdf import dispatch as jbsdf
from liverrenderer_tpu.core import distr as jdistr
from liverrenderer_tpu.core import math as jm
from liverrenderer_tpu.core import rng as jrng
from liverrenderer_tpu.core import warp as jwarp
from liverrenderer_tpu.core.types import SurfaceInteraction as JSI
from liverrenderer_tpu.emitter import dispatch as jem
from liverrenderer_tpu.integrators import volpath as jvp
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.bridge import numpy_tree, scene_from_numpy
from liverrenderer_tpu_torch.bsdf import dispatch as tbsdf
from liverrenderer_tpu_torch.core import distr as tdistr
from liverrenderer_tpu_torch.core import math as tm
from liverrenderer_tpu_torch.core import rng as trng
from liverrenderer_tpu_torch.core import warp as twarp
from liverrenderer_tpu_torch.core.types import SurfaceInteraction as TSI
from liverrenderer_tpu_torch.emitter import dispatch as tem
from liverrenderer_tpu_torch.integrators import volpath as tvp
from liverrenderer_tpu_torch.scene import cornell as tcornell
from test_torch_grad_keys import few_boundary_samples
from torch_threads import torch_threads_per_worker  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
N = 4096


def _close(t, j, name="", rtol=RTOL, atol=ATOL):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    if np.issubdtype(j.dtype, np.floating):
        np.testing.assert_allclose(t, j, rtol=rtol, atol=atol, err_msg=name)
    else:
        np.testing.assert_array_equal(t, j.astype(t.dtype), err_msg=name)


def _bridge(d):
    js = lr.load_dict(d)
    return js, scene_from_numpy(*numpy_tree(js), "cpu")


def _rgb(v):
    return {"type": "rgb", "value": v}


@pytest.fixture(scope="module")
def emitters_scene():
    """Every emitter type the port carries, several BSDF families (a
    twosided diffuse included) and a uniform-textured area sphere."""
    tw = lr.Transform
    return _bridge({
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": 6},
        "sensor": {"type": "perspective",
                   "film": {"type": "hdrfilm", "width": 4, "height": 4,
                            "rfilter": {"type": "box"}}},
        "plane": {"type": "rectangle",
                  "bsdf": {"type": "twosided",
                           "bsdf": {"type": "diffuse",
                                    "reflectance": _rgb([0.6, 0.5, 0.4])}}},
        "glass": {"type": "rectangle", "bsdf": {"type": "dielectric"},
                  "to_world": tw().translate([0, 0, -1.0])},
        "veil": {"type": "rectangle", "bsdf": {"type": "null"},
                 "to_world": tw().translate([0, 0, -2.0])},
        "lamp": {"type": "rectangle",
                 "to_world": tw().translate([0, 0, 2.0])
                 .rotate([1, 0, 0], 180).scale(0.5),
                 "emitter": {"type": "area", "radiance": _rgb([4.0, 3.0,
                                                               2.0])}},
        "ball": {"type": "sphere", "center": [1.5, 0.5, 1.0],
                 "radius": 0.3,
                 "bsdf": {"type": "diffuse"},
                 "emitter": {"type": "area",
                             "radiance": {"type": "uniform", "value": 2.5}}},
        "pt": {"type": "point", "position": [0.5, 0.5, 1.5],
               "intensity": _rgb([6.0, 5.0, 4.0])},
        "env": {"type": "constant", "radiance": _rgb([0.3, 0.4, 0.5])},
    })


def _si_pair(np_rng, n, shape=None, valid=None):
    """A SurfaceInteraction of random shading frames and incident
    directions, for both packages."""
    ng = np_rng.normal(size=(n, 3)).astype(np.float32)
    ng /= np.linalg.norm(ng, axis=-1, keepdims=True)
    wi = np_rng.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    p = np_rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    uv = np_rng.uniform(size=(n, 2)).astype(np.float32)
    shape = np.zeros(n, np.int64) if shape is None else shape
    t = np.ones(n, np.float32)
    if valid is not None:
        t[~valid] = np.inf
    js = JSI(t=jnp.asarray(t), p=jnp.asarray(p), ng=jnp.asarray(ng),
             sh_frame=jm.make_frame(jnp.asarray(ng)), uv=jnp.asarray(uv),
             wi=jnp.asarray(wi), prim=jnp.zeros(n, jnp.int32),
             shape=jnp.asarray(shape, jnp.int32))
    ts = TSI(t=torch.from_numpy(t), p=torch.from_numpy(p),
             ng=torch.from_numpy(ng), sh_frame=tm.make_frame(
                 torch.from_numpy(ng)), uv=torch.from_numpy(uv),
             wi=torch.from_numpy(wi), prim=torch.zeros(n, dtype=torch.int64),
             shape=torch.from_numpy(shape))
    return js, ts


def test_discrete_distribution_matches(np_rng):
    w = np.array([0.5, 2.0, 0.0, 1.25, 3.0, 0.75, 0.1], np.float32)
    u = np_rng.uniform(size=N).astype(np.float32)
    u[:4] = [0.0, 0.5 / 7.6, (0.5 + 2.0) / 7.6, 0.99999994]   # edges
    jd = jdistr.DiscreteDistribution.build(w)
    td = tdistr.DiscreteDistribution.build(torch.from_numpy(w))
    _close(td.cdf, jd.cdf, "cdf", rtol=0, atol=0)
    for a, b, k in zip(td.sample_reuse(torch.from_numpy(u)),
                       jd.sample_reuse(jnp.asarray(u)),
                       ("idx", "u2", "pdf")):
        _close(a, b, k)
    for a, b, k in zip(td.sample(torch.from_numpy(u)),
                       jd.sample(jnp.asarray(u)), ("idx", "pdf")):
        _close(a, b, k)
    idx = np_rng.integers(0, len(w), N)
    _close(td.eval_pdf(torch.from_numpy(idx)),
           jd.eval_pdf(jnp.asarray(idx)), "eval_pdf")
    # the zero-weight entry is never picked
    assert (td.sample_reuse(torch.from_numpy(u))[0] != 2).all()


def test_warps_match(np_rng):
    u = np_rng.uniform(size=(N, 2)).astype(np.float32)
    u[:3] = [[0.5, 0.5], [0.5, 0.9], [0.0, 0.5]]     # centre and axes
    tu, ju = torch.from_numpy(u), jnp.asarray(u)
    _close(twarp.square_to_uniform_disk_concentric(tu),
           jwarp.square_to_uniform_disk_concentric(ju), "disk")
    tc = twarp.square_to_cosine_hemisphere(tu)
    # z = sqrt(1 - x^2 - y^2) magnifies an ulp of x, y (their cos and sin)
    # by 1/z near the equator
    _close(tc, jwarp.square_to_cosine_hemisphere(ju), "cosine", atol=1e-5)
    _close(twarp.square_to_cosine_hemisphere_pdf(tc),
           jwarp.square_to_cosine_hemisphere_pdf(jnp.asarray(tc.numpy())),
           "cosine pdf")
    _close(twarp.square_to_uniform_triangle(tu),
           jwarp.square_to_uniform_triangle(ju), "triangle")
    assert twarp.INV_PI == pytest.approx(float(jwarp.INV_PI))
    assert twarp.INV_FOURPI == pytest.approx(float(jwarp.INV_FOURPI))


def test_diffuse_sample_and_eval_match(np_rng):
    wi = np_rng.normal(size=(N, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    wo = np_rng.normal(size=(N, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    u2 = np_rng.uniform(size=(N, 2)).astype(np.float32)
    t0 = np_rng.uniform(size=(N, 3)).astype(np.float32)
    args_t = (torch.from_numpy(wi), None, torch.from_numpy(u2), None,
              torch.from_numpy(t0), None)
    args_j = (jnp.asarray(wi), None, jnp.asarray(u2), None, jnp.asarray(t0),
              None)
    for a, b, k in zip(tbsdf._diffuse_sample(*args_t),
                       jbsdf._diffuse_sample(*args_j),
                       ("wo", "pdf", "weight", "eta", "type")):
        _close(a, b, k)
    for a, b, k in zip(
            tbsdf._diffuse_eval(torch.from_numpy(wi), torch.from_numpy(wo),
                                None, torch.from_numpy(t0), None),
            jbsdf._diffuse_eval(jnp.asarray(wi), jnp.asarray(wo), None,
                                jnp.asarray(t0), None), ("val", "pdf")):
        _close(a, b, k)


def test_bsdf_eval_pdf_and_null_transmission_match(np_rng, emitters_scene):
    """Diffuse (twosided), dielectric, null and the default diffuse of the
    emitter shapes: lanes of every BSDF, wi and wo on both sides."""
    js, ts = emitters_scene
    jsi, tsi = _si_pair(np_rng, N)
    idx = np_rng.integers(0, int(ts.bsdfs.btype.shape[0]), N)
    wo = np_rng.normal(size=(N, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    tv, tp = tbsdf.bsdf_eval_pdf(ts, tsi, torch.from_numpy(idx),
                                 torch.from_numpy(wo))
    jv, jp = jbsdf.bsdf_eval_pdf(js, jsi, jnp.asarray(idx, jnp.int32),
                                 jnp.asarray(wo))
    _close(tv, jv, "val")
    _close(tp, jp, "pdf")
    assert (tp > 0).any() and (tp == 0).any()
    tn = tbsdf.eval_null_transmission(ts, tsi, torch.from_numpy(idx))
    jn = jbsdf.eval_null_transmission(js, jsi, jnp.asarray(idx, jnp.int32))
    _close(tn, jn, "null transmission")
    assert (tn == 1).any() and (tn == 0).any()
    # diffuse lanes now sample as well
    u1 = np_rng.uniform(size=N).astype(np.float32)
    u2 = np_rng.uniform(size=(N, 2)).astype(np.float32)
    tb = tbsdf.bsdf_sample(ts, tsi, torch.from_numpy(idx),
                           torch.from_numpy(u1), torch.from_numpy(u2))
    jb = jbsdf.bsdf_sample(js, jsi, jnp.asarray(idx, jnp.int32),
                           jnp.asarray(u1), jnp.asarray(u2))
    for k in ("wo", "pdf", "eta", "sampled_type", "weight"):
        _close(getattr(tb, k), getattr(jb, k), k)


def test_sample_emitter_direction_matches(np_rng, emitters_scene):
    """Area mesh, area sphere (uniform texture), point and constant
    emitters picked from one distribution."""
    js, ts = emitters_scene
    assert set(ts.emitters.types_present) == {0, 1, 2}
    assert ts.emitters.count == 4
    ref = np_rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    u2 = np_rng.uniform(size=(N, 2)).astype(np.float32)
    u1 = np_rng.uniform(size=N).astype(np.float32)
    tds, tw = tem.sample_emitter_direction(
        ts, torch.from_numpy(ref), torch.from_numpy(u2), torch.from_numpy(u1))
    jds, jw = jem.sample_emitter_direction(
        js, jnp.asarray(ref), jnp.asarray(u2), jnp.asarray(u1))
    for k in ("p", "n", "d", "dist", "pdf", "delta", "emitter"):
        _close(getattr(tds, k), getattr(jds, k), k)
    _close(tw, jw, "weight")
    # every emitter was picked; some area samples face away (weight 0)
    assert set(tds.emitter.tolist()) == {0, 1, 2, 3}
    assert (tw == 0).all(-1).any() and (tw > 0).all(-1).any()


def test_pdf_emitter_direction_matches(np_rng, emitters_scene):
    js, ts = emitters_scene
    ref = np_rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    sp = np_rng.uniform(-1, 1, (N, 3)).astype(np.float32) + [0, 0, 2]
    sn = np_rng.normal(size=(N, 3)).astype(np.float32)
    sn /= np.linalg.norm(sn, axis=-1, keepdims=True)
    d = (sp - ref) / np.linalg.norm(sp - ref, axis=-1, keepdims=True)
    eidx = np_rng.integers(-1, 4, N)
    args = [ref, eidx, sp, sn, d.astype(np.float32)]
    tp = tem.pdf_emitter_direction(ts, *map(torch.from_numpy, args))
    jp = jem.pdf_emitter_direction(
        js, *[jnp.asarray(a, jnp.int32) if a.dtype.kind == "i"
              else jnp.asarray(a) for a in args])
    _close(tp, jp, "pdf")
    # NEE's density of the point light (a delta) is never asked for: zero
    point = ts.emitters.etype[torch.clamp(torch.from_numpy(eidx), min=0)] \
        == 1
    assert (tp[~point] > 0).all() and (tp[point] == 0).all()


def test_eval_emitter_hit_matches(np_rng, emitters_scene):
    js, ts = emitters_scene
    shape = np_rng.integers(0, ts.n_shapes, N)
    valid = np_rng.uniform(size=N) < 0.9
    jsi, tsi = _si_pair(np_rng, N, shape=shape, valid=valid)
    d = np_rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tv, ti = tem.eval_emitter_hit(ts, tsi, torch.from_numpy(d))
    jv, ji = jem.eval_emitter_hit(js, jsi, jnp.asarray(d))
    _close(tv, jv, "radiance")
    _close(ti, ji, "emitter")
    assert (tv > 0).all(-1).any() and (ti >= 0).any() and (ti < 0).any()


def _dicts(kind):
    """(JAX dict, port dict) of the fog Cornell box or the fog-cube plane
    scene; the fog Cornell box takes each package's own cornell_box()."""
    if kind == "fog_cornell":
        return (tcornell.fog_cornell_box(8, max_depth=6,
                                         cornell=lr.cornell_box),
                tcornell.fog_cornell_box(8, max_depth=6))
    d = tcornell.plane_light_dict(8, fog_cube=True)
    return d, d


def _attenuated_inputs(np_rng, n, lo, hi, medium_of):
    ref = np_rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    medium = medium_of(ref)
    ch = np_rng.integers(0, 3, n)
    td = np.zeros(n, np.float32)
    active = np_rng.uniform(size=n) < 0.9
    return ref, medium, ch, td, active


@pytest.mark.parametrize("scene_kind,bounded", [
    ("fog_cornell", False), ("fog_cornell", True),
    ("fog_cube", False), ("fog_cube", True)])
def test_sample_emitter_attenuated_matches(np_rng, scene_kind, bounded):
    """The Beer-Lambert branch (fog Cornell box: homogeneous sensor
    medium, diffuse surfaces) and the ratio-tracked walk (fog cube: a
    null-BSDF cube holding a homogeneous medium), each bounded and
    unbounded, from the same sampler state: directions, weights and the
    output sampler dimension agree."""
    n = 1024
    if scene_kind == "fog_cornell":
        inputs = _attenuated_inputs(np_rng, n, -0.95, 0.95,
                                    lambda p: np.zeros(len(p), np.int64))
    else:
        inputs = _attenuated_inputs(
            np_rng, n, -1.2, 1.2,
            lambda p: np.where((np.abs(p) < 0.9).all(-1), 0, -1))
    jd, td = _dicts(scene_kind)
    js, ts = lr.load_dict(jd), lrt.load_dict(td, device="cpu")
    assert tvp._nee_is_analytic(ts) == (scene_kind == "fog_cornell") \
        == jvp._nee_is_analytic(js)
    ref, medium, ch, td, active = inputs
    jsam = jrng.make_sampler(jnp.arange(n), 2, 5)
    tsam = trng.make_sampler(torch.arange(n), 2, 5)
    tds, tw, tsam2 = tvp.sample_emitter_attenuated(
        ts, torch.from_numpy(ref), torch.from_numpy(medium),
        torch.from_numpy(ch), torch.from_numpy(td), tsam,
        torch.from_numpy(active), 6, bounded)
    jds, jw, jsam2 = jvp.sample_emitter_attenuated(
        js, jnp.asarray(ref), jnp.asarray(medium, jnp.int32),
        jnp.asarray(ch, jnp.int32), jnp.asarray(td), jsam,
        jnp.asarray(active), 6, bounded)
    for k in ("d", "dist", "pdf"):
        _close(getattr(tds, k), getattr(jds, k), k)
    _close(tw, jw, "attenuated weight", atol=1e-5)
    _close(tsam2.dim, np.asarray(jsam2.dim).astype(np.int64), "dim")
    extra = 3 if scene_kind == "fog_cornell" else 3 + tvp.WALK_DIMS
    assert (tsam2.dim == tsam.dim + extra).all()
    # attenuated but not all blocked
    w = tw.numpy()
    assert (w > 0).all(-1).sum() > n // 8 and (w == 0).all(-1).any()


@pytest.mark.parametrize("kind", ["fog_cornell", "fog_cube"])
def test_nee_scene_buffers_equal_bit_for_bit(monkeypatch, kind):
    """Every buffer of the scene, NEE's new tables included (emitter shape,
    texture and selection distribution; the shape table's emitter, type,
    primitive range and area; the triangle-area CDF), built by both
    builders, equal bit for bit; and the statics.  The fog Cornell box is
    each package's own cornell_box() under volpath in the fog."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    jd, td = _dicts(kind)
    pa, ps = numpy_tree(lrt.load_dict(td, device="cpu"))
    ja, jst = numpy_tree(lr.load_dict(jd))
    for k, v in pa.items():
        assert v.shape == ja[k].shape, k
        np.testing.assert_array_equal(v, ja[k].astype(v.dtype), err_msg=k)
    for k, v in ps.items():
        assert v == jst[k], (k, v, jst[k])
    for k in ("emitters.distr.cdf", "emitters.distr.total", "emitters.shape",
              "emitters.tex0", "shape_emitter", "shape_type",
              "shape_prim_offset", "shape_prim_count", "shape_area",
              "tri_area_cdf"):
        assert k in pa
    assert ps["needs_surface_nee"] \
        and ps["needs_medium_nee"] == (kind == "fog_cube")


def test_unported_gradient_keys_name_their_item(monkeypatch):
    """The vertex key is carried now: its gradient has the vertices'
    shape and is finite; the texture rows are a key (a brighter albedo
    brightens the image).
    The bitmap stack and the media grids are keys: on a scene whose taps
    read quads the bitmaps' gradient is zero, as in the JAX package, and
    on a scene without a grid medium so is the grids'.  The boundary terms
    of the vertices' gradient take 4,096 samples (not their 65,536), as
    in tests/test_torch_grad_keys.py: only its shape and finiteness are
    held here."""
    few_boundary_samples(monkeypatch)
    ts = lrt.load_dict(tcornell.plane_light_dict(4), device="cpu")
    _, g, _ = lrt.render_grad(ts, {"vertices": ts.vertices},
                              lambda im: im.mean(), spp=1)
    assert g["vertices"].shape == ts.vertices.shape
    assert torch.isfinite(g["vertices"]).all()
    _, g, _ = lrt.render_grad(ts, {"media.grids": ts.media.grids},
                              lambda im: im.mean(), spp=1)
    assert g["media.grids"].shape == ts.media.grids.shape
    assert not g["media.grids"].any()
    _, g, _ = lrt.render_grad(ts, {"textures.data": ts.textures.data},
                              lambda im: im.mean(), spp=1)
    assert torch.isfinite(g["textures.data"]).all() \
        and g["textures.data"][:, 0:3].sum() > 0
    _, g, _ = lrt.render_grad(ts, {"textures.bitmaps": ts.textures.bitmaps},
                              lambda im: im.mean(), spp=1)
    assert g["textures.bitmaps"].shape == ts.textures.bitmaps.shape
    assert not g["textures.bitmaps"].any()
