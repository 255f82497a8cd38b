"""Textures, bump and normal maps and the envmap: the port's components
against the JAX package on identical inputs (made with numpy from a seed;
scenes built by both builders from one dict, or built by the JAX builder
and bridged).

Tolerance: fp32, rtol 1e-5 with atol 1e-6 unless stated.  Discrete
outcomes (texel and distribution indices, masks) must be equal.  Scene
buffers built by both builders are compared bit for bit, but for the
envmap's 2-D CDF: the port's builder sums it sequentially in numpy, the
JAX package with XLA's cumsum, whose order differs (the test states the
largest difference in ulps).  Where the CDF matters, the port runs on the
JAX-built tables through the bridge.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
import liverrenderer_tpu._native as jnative
from liverrenderer_tpu.core import distr as jdistr
from liverrenderer_tpu.core import math as jm
from liverrenderer_tpu.core.types import SurfaceInteraction as JSI
from liverrenderer_tpu.emitter import dispatch as jem
from liverrenderer_tpu.integrators import shading as jshading
from liverrenderer_tpu.texture import eval as jtex
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.bridge import numpy_tree, scene_from_numpy
from liverrenderer_tpu_torch.core import distr as tdistr
from liverrenderer_tpu_torch.core import math as tm
from liverrenderer_tpu_torch.core.types import SurfaceInteraction as TSI
from liverrenderer_tpu_torch.emitter import dispatch as tem
from liverrenderer_tpu_torch.integrators import shading as tshading
from liverrenderer_tpu_torch.scene.liver_proxy import (height_map,
                                                       liver_medium,
                                                       liver_proxy_dict,
                                                       sky_map)
from liverrenderer_tpu_torch.scene.transform import Transform
from liverrenderer_tpu_torch.texture import eval as ttex
from torch_threads import torch_threads_per_worker  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
N = 4096
# the envmap CDF's largest difference between the two builders' sums, in
# float32 ulps, on the tests' 32 x 16 skies (measured: 7 in the rows' CDF,
# 6 in the marginal, 1 in the total; it grows with the map: 16 and 16 at
# 64 x 32, 365 and 254 at the full 1,024 x 512 sky, ~2e-5 relative)
CDF_MAX_ULPS = 16
CDF_KEYS = ("emitters.env_distr.cond_cdf", "emitters.env_distr.marg_cdf",
            "emitters.env_distr.total")


def _close(t, j, name="", rtol=RTOL, atol=ATOL):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    if np.issubdtype(j.dtype, np.floating):
        np.testing.assert_allclose(t, j, rtol=rtol, atol=atol, err_msg=name)
    else:
        np.testing.assert_array_equal(t, j.astype(t.dtype), err_msg=name)


def _rgb(v):
    return {"type": "rgb", "value": v}


def _normal_map(res, seed):
    """(res, res, 3) tangent-space normals encoded in [0, 1]."""
    rng = np.random.default_rng(seed)
    n = np.concatenate([rng.normal(0, 0.4, (res, res, 2)),
                        np.ones((res, res, 1))], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return (0.5 * n + 0.5).astype(np.float32)


def texture_dict():
    """Constant, checkerboard (named, with a to_uv) and bitmap textures of
    two sizes, a height map and a normal map through the bumpmap and
    normalmap wrappers (one through a ref), and an envmap with a rotation
    and a scale beside a point light."""
    rng = np.random.default_rng(7)
    to_uv = Transform().translate([0.25, -0.5, 0]).scale([3.0, 2.0, 1.0])
    shift = lambda x: Transform().translate([x, 0, 0]).matrix.copy()  # noqa
    return {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": 4},
        "sensor": {"type": "perspective",
                   "film": {"type": "hdrfilm", "width": 4, "height": 4,
                            "rfilter": {"type": "box"}}},
        "tiles": {"type": "checkerboard", "color0": _rgb([0.9, 0.8, 0.1]),
                  "color1": _rgb([0.1, 0.2, 0.7]),
                  "to_uv": to_uv.matrix.copy()},
        "bumped": {"type": "bumpmap", "scale": 0.3,
                   "texture": {"type": "bitmap", "data": height_map(32, 3)},
                   "bsdf": {"type": "diffuse"}},
        "a": {"type": "rectangle",
              "bsdf": {"type": "diffuse", "reflectance": {
                  "type": "bitmap", "to_uv": to_uv.matrix.copy(),
                  "data": rng.uniform(size=(24, 40, 3)).astype(np.float32)}}},
        "b": {"type": "rectangle", "to_world": shift(2.0),
              "bsdf": {"type": "diffuse",
                       "reflectance": {"type": "ref", "id": "tiles"}}},
        "c": {"type": "rectangle", "to_world": shift(4.0),
              "bsdf": {"type": "ref", "id": "bumped"}},
        "d": {"type": "rectangle", "to_world": shift(6.0),
              "bsdf": {"type": "normalmap",
                       "normalmap": {"type": "bitmap",
                                     "data": _normal_map(16, 4)},
                       "bsdf": {"type": "diffuse",
                                "reflectance": _rgb([0.5, 0.6, 0.7])}}},
        "pt": {"type": "point", "position": [0.5, 0.5, 1.5],
               "intensity": _rgb([6.0, 5.0, 4.0])},
        "sky": {"type": "envmap", "data": sky_map(32, 16), "scale": 1.5,
                "to_world": Transform().rotate([0.3, 1.0, 0.2], 40.0)
                .matrix.copy()},
    }


@pytest.fixture(scope="module")
def tex_scenes():
    """(JAX scene, port scene on the JAX-built tables)."""
    js = lr.load_dict(texture_dict())
    return js, scene_from_numpy(*numpy_tree(js), "cpu")


def _four_tap(js, ts):
    return (js.replace(textures=js.textures.replace(has_quads=False)),
            ts.replace(textures=ts.textures.replace(has_quads=False)))


def _tex_inputs(np_rng, ts):
    """Texture ids (-1 included) and uvs spanning several wraps, with
    lanes on texel centres and edges."""
    idx = np_rng.integers(-1, int(ts.textures.ttype.shape[0]), N)
    uv = np_rng.uniform(-2.0, 3.0, (N, 2)).astype(np.float32)
    uv[:64] = np.round(uv[:64] * 32) / 32
    return idx, uv


@pytest.mark.parametrize("quads", [True, False], ids=["quads", "four_tap"])
def test_eval_texture_matches(np_rng, tex_scenes, quads):
    js, ts = tex_scenes if quads else _four_tap(*tex_scenes)
    assert ts.textures.has_quads == quads
    assert set(ts.textures.types_present) == {0, 1, 2}
    idx, uv = _tex_inputs(np_rng, ts)
    tv = ttex.eval_texture(ts.textures, torch.from_numpy(idx),
                           torch.from_numpy(uv))
    jv = jtex.eval_texture(js.textures, jnp.asarray(idx, jnp.int32),
                           jnp.asarray(uv))
    _close(tv, jv, "eval_texture")
    _close(ttex.eval_texture_mono(ts.textures, torch.from_numpy(idx),
                                  torch.from_numpy(uv)),
           jtex.eval_texture_mono(js.textures, jnp.asarray(idx, jnp.int32),
                                  jnp.asarray(uv)), "mono")
    # a slot narrowed to constants skips the other families, as in JAX
    _close(ttex.eval_texture(ts.textures, torch.from_numpy(idx),
                             torch.from_numpy(uv), types=(0,)),
           jtex.eval_texture(js.textures, jnp.asarray(idx, jnp.int32),
                             jnp.asarray(uv), types=(0,)), "narrowed")
    ttype = ts.textures.ttype.numpy()[np.maximum(idx, 0)]
    for t in (0, 1, 2):
        assert ((ttype == t) & (idx >= 0)).any()


@pytest.mark.parametrize("quads", [True, False], ids=["quads", "four_tap"])
def test_eval_texture_grad_mono_matches(np_rng, tex_scenes, quads):
    js, ts = tex_scenes if quads else _four_tap(*tex_scenes)
    idx, uv = _tex_inputs(np_rng, ts)
    for a, b, k in zip(
            ttex.eval_texture_grad_mono(ts.textures, torch.from_numpy(idx),
                                        torch.from_numpy(uv)),
            jtex.eval_texture_grad_mono(js.textures,
                                        jnp.asarray(idx, jnp.int32),
                                        jnp.asarray(uv)),
            ("h", "dh/du", "dh/dv")):
        # dh/du scales a texel difference by the texel count and to_uv
        _close(a, b, k, atol=1e-4 if k != "h" else ATOL)
        assert np.abs(a.numpy()).max() > 0


def _si_pair(np_rng, n, n_shapes):
    ng = np_rng.normal(size=(n, 3)).astype(np.float32)
    ng /= np.linalg.norm(ng, axis=-1, keepdims=True)
    wi = np_rng.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    p = np_rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    uv = np_rng.uniform(-1, 2, (n, 2)).astype(np.float32)
    shape = np_rng.integers(0, n_shapes, n)
    t = np.where(np_rng.uniform(size=n) < 0.9, 1.0, np.inf).astype(np.float32)
    js = JSI(t=jnp.asarray(t), p=jnp.asarray(p), ng=jnp.asarray(ng),
             sh_frame=jm.make_frame(jnp.asarray(ng)), uv=jnp.asarray(uv),
             wi=jnp.asarray(wi), prim=jnp.zeros(n, jnp.int32),
             shape=jnp.asarray(shape, jnp.int32))
    ts = TSI(t=torch.from_numpy(t), p=torch.from_numpy(p),
             ng=torch.from_numpy(ng),
             sh_frame=tm.make_frame(torch.from_numpy(ng)),
             uv=torch.from_numpy(uv), wi=torch.from_numpy(wi),
             prim=torch.zeros(n, dtype=torch.int64),
             shape=torch.from_numpy(shape))
    return js, ts


@pytest.mark.parametrize("quads", [True, False], ids=["quads", "four_tap"])
def test_shading_frame_with_bump_matches(np_rng, tex_scenes, quads):
    """The height-map (shape c) and normal-map (shape d) frames, and lanes
    of unperturbed and invalid interactions: frame and wi in the new
    frame (a lane whose bumped wi changes hemisphere keeps the value JAX
    selects)."""
    js, ts = tex_scenes if quads else _four_tap(*tex_scenes)
    assert ts.has_bump and ts.has_heightmap and ts.has_normalmap
    jsi, tsi = _si_pair(np_rng, N, ts.n_shapes)
    d = np_rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tout = tshading.shading_frame_with_bump(
        ts, tsi, types.SimpleNamespace(d=torch.from_numpy(d)))
    jout = jshading.shading_frame_with_bump(
        js, jsi, types.SimpleNamespace(d=jnp.asarray(d)))
    for k in ("s", "t", "n"):
        _close(getattr(tout.sh_frame, k), getattr(jout.sh_frame, k), k,
               atol=1e-5)
    _close(tout.wi, jout.wi, "wi", atol=1e-5)
    moved = (tout.sh_frame.n != tsi.sh_frame.n).any(-1).numpy()
    shape = tsi.shape.numpy()
    bump = np.asarray(ts.shape_bump_scale)[shape]
    assert moved[bump > 0].any() and moved[bump < 0].any()
    assert not moved[(bump == 0) | ~np.isfinite(tsi.t.numpy())].any()
    flipped = np.sign(tout.wi[:, 2].numpy()) != np.sign(tsi.wi[:, 2].numpy())
    assert flipped[moved].any()


def _env_dirs(np_rng):
    d = np_rng.normal(size=(N, 3)).astype(np.float32)
    d[:4] = [[0, 1, 0], [0, -1, 0], [0, 0, -1], [1e-7, 0.3, 1]]  # poles, seam
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_env_uv_radiance_pdf_match(np_rng, tex_scenes):
    js, ts = tex_scenes
    env = ts.emitters.env_index
    assert env >= 0 and int(ts.emitters.etype[env]) == 3
    d = _env_dirs(np_rng)
    te = torch.full((N,), env, dtype=torch.int64)
    je = jnp.full((N,), env, jnp.int32)
    (tuv, tth), (juv, jth) = (tem._env_uv(ts, te, torch.from_numpy(d)),
                              jem._env_uv(js, je, jnp.asarray(d)))
    _close(tuv, juv, "uv")
    _close(tth, jth, "theta")
    tr = tem._env_radiance(ts, te, torch.from_numpy(d))
    _close(tr, jem._env_radiance(js, je, jnp.asarray(d)), "radiance")
    # the pdf divides by sin(theta), which magnifies an ulp of theta
    _close(tem._env_pdf(ts, te, torch.from_numpy(d)),
           jem._env_pdf(js, je, jnp.asarray(d)), "pdf", rtol=1e-4)
    _close(tem.eval_environment(ts, torch.from_numpy(d)),
           jem.eval_environment(js, jnp.asarray(d)), "eval_environment")
    assert tr.numpy().max() > 5 * tr.numpy().min()   # the sun lobe is seen


def test_envmap_emitter_sampling_matches(np_rng, tex_scenes):
    """NEE on the envmap (2-D importance sampling) and the point light;
    the pdf of the envmap's directions."""
    js, ts = tex_scenes
    ref = np_rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    u2 = np_rng.uniform(size=(N, 2)).astype(np.float32)
    u1 = np_rng.uniform(size=N).astype(np.float32)
    tds, tw = tem.sample_emitter_direction(
        ts, torch.from_numpy(ref), torch.from_numpy(u2), torch.from_numpy(u1))
    jds, jw = jem.sample_emitter_direction(
        js, jnp.asarray(ref), jnp.asarray(u2), jnp.asarray(u1))
    for k in ("d", "dist", "delta", "emitter"):
        _close(getattr(tds, k), getattr(jds, k), k, atol=1e-5)
    # an envmap's point lies WORLD_RADIUS = 1e4 along d
    _close(tds.p, jds.p, "p", atol=1e-3)
    # the pdf divides by sin(theta), an ulp of theta apart near the poles
    _close(tds.pdf, jds.pdf, "pdf", rtol=1e-4)
    _close(tw, jw, "weight", rtol=1e-4, atol=1e-5)
    env = tds.emitter.numpy() == ts.emitters.env_index
    assert env.any() and (~env).any()
    eidx = np.where(env, ts.emitters.env_index, 1)
    tp = tem.pdf_emitter_direction(ts, torch.from_numpy(ref),
                                   torch.from_numpy(eidx), tds.p, tds.n,
                                   tds.d)
    jp = jem.pdf_emitter_direction(js, jnp.asarray(ref),
                                   jnp.asarray(eidx, jnp.int32), jds.p,
                                   jds.n, jds.d)
    # piecewise constant over the texels: a sampled direction on a cell's
    # edge (an ulp of d apart) may read the neighbour cell
    tp_, jp_ = tp.numpy(), np.asarray(jp)
    same = np.abs(tp_ - jp_) <= 1e-4 * np.abs(jp_)
    assert same.mean() >= 0.995, same.mean()
    # the sampled direction's own density (cells of one texel)
    ratio = tp.numpy()[env] / tds.pdf.numpy()[env]
    assert np.median(np.abs(ratio - 1.0)) < 1e-3


def test_distribution2d_matches(np_rng):
    """Sampling index for index on the JAX-built tables (zero cells
    included, u on the edges), eval_pdf, and `build` within fp32."""
    w = np_rng.uniform(0, 2, (24, 40)).astype(np.float32)
    w[3, :] = 0.0
    w[:, 7] = 0.0
    w[10, 20:25] = 0.0
    jd = jdistr.Distribution2D.build(w)
    td = tdistr.Distribution2D(
        *(torch.from_numpy(np.array(np.asarray(a))) for a in
          (jd.cond_cdf, jd.marg_cdf, jd.data, jd.total)))
    u2 = np_rng.uniform(size=(N, 2)).astype(np.float32)
    u2[:6] = [[0, 0], [0.99999994, 0.99999994], [0.5, 0], [0, 0.5],
              [0.99999994, 0.3], [0.3, 0.99999994]]
    tpos, tpdf = td.sample(torch.from_numpy(u2))
    jpos, jpdf = jd.sample(jnp.asarray(u2))
    _close(torch.floor(tpos), np.floor(np.asarray(jpos)), "cell", atol=0)
    _close(tpos, jpos, "pos")
    _close(tpdf, jpdf, "pdf")
    assert (tpdf > 0).all()       # no zero cell is picked
    col = np_rng.integers(0, 40, N)
    row = np_rng.integers(0, 24, N)
    _close(td.eval_pdf(torch.from_numpy(col), torch.from_numpy(row)),
           jd.eval_pdf(jnp.asarray(col), jnp.asarray(row)), "eval_pdf")
    tb = tdistr.Distribution2D.build(torch.from_numpy(w))
    for k in ("cond_cdf", "marg_cdf", "data", "total"):
        _close(getattr(tb, k), getattr(jd, k), k)


def _ulps(a, b):
    return int(np.abs(np.asarray(a, np.float32).view(np.int32).astype(
        np.int64) - np.asarray(b, np.float32).view(np.int32)).max())


def _bio_media_dict():
    """Spheres holding the glisson capsule, parenchyma and liver media."""
    d = liver_proxy_dict(4, 4, 1, 0)
    del d["liver"]
    med = {k: v for k, v in liver_medium().items() if k != "type"}
    for i, t in enumerate(("glissonCapsule", "glisson", "parenchyma")):
        d[f"s{i}"] = {"type": "sphere", "center": [2.0 * i, 0, 0],
                      "radius": 0.5, "bsdf": {"type": "dielectric"},
                      "interior": {"type": t, **med}}
    d["liver_s"] = {"type": "sphere", "center": [-2.0, 0, 0], "radius": 0.5,
                    "interior": {"type": "ref", "id": "liver_med"}}
    return d


@pytest.mark.parametrize("kind", ["textures", "bump_sky_proxy", "bio_media"])
def test_scene_buffers_equal_bit_for_bit(monkeypatch, kind):
    """Every buffer and static of the scene built by both builders: the
    texture table, the padded bitmap stack, its sizes and quads, the
    per-shape bump table and flags, the emitters' to_world, the media rows
    of every bio medium; the envmap CDF within CDF_MAX_ULPS."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    d = {"textures": texture_dict,
         "bump_sky_proxy": lambda: liver_proxy_dict(16, 12, 4, 2, 0,
                                                    bump=(32, 0.05),
                                                    sky=(32, 16)),
         "bio_media": _bio_media_dict}[kind]()
    pa, ps = numpy_tree(lrt.load_dict(d, device="cpu"))
    ja, jst = numpy_tree(lr.load_dict(d))
    for k, v in pa.items():
        assert v.shape == ja[k].shape, k
        if k in CDF_KEYS:
            assert _ulps(v, ja[k]) <= CDF_MAX_ULPS, (k, _ulps(v, ja[k]))
        else:
            np.testing.assert_array_equal(v, ja[k].astype(v.dtype),
                                          err_msg=k)
    for k, v in ps.items():
        assert v == jst[k], (k, v, jst[k])
    if kind == "bio_media":
        assert ps["media.types_present"] == (2, 3, 4)
        return
    for k in ("textures.bitmaps", "textures.quads", "textures.bitmap_hw",
              "textures.bitmap_id", "shape_bump_tex", "shape_bump_scale",
              "emitters.to_world") + CDF_KEYS:
        assert k in pa
    assert ps["has_bump"] and ps["has_heightmap"] and ps["textures.has_quads"]
    assert ps["has_normalmap"] == (kind == "textures")
    assert ps["emitters.env_index"] >= 0
