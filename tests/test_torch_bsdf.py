"""The stock BSDFs of the port against the JAX package on identical inputs
(made with numpy from a seed): the GGX microfacet functions, the conductor
Fresnel term, every BSDF family's sample and eval through the dispatch
(twosided on both sides, blendbsdf and mask resolved one level deep), the
builder's BSDF buffers, and the gaussian film splat.

Tolerance: fp32, rtol 1e-5 with atol 1e-6 unless stated.  Both packages
run the same formulas in float32; XLA and PyTorch may differ by an ulp in
a transcendental or a fused expression, which a microfacet term can
magnify (1/cos near the horizon; a sampled half vector's normalize).
Discrete outcomes (sampled lobe types, masks) must be equal.  Buffers
built by both builders are compared bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu import film as jfilm
from liverrenderer_tpu.bsdf import dispatch as jbsdf
from liverrenderer_tpu.core import fresnel as jfr
from liverrenderer_tpu.core import math as jm
from liverrenderer_tpu.core import microfacet as jmf
from liverrenderer_tpu.core.types import SurfaceInteraction as JSI
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch import film as tfilm
from liverrenderer_tpu_torch.bridge import numpy_tree, scene_from_numpy
from liverrenderer_tpu_torch.bsdf import dispatch as tbsdf
from liverrenderer_tpu_torch.core import fresnel as tfr
from liverrenderer_tpu_torch.core import math as tm
from liverrenderer_tpu_torch.core import microfacet as tmf
from liverrenderer_tpu_torch.core.types import SurfaceInteraction as TSI
from liverrenderer_tpu_torch.scene import ir
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


def _unit(np_rng, n, zmin=None):
    v = np_rng.normal(size=(n, 3)).astype(np.float32)
    if zmin is not None:
        v[:, 2] = np.abs(v[:, 2]) + zmin
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _rgb(v):
    return {"type": "rgb", "value": v}


def _diffuse(v):
    return {"type": "diffuse", "reflectance": _rgb(v)}


# one rectangle per BSDF; the dispatch test picks rows by type
_BSDFS = {
    "thindielectric": {"type": "thindielectric", "int_ior": 1.4},
    "conductor": {"type": "conductor", "material": "Au"},
    "roughconductor": {"type": "roughconductor", "alpha_u": 0.15,
                       "alpha_v": 0.4, "material": "Cu"},
    "plastic": {"type": "plastic", "nonlinear": True,
                "diffuse_reflectance": _rgb([0.3, 0.5, 0.7])},
    "roughplastic": {"type": "roughplastic", "alpha": 0.25,
                     "diffuse_reflectance": _rgb([0.6, 0.2, 0.4])},
    "pplastic": {"type": "pplastic", "alpha": 0.35},
    "roughdielectric": {"type": "roughdielectric", "alpha": 0.3,
                        "int_ior": 1.33},
    "twosided": {"type": "twosided", "bsdf": _diffuse([0.2, 0.7, 0.4])},
    "blendbsdf": {"type": "blendbsdf", "weight": 0.3,
                  "a": _diffuse([0.8, 0.1, 0.1]),
                  "b": {"type": "roughconductor", "alpha": 0.2,
                        "material": "Al"}},
    "mask": {"type": "mask", "opacity": 0.6,
             "bsdf": {"type": "plastic"}},
}
# the row of each case: its type code (twosided: a twosided diffuse row)
_CODES = {
    "thindielectric": ir.BSDF_THINDIELECTRIC, "conductor": ir.BSDF_CONDUCTOR,
    "roughconductor": ir.BSDF_ROUGHCONDUCTOR, "plastic": ir.BSDF_PLASTIC,
    "roughplastic": ir.BSDF_ROUGHPLASTIC, "pplastic": ir.BSDF_PPLASTIC,
    "roughdielectric": ir.BSDF_ROUGHDIELECTRIC,
    "twosided": ir.BSDF_DIFFUSE, "blendbsdf": ir.BSDF_BLEND,
    "mask": ir.BSDF_MASK,
}


def _bsdf_dict():
    d = {"type": "scene",
         "integrator": {"type": "path", "max_depth": 4},
         "sensor": {"type": "perspective",
                    "film": {"type": "hdrfilm", "width": 4, "height": 4,
                             "rfilter": {"type": "box"}}}}
    for i, (k, b) in enumerate(_BSDFS.items()):
        d[k] = {"type": "rectangle", "bsdf": b,
                "to_world": lr.Transform().translate([0, 0, -i]).matrix}
    return d


@pytest.fixture(scope="module")
def bsdf_scene():
    """(JAX scene, the port's scene bridged from it)."""
    js = lr.load_dict(_bsdf_dict())
    return js, scene_from_numpy(*numpy_tree(js), "cpu")


def _si_pair(np_rng, n):
    """A SurfaceInteraction of random shading frames, incident directions
    on both sides and uvs, for both packages."""
    ng = _unit(np_rng, n)
    wi = _unit(np_rng, n)
    p = np_rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    uv = np_rng.uniform(size=(n, 2)).astype(np.float32)
    t = np.ones(n, np.float32)
    js = JSI(t=jnp.asarray(t), p=jnp.asarray(p), ng=jnp.asarray(ng),
             sh_frame=jm.make_frame(jnp.asarray(ng)), uv=jnp.asarray(uv),
             wi=jnp.asarray(wi), prim=jnp.zeros(n, jnp.int32),
             shape=jnp.zeros(n, jnp.int32))
    ts = TSI(t=torch.from_numpy(t), p=torch.from_numpy(p),
             ng=torch.from_numpy(ng),
             sh_frame=tm.make_frame(torch.from_numpy(ng)),
             uv=torch.from_numpy(uv), wi=torch.from_numpy(wi),
             prim=torch.zeros(n, dtype=torch.int64),
             shape=torch.zeros(n, dtype=torch.int64))
    return js, ts


def test_microfacet_matches(np_rng):
    wi = _unit(np_rng, N, zmin=0.02)
    h = _unit(np_rng, N)
    u = np_rng.uniform(size=(N, 2)).astype(np.float32)
    ax = np_rng.uniform(0.05, 0.8, N).astype(np.float32)
    ay = np_rng.uniform(0.05, 0.8, N).astype(np.float32)
    t = [torch.from_numpy(x) for x in (wi, h, u, ax, ay)]
    j = [jnp.asarray(x) for x in (wi, h, u, ax, ay)]
    _close(tmf.ggx_d(t[1], t[3], t[4]), jmf.ggx_d(j[1], j[3], j[4]), "D",
           rtol=3e-5)
    _close(tmf.ggx_smith_g1(t[0], t[1], t[3], t[4]),
           jmf.ggx_smith_g1(j[0], j[1], j[3], j[4]), "G1")
    th = tmf.ggx_sample_vndf(t[0], t[2], t[3], t[4])
    _close(th, jmf.ggx_sample_vndf(j[0], j[2], j[3], j[4]), "vndf",
           atol=1e-5)
    hh = jnp.asarray(th.numpy())
    _close(tmf.ggx_pdf_visible(t[0], th, t[3], t[4]),
           jmf.ggx_pdf_visible(j[0], hh, j[3], j[4]), "pdf", rtol=3e-5)
    # every sampled half vector lies in the upper hemisphere
    assert (th[:, 2] > 0).all()


def test_fresnel_conductor_matches(np_rng):
    ci = np_rng.uniform(-1, 1, N).astype(np.float32)
    ci[:3] = [0.0, 1.0, -1.0]
    eta = np_rng.uniform(0.1, 2.0, (N, 3)).astype(np.float32)
    k = np_rng.uniform(0.0, 6.0, (N, 3)).astype(np.float32)
    k[:8] = 0.0
    _close(tfr.fresnel_conductor(torch.from_numpy(ci), torch.from_numpy(eta),
                                 torch.from_numpy(k)),
           jfr.fresnel_conductor(jnp.asarray(ci), jnp.asarray(eta),
                                 jnp.asarray(k)), "rgb")
    _close(tfr.fresnel_conductor(torch.from_numpy(ci),
                                 torch.from_numpy(eta[:, 0]),
                                 torch.from_numpy(k[:, 0])),
           jfr.fresnel_conductor(jnp.asarray(ci), jnp.asarray(eta[:, 0]),
                                 jnp.asarray(k[:, 0])), "scalar")
    e = np.linspace(0.5, 2.5, 41).astype(np.float32)
    _close(tfr.fresnel_diffuse_reflectance(torch.from_numpy(e)),
           jfr.fresnel_diffuse_reflectance(jnp.asarray(e)), "fdr")


def test_safe_sqrt_derivative_clamped_at_zero():
    """The conductor's Fresnel term meets sqrt(0) on lanes of other
    families; the derivative there is 0, not inf (the JAX custom JVP)."""
    x = torch.tensor([0.0, 1e-13, 4.0], requires_grad=True)
    (g,) = torch.autograd.grad(tm.safe_sqrt(x).sum(), x)
    assert g.tolist() == [0.0, 0.0, 0.25]
    _, jv = torch.func.jvp(tm.safe_sqrt, (x.detach(),),
                           (torch.ones(3),))
    assert jv.tolist() == [0.0, 0.0, 0.25]


@pytest.mark.parametrize("case", list(_BSDFS) + ["mixed"])
def test_bsdf_sample_and_eval_match(np_rng, bsdf_scene, case):
    """Lanes of one BSDF row (or, for `mixed`, of every row), wi and wo on
    both sides of the surface, shared u1, u2 and wo."""
    js, ts = bsdf_scene
    btype = ts.bsdfs.btype.numpy()
    if case == "mixed":
        idx = np_rng.integers(0, len(btype), N)
    else:
        rows = np.flatnonzero(btype == _CODES[case])
        if case == "twosided":
            rows = rows[ts.bsdfs.twosided.numpy()[rows]]
        idx = np.full(N, rows[-1])
    jsi, tsi = _si_pair(np_rng, N)
    u1 = np_rng.uniform(size=N).astype(np.float32)
    u2 = np_rng.uniform(size=(N, 2)).astype(np.float32)
    wo = _unit(np_rng, N)
    ti, ji = torch.from_numpy(idx), jnp.asarray(idx, jnp.int32)
    tb = tbsdf.bsdf_sample(ts, tsi, ti, torch.from_numpy(u1),
                           torch.from_numpy(u2))
    jb = jbsdf.bsdf_sample(js, jsi, ji, jnp.asarray(u1), jnp.asarray(u2))
    _close(tb.sampled_type, jb.sampled_type, "sampled_type")
    # a visible-normal sample's p3 = sqrt(1 - p1^2 - p2^2) near the rim of
    # the projected disk turns an ulp of cos/sin into ~1e-5 of wo (seen:
    # 4e-5 on 16 of 4,096 rough-conductor lanes)
    _close(tb.wo, jb.wo, "wo", rtol=0, atol=1e-4)
    for k in ("pdf", "eta", "weight"):
        _close(getattr(tb, k), getattr(jb, k), k, atol=1e-5, rtol=1e-4)
    assert (tb.pdf > 0).any()
    tv, tp = tbsdf.bsdf_eval_pdf(ts, tsi, ti, torch.from_numpy(wo))
    jv, jp = jbsdf.bsdf_eval_pdf(js, jsi, ji, jnp.asarray(wo))
    _close(tv, jv, "val", rtol=1e-4)
    _close(tp, jp, "pdf", rtol=1e-4)
    # the sampled directions evaluate to the same pdf in both packages
    tv2, tp2 = tbsdf.bsdf_eval_pdf(ts, tsi, ti, tb.wo)
    jv2, jp2 = jbsdf.bsdf_eval_pdf(js, jsi, ji, jnp.asarray(tb.wo.numpy()))
    _close(tv2, jv2, "val(sampled)", rtol=1e-4, atol=1e-5)
    _close(tp2, jp2, "pdf(sampled)", rtol=1e-4, atol=1e-5)
    tn = tbsdf.eval_null_transmission(ts, tsi, ti)
    _close(tn, jbsdf.eval_null_transmission(js, jsi, ji), "null tr")
    if case == "mask":
        np.testing.assert_allclose(tn.numpy(), 0.4, rtol=1e-6)
    if case == "twosided":
        # both sides reflect: every lane with wo on wi's side has a value
        same = np.sign(tsi.wi[:, 2].numpy()) == np.sign(wo[:, 2])
        assert (tv.numpy()[same] > 0).all() and not tv.numpy()[~same].any()


def test_builder_bsdf_buffers_equal():
    """Both builders pack the BSDF and texture tables of the same dict
    bit for bit (the plastic's F_dr fits and sampling weight included)."""
    d = _bsdf_dict()
    pa, ps = numpy_tree(lrt.load_dict(d, device="cpu"))
    ja, jst = numpy_tree(lr.load_dict(d))
    keys = [k for k in pa if k.startswith(("bsdfs.", "textures.",
                                           "shape_bsdf"))]
    assert {"bsdfs.inner", "bsdfs.inner2", "bsdfs.params"} <= set(keys)
    for k in keys:
        assert pa[k].shape == ja[k].shape, k
        np.testing.assert_array_equal(pa[k], ja[k].astype(pa[k].dtype),
                                      err_msg=k)
    for k, v in ps.items():
        if k.startswith("bsdfs.") or k in ("rfilter", "integrator",
                                           "needs_surface_nee"):
            assert v == jst[k], (k, v, jst[k])
    # a film without a filter takes the gaussian, as in the JAX builder
    del d["sensor"]["film"]["rfilter"]
    assert lrt.load_dict(d, device="cpu").rfilter == ir.FILTER_GAUSSIAN \
        == lr.load_dict(d).rfilter


def test_gaussian_splat_matches(np_rng):
    """The 4x4 gaussian footprint (std 0.5, cut at 2 px), samples near the
    film's borders included."""
    w, h, n = 12, 9, 5000
    pos = (np_rng.uniform(size=(n, 2)) * [w, h]).astype(np.float32)
    val = np_rng.uniform(0, 2, (n, 3)).astype(np.float32)
    f = ir.FILTER_GAUSSIAN
    jacc = jfilm.splat(w, h, f, jnp.asarray(pos), jnp.asarray(val))
    tacc = tfilm.splat(w, h, f, torch.from_numpy(pos), torch.from_numpy(val))
    # sums of ~700 weighted samples per pixel in another order
    _close(tacc, jacc, "acc", rtol=1e-5, atol=1e-4)
    _close(tfilm.develop(tacc), jfilm.develop(jacc), "img", atol=1e-5)
