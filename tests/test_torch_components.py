"""The port's shading components against the JAX package on identical
inputs (made with numpy from a seed, scenes bridged from the JAX builder).

Tolerance: fp32 (rtol 1e-5, atol 1e-6).  Both packages run the same
formulas in float32; XLA and PyTorch may differ by an ulp in a
transcendental (log, exp, sin, cos) or in a fused expression, never more.
Discrete outcomes (types, masks, lobe choices) must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu import film as jfilm
from liverrenderer_tpu.bsdf import dispatch as jbsdf
from liverrenderer_tpu.core import math as jm
from liverrenderer_tpu.core import rng as jrng
from liverrenderer_tpu.core.types import SurfaceInteraction as JSI
from liverrenderer_tpu.media import dispatch as jmed
from liverrenderer_tpu.phase import dispatch as jphase
from liverrenderer_tpu.sensor import perspective as jsensor
from liverrenderer_tpu_torch import film as tfilm
from liverrenderer_tpu_torch.bridge import numpy_tree, scene_from_numpy
from liverrenderer_tpu_torch.bsdf import dispatch as tbsdf
from liverrenderer_tpu_torch.core import math as tm
from liverrenderer_tpu_torch.core import rng as trng
from liverrenderer_tpu_torch.core.types import SurfaceInteraction as TSI
from liverrenderer_tpu_torch.media import dispatch as tmed
from liverrenderer_tpu_torch.phase import dispatch as tphase
from liverrenderer_tpu_torch.scene.liver_proxy import (liver_medium,
                                                       liver_proxy_dict)
from liverrenderer_tpu_torch.sensor import perspective as tsensor
from torch_threads import torch_threads_per_worker  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def _close(t, j, name="", rtol=RTOL, atol=ATOL):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    if np.issubdtype(j.dtype, np.floating):
        np.testing.assert_allclose(t, j, rtol=rtol, atol=atol, err_msg=name)
    else:
        np.testing.assert_array_equal(t, j.astype(t.dtype), err_msg=name)


def _pair(d):
    js = lr.load_dict(d)
    return js, scene_from_numpy(*numpy_tree(js), "cpu")


def _media_scene(integrator):
    return _pair({
        "type": "scene",
        "integrator": {"type": integrator, "max_depth": 12},
        "sensor": {"type": "perspective",
                   "film": {"type": "hdrfilm", "width": 4, "height": 4,
                            "rfilter": {"type": "box"}}},
        "liver": liver_medium(),
        "fog": {"type": "homogeneous",
                "sigma_t": {"type": "rgb", "value": [0.5, 1.0, 2.0]},
                "albedo": 0.8, "phase": {"type": "hg", "g": 0.6}},
        "obj": {"type": "rectangle", "bsdf": {"type": "dielectric"},
                "interior": {"type": "ref", "id": "liver"},
                "exterior": {"type": "ref", "id": "fog"}},
    })


def _samplers(n, seed=7):
    return (jrng.make_sampler(jnp.arange(n), 3, seed),
            trng.make_sampler(torch.arange(n), 3, seed))


@pytest.mark.parametrize("integrator", ["biovolpath", "volpath"])
def test_medium_sampling_matches(np_rng, integrator):
    js, ts = _media_scene(integrator)
    n = 4096
    midx = np_rng.integers(-1, 2, n)
    o = np_rng.normal(size=(n, 3)).astype(np.float32)
    d = np_rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ch = np_rng.integers(0, 3, n)
    # tissue depths across the four glisson layers and the parenchyma
    td = np_rng.uniform(0.0, 0.02, n).astype(np.float32)
    active = midx >= 0
    maxt = np.where(np_rng.uniform(size=n) < 0.2, np.inf,
                    np_rng.uniform(0.0, 3.0, n)).astype(np.float32)
    jsam, tsam = _samplers(n)

    jc, jsam = jmed.sample_interaction_candidate(
        js, jnp.asarray(midx, jnp.int32), jnp.asarray(o), jnp.asarray(d),
        jsam, jnp.asarray(ch, jnp.int32), jnp.asarray(td),
        jnp.asarray(active))
    tc, tsam = tmed.sample_interaction_candidate(
        ts, torch.from_numpy(midx), torch.from_numpy(o), torch.from_numpy(d),
        tsam, torch.from_numpy(ch), torch.from_numpy(td),
        torch.from_numpy(active))
    for k in ("dist", "p", "sigma_t", "sigma_s", "sigma_n", "majorant",
              "bio_type", "is_bio"):
        _close(tc[k], jc[k], k)
    _close(tsam.dim, np.asarray(jsam.dim).astype(np.int64), "dim")
    assert tc["bio_present"] == jc["bio_present"] \
        == (integrator == "biovolpath")

    jmei = jmed.finalize_interaction(jc, jnp.asarray(maxt),
                                     jnp.asarray(ch, jnp.int32),
                                     jnp.asarray(active))
    tmei = tmed.finalize_interaction(tc, torch.from_numpy(maxt),
                                     torch.from_numpy(ch),
                                     torch.from_numpy(active))
    for k in ("t", "p", "transmittance", "combined_extinction"):
        _close(getattr(tmei, k), getattr(jmei, k), k)
    if integrator == "biovolpath":     # absorbers and attenuators both fire
        tr = tmei.transmittance.numpy()
        assert (tr == 0).all(-1).any() and (tr.sum(-1) == 1).any()
    jtr, jpdf = jmed.transmittance_eval_pdf(
        js, jnp.asarray(midx, jnp.int32), jmei, jnp.asarray(maxt))
    ttr, tpdf = tmed.transmittance_eval_pdf(
        ts, torch.from_numpy(midx), tmei, torch.from_numpy(maxt))
    _close(ttr, jtr, "tr")
    _close(tpdf, jpdf, "pdf")
    jp = jmed.medium_phase(js, jnp.asarray(midx, jnp.int32))
    tp = tmed.medium_phase(ts, torch.from_numpy(midx))
    for a, b in zip(tp[:2], jp[:2]):
        _close(a, b)


def test_phase_sample_and_eval_match(np_rng):
    n = 4096
    ptype = np_rng.integers(0, 2, n)
    g = np_rng.uniform(-0.9, 0.9, n).astype(np.float32)
    g[:200] = np_rng.uniform(-5e-4, 5e-4, 200)       # the isotropic limit
    fwd = np_rng.normal(size=(n, 3)).astype(np.float32)
    fwd /= np.linalg.norm(fwd, axis=-1, keepdims=True)
    u2 = np_rng.uniform(size=(n, 2)).astype(np.float32)
    prm = np.zeros((n, 52), np.float32)
    jwo, jw, jpdf = jphase.phase_sample(
        jnp.asarray(ptype, jnp.int32), jnp.asarray(g), jnp.asarray(fwd),
        jnp.asarray(u2), jnp.asarray(prm), (0, 1))
    two, tw, tpdf = tphase.phase_sample(
        torch.from_numpy(ptype), torch.from_numpy(g), torch.from_numpy(fwd),
        torch.from_numpy(u2), torch.from_numpy(prm), (0, 1))
    _close(two, jwo, "wo")
    _close(tw, jw, "weight")
    # 1 + g^2 - 2 g cos cancels near the forward peak: at g = 0.9 one ulp
    # of the sampled cos moves the HG pdf by ~1e-5 relative
    _close(tpdf, jpdf, "pdf", rtol=1e-4)
    cos = (fwd * u2[:, :1]).sum(-1).clip(-1, 1).astype(np.float32)
    _close(tphase.phase_eval(torch.from_numpy(ptype), torch.from_numpy(g),
                             torch.from_numpy(cos)),
           jphase.phase_eval(jnp.asarray(ptype, jnp.int32), jnp.asarray(g),
                             jnp.asarray(cos)), "eval")


def test_dielectric_and_null_bsdf_sample_match(np_rng):
    js, ts = _pair({
        "type": "scene",
        "integrator": {"type": "biovolpath"},
        "sensor": {"type": "perspective",
                   "film": {"type": "hdrfilm", "width": 4, "height": 4,
                            "rfilter": {"type": "box"}}},
        "a": {"type": "rectangle",
              "bsdf": {"type": "dielectric", "int_ior": 1.38, "ext_ior": 1.0,
                       "specular_reflectance": {"type": "rgb",
                                                "value": [0.9, 0.8, 0.7]}}},
        "b": {"type": "rectangle", "bsdf": {"type": "null"}},
    })
    n = 4096
    wi = np_rng.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    wi[:16] = [0.0, 0.0, 1.0]                         # normal incidence
    idx = np_rng.integers(0, 2, n)
    u1 = np_rng.uniform(size=n).astype(np.float32)
    u2 = np_rng.uniform(size=(n, 2)).astype(np.float32)
    z = np.zeros((n, 3), np.float32)
    nz = np.tile(np.float32([0, 0, 1]), (n, 1))
    jsi = JSI(t=jnp.ones(n), p=jnp.asarray(z), ng=jnp.asarray(nz),
              sh_frame=jm.make_frame(jnp.asarray(nz)),
              uv=jnp.zeros((n, 2)), wi=jnp.asarray(wi),
              prim=jnp.zeros(n, jnp.int32), shape=jnp.zeros(n, jnp.int32))
    tsi = TSI(t=torch.ones(n), p=torch.from_numpy(z),
              ng=torch.from_numpy(nz),
              sh_frame=tm.make_frame(torch.from_numpy(nz)),
              uv=torch.zeros((n, 2)), wi=torch.from_numpy(wi),
              prim=torch.zeros(n, dtype=torch.int64),
              shape=torch.zeros(n, dtype=torch.int64))
    jb = jbsdf.bsdf_sample(js, jsi, jnp.asarray(idx, jnp.int32),
                           jnp.asarray(u1), jnp.asarray(u2))
    tb = tbsdf.bsdf_sample(ts, tsi, torch.from_numpy(idx),
                           torch.from_numpy(u1), torch.from_numpy(u2))
    for k in ("wo", "pdf", "eta", "sampled_type", "weight"):
        _close(getattr(tb, k), getattr(jb, k), k)


def test_sample_ray_matches(np_rng):
    js, ts = _pair(liver_proxy_dict(428, 240, 1, 1, 0))
    pos = (np_rng.uniform(size=(4096, 2)) * [428, 240]).astype(np.float32)
    jr = jsensor.sample_ray(js, jnp.asarray(pos))
    tr = tsensor.sample_ray(ts, torch.from_numpy(pos))
    _close(tr.o, jr.o, "o")
    _close(tr.d, jr.d, "d")
    _close(tr.maxt, jr.maxt, "maxt")


@pytest.mark.parametrize("rfilter", [0, 2], ids=["box", "tent"])
def test_splat_and_develop_match(np_rng, rfilter):
    w, h, n = 12, 9, 5000
    pos = (np_rng.uniform(size=(n, 2)) * [w, h]).astype(np.float32)
    val = np_rng.uniform(0, 2, (n, 3)).astype(np.float32)
    jacc = jfilm.splat(w, h, rfilter, jnp.asarray(pos), jnp.asarray(val))
    tacc = tfilm.splat(w, h, rfilter, torch.from_numpy(pos),
                       torch.from_numpy(val))
    # sums of ~50 samples per pixel in another order: fp32 rounding
    _close(tacc, jacc, "acc", rtol=1e-5, atol=1e-4)
    _close(tfilm.develop(tacc), jfilm.develop(jacc), "img", atol=1e-5)
