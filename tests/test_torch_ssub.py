"""The port's subsurface package (liverrenderer_tpu_torch/ssub) against the
JAX package's on identical inputs, made with numpy from a seed, on the CPU:
every function of poly, vae and dipole, the preprocessing (constraint
samples bit for bit, the per-vertex fits), the weight reader on
test-written files, one subsurface_event on a bridged scene, the
ground-truth walk, and the builders' subsurface buffers.

Both packages read the same seeded synthetic model (tests/
torch_sss_inputs.py, the published widths) through their own
load_model, substituted for the reference's absent files.

Tolerances (fp32; XLA and PyTorch sum products and reductions in another
order): elementwise functions rtol 1e-5, atol 1e-6; the rotation and the
MLPs rtol 1e-4, atol 1e-5; the least-squares fit and the fitted poly
tables atol 2e-3 of the largest coefficient (a 19x19 float32 solve;
seen 1e-5); the event's fields rtol 1e-4, atol 1e-4 on lanes whose
outcome agrees, its masks on every lane but at most 1 % and its sampler
state exactly; builder buffers exactly, but the irradiance (rtol 1e-5).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu.accel import intersect as jisect
from liverrenderer_tpu.core import rng as jrng
from liverrenderer_tpu.core.types import Ray as JRay
from liverrenderer_tpu.ssub import dipole as jdip
from liverrenderer_tpu.ssub import event as jevent
from liverrenderer_tpu.ssub import poly as jpoly
from liverrenderer_tpu.ssub import preprocess as jpre
from liverrenderer_tpu.ssub import vae as jvae
from liverrenderer_tpu.ssub import volpath3d as jwalk
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.accel import intersect as tisect
from liverrenderer_tpu_torch.bridge import numpy_tree, scene_from_numpy
from liverrenderer_tpu_torch.core import rng as trng
from liverrenderer_tpu_torch.core.types import Ray as TRay
from liverrenderer_tpu_torch.ssub import dipole as tdip
from liverrenderer_tpu_torch.ssub import event as tevent
from liverrenderer_tpu_torch.ssub import poly as tpoly
from liverrenderer_tpu_torch.ssub import preprocess as tpre
from liverrenderer_tpu_torch.ssub import vae as tvae
from liverrenderer_tpu_torch.ssub import volpath3d as twalk
from torch_sss_inputs import (SHEET, event_rays, sphere, sphere_dict,
                              substituted, write_model)
from torch_threads import torch_threads_per_worker  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
NET_RTOL, NET_ATOL = 1e-4, 1e-5
FIT_ATOL_REL = 2e-3
EV_RTOL, EV_ATOL = 1e-4, 1e-4
MASK_FRAC = 0.99
N = 512


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _close(t, j, rtol=RTOL, atol=ATOL, what=""):
    t, j = _np(t), _np(j)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol, err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return write_model(str(tmp_path_factory.mktemp("vae")), seed=3)


@pytest.fixture(scope="module")
def weights(model):
    """(JAX VAEWeights, the port's VAE) from the same files."""
    return jvae.load_model(*model), \
        tvae.vae_from_numpy(tvae.load_model(*model), "cpu")


@pytest.fixture(scope="module")
def vae_scenes(model):
    """(JAX scene, the port's scene built from the same dict, the port's
    scene bridged from the JAX one) of the vaescatter sphere and sheet.
    The sphere's sigma_t makes the bounded projection rays (2 kernel eps)
    miss for some exits and lets a few zero-scatter rays through."""
    d = sphere_dict("vaescatter", extra=SHEET, sigma_t=(3.0, 4.0, 6.0))
    with substituted(*model, jvae, tvae):
        js = lr.load_dict(d)
        ts = lrt.load_dict(d, device="cpu")
    return js, ts, scene_from_numpy(*numpy_tree(js), "cpu")


# ---------------------------------------------------------------------------
# poly
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def poly_inputs():
    rng = np.random.default_rng(5)
    n = rng.normal(size=(N, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return dict(coeffs=rng.normal(size=(N, 20)).astype(np.float32),
                rel=(rng.normal(size=(N, 3)) * 0.7).astype(np.float32),
                n=n, d=np.roll(n, 1, 0).copy(),
                albedo=rng.uniform(0.05, 0.999, N).astype(np.float32),
                sigma_t=rng.uniform(0.5, 80.0, N).astype(np.float32),
                g=rng.uniform(-0.5, 0.9, N).astype(np.float32))


def test_powers_and_eval_poly(poly_inputs):
    c, rel = poly_inputs["coeffs"], poly_inputs["rel"]
    # the basis multiplies the same factors in the same order: bit-equal
    np.testing.assert_array_equal(_np(tpoly._powers(_t(rel))),
                                  _np(jpoly._powers(rel)))
    _close(tpoly.eval_poly(_t(c), _t(rel)), jpoly.eval_poly(c, rel),
           NET_RTOL, NET_ATOL)
    _close(tpoly.eval_poly_grad(_t(c), _t(rel)),
           jpoly.eval_poly_grad(c, rel), NET_RTOL, NET_ATOL)


def test_basis_grad_is_the_jacobian(poly_inputs):
    """The closed-form monomial derivatives equal jax.jacfwd's (the JAX
    fit's gradient basis)."""
    rel = poly_inputs["rel"][:64]
    ref = jax.vmap(jax.jacfwd(jpoly._powers))(jnp.asarray(rel))
    _close(tpoly._basis_grad(_t(rel)), ref, RTOL, ATOL)


def test_onb_albedo_kernel_eps(poly_inputs):
    n = poly_inputs["n"]
    for a, b in zip(tpoly.onb_duff(_t(n)), jpoly.onb_duff(n)):
        _close(a, b)
    alb, sig, g = (poly_inputs[k] for k in ("albedo", "sigma_t", "g"))
    _close(tpoly.effective_albedo(_t(alb)), jpoly.effective_albedo(alb))
    k_t = tpoly.kernel_eps(_t(sig), _t(alb), _t(g), 1.7)
    k_j = jpoly.kernel_eps(sig, alb, g, 1.7)
    _close(k_t, k_j)
    _close(tpoly.fit_scale(k_t), jpoly.fit_scale(k_j))
    # floats, as the build-time fit passes them
    _close(tpoly.kernel_eps(2.0, 0.9, 0.1), jpoly.kernel_eps(2.0, 0.9, 0.1))


def test_rotate_poly_matches_jax_and_evaluation(poly_inputs):
    c, n, rel = (poly_inputs[k] for k in ("coeffs", "n", "rel"))
    s, t = jpoly.onb_duff(n)
    S = np.asarray(jnp.stack([s, t, jnp.asarray(n)], -1))
    rot = tpoly.rotate_poly(_t(c), _t(S))
    _close(rot, jpoly.rotate_poly(c, S), NET_RTOL, NET_ATOL)
    # f'(x) = f(S x)
    x_w = np.einsum("nij,nj->ni", S, rel)
    _close(tpoly.eval_poly(rot, _t(rel)), tpoly.eval_poly(_t(c), _t(x_w)),
           2e-4, 2e-5)


def test_poly_normal_and_adjusted_dir(poly_inputs):
    c, n, d = (poly_inputs[k] for k in ("coeffs", "n", "d"))
    c = c.copy()
    c[:8, 1:4] = n[:8] * 2.0           # parallel: the direction is kept
    for a, b in zip(tpoly.poly_normal_and_adjusted_dir(_t(c), _t(d), _t(n)),
                    jpoly.poly_normal_and_adjusted_dir(c, d, n)):
        _close(a, b, NET_RTOL, NET_ATOL)


def test_fit_polynomials_matches_jax():
    v, f = sphere(2)
    cp, cn = tpre.sample_surface(v, f, 2048)
    idx = tpre.nearest_samples(v, cp)
    k = np.full(len(v), float(jpoly.kernel_eps(2.0, 0.9, 0.0)), np.float32)
    ref = np.asarray(jpoly.fit_polynomials(v, cp[idx], cn[idx], k))
    out = tpoly.fit_polynomials(_t(v), _t(cp[idx]), _t(cn[idx]), _t(k))
    _close(out, ref, 0, FIT_ATOL_REL * np.abs(ref).max())
    # the gradient at the vertex (the linear terms) is the outward normal
    g = _np(out)[:, 1:4]
    cos = np.sum(g / np.linalg.norm(g, axis=-1, keepdims=True)
                 * v / np.linalg.norm(v, axis=-1, keepdims=True), -1)
    assert cos.min() > 0.99, cos.min()


# ---------------------------------------------------------------------------
# preprocess
# ---------------------------------------------------------------------------

def test_sample_surface_bit_for_bit():
    v, f = sphere(2, 1.3)
    for seed in (7, 21):
        for a, b in zip(tpre.sample_surface(v, f, 1000, seed),
                        jpre.sample_surface(v, f, 1000, seed)):
            np.testing.assert_array_equal(a, b)
    # an inward-wound mesh gives the same outward normals
    p_in, n_in = tpre.sample_surface(v, f[:, ::-1].copy(), 100)
    assert np.all(np.sum(n_in * p_in, -1) > 0)


def test_fit_shape_polys_matches_jax():
    v, f = sphere(2, 1.2)
    sig, alb = np.float32([2.0, 3.0, 5.0]), np.float32([0.95, 0.9, 0.8])
    ref = jpre.fit_shape_polys(v, f, sig, alb, 0.2, 1.5)
    out = tpre.fit_shape_polys(v, f, sig, alb, 0.2, 1.5)
    assert out.shape == ref.shape == (len(v), 3, 20)
    _close(out, ref, 0, FIT_ATOL_REL * np.abs(ref).max())


# ---------------------------------------------------------------------------
# vae
# ---------------------------------------------------------------------------

def test_load_bin_and_load_model(model, weights):
    jw, tw = weights
    var = model[0] + "/variables/"
    a = tvae.load_bin(var + "scatter_decoder_fcn_fcn_0_weights.bin")
    np.testing.assert_array_equal(
        a, jvae.load_bin(var + "scatter_decoder_fcn_fcn_0_weights.bin"))
    assert a.shape == (64, 68)
    arrays = tvae.load_model(*model)
    ref, _ = numpy_tree(jw)
    assert set(arrays) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(arrays[k], ref[k], err_msg=k)
    # the light-space statistics of training-metadata.json, not the
    # world-space key
    assert np.abs(arrays["feat_mean"]).max() < 1.0
    assert tvae.model_available(model[0])
    assert not tvae.model_available(model[0] + "_missing")


def test_vae_from_numpy_round_trip(weights):
    jw, tw = weights
    ref, _ = numpy_tree(jw)
    assert tw.pre0.weight.shape == (64, 23) and tw.dec0.weight.shape == (64,
                                                                         68)
    assert not any(p.requires_grad for p in tw.parameters())
    back = tvae.numpy_from_vae(tw)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)


def test_vae_networks_match_jax(weights, poly_inputs):
    jw, tw = weights
    c, alb, sig, g = (poly_inputs[k] for k in ("coeffs", "albedo",
                                               "sigma_t", "g"))
    eta = np.full(N, 1.33, np.float32)
    x_j = jvae.preprocess_features(jw, c, alb, g, eta, sig)
    x_t = tw.preprocess_features(_t(c), _t(alb), _t(g), _t(eta), _t(sig))
    _close(x_t, x_j, NET_RTOL, NET_ATOL)
    f_j = jvae.shared_features(jw, x_j)
    f_t = tw.shared_features(_t(np.asarray(x_j)))
    _close(f_t, f_j, NET_RTOL, NET_ATOL)
    f = np.asarray(f_j)
    _close(tw.absorption_prob(_t(f)), jvae.absorption_prob(jw, f),
           NET_RTOL, NET_ATOL)
    lat = np.random.default_rng(2).normal(size=(N, 4)).astype(np.float32)
    _close(tw.decode_outpos(_t(f), _t(lat)), jvae.decode_outpos(jw, f, lat),
           NET_RTOL, NET_ATOL)
    u = np.random.default_rng(3).random((2, N)).astype(np.float32)
    for a, b in zip(tvae.gaussian_from_uniform(_t(u[0]), _t(u[1])),
                    jvae.gaussian_from_uniform(u[0], u[1])):
        _close(a, b, RTOL, 1e-5)


# ---------------------------------------------------------------------------
# dipole
# ---------------------------------------------------------------------------

def test_dipole_constants_and_fresnel():
    eta = np.float32([0.6, 0.9, 1.0, 1.33, 1.6])
    np.testing.assert_array_equal(tdip.fresnel_diffuse_reflectance(eta),
                                  jdip.fresnel_diffuse_reflectance(eta))
    for a, b in zip(tdip.dipole_constants([2.0, 2.3, 3.0], [0.03, 0.1, 0.3],
                                          0.2, 1.33),
                    jdip.dipole_constants([2.0, 2.3, 3.0], [0.03, 0.1, 0.3],
                                          0.2, 1.33)):
        np.testing.assert_array_equal(a, b)
    mu = np.linspace(-1, 1, 41).astype(np.float32)
    e = np.full_like(mu, 1.3)
    _close(tevent.fresnel_moment1(_t(e)), jevent.fresnel_moment1(e))
    _close(tevent.sw_factor(_t(mu), _t(e)), jevent.sw_factor(mu, e))


@pytest.fixture(scope="module")
def dipole_scenes():
    d = sphere_dict("dipole")
    js = lr.load_dict(d)
    return js, lrt.load_dict(d, device="cpu"), \
        scene_from_numpy(*numpy_tree(js), "cpu")


def test_dipole_buffers_match_jax(dipole_scenes):
    js, ts, _ = dipole_scenes
    assert ts.ssub.enabled and ts.ssub.has_dipole and not ts.ssub.has_vae
    for k in ("dip_points", "dip_area", "dip_consts", "params", "ss_type"):
        np.testing.assert_array_equal(_np(getattr(ts.ssub, k)),
                                      _np(getattr(js.ssub, k)), err_msg=k)
    np.testing.assert_array_equal(_np(ts.shape_subsurface),
                                  _np(js.shape_subsurface))
    E = _np(ts.ssub.dip_irradiance)
    assert E.max() > 0 and E.shape == (1024, 3)
    _close(E, js.ssub.dip_irradiance, RTOL, 1e-6 * E.max())
    # compute_irradiance on the same scene and points
    _close(tdip.compute_irradiance(ts, ts.ssub.dip_points[:256],
                                   -ts.ssub.dip_points[:256]),
           jdip.compute_irradiance(js, js.ssub.dip_points[:256],
                                   -js.ssub.dip_points[:256]),
           RTOL, 1e-6 * E.max())


def test_dipole_lo_matches_jax(dipole_scenes):
    js, _, bs = dipole_scenes
    rng = np.random.default_rng(8)
    p = rng.normal(size=(N, 3)).astype(np.float32)
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    mu = rng.uniform(-0.2, 1.0, N).astype(np.float32)
    act = rng.random(N) < 0.8
    ref = jdip.dipole_lo(js, p, mu, act)
    _close(tdip.dipole_lo(bs, _t(p), _t(mu), _t(act)), ref, NET_RTOL,
           1e-6 * float(jnp.abs(ref).max()))


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

def test_vae_builder_buffers_match_jax(vae_scenes):
    js, ts, _ = vae_scenes
    assert ts.ssub.enabled and ts.ssub.has_vae and not ts.ssub.has_dipole
    for k in ("params", "ss_type", "dip_points", "dip_consts"):
        np.testing.assert_array_equal(_np(getattr(ts.ssub, k)),
                                      _np(getattr(js.ssub, k)), err_msg=k)
    np.testing.assert_array_equal(_np(ts.shape_subsurface),
                                  _np(js.shape_subsurface))
    assert ts.ssub.kernel_eps_scale == js.ssub.kernel_eps_scale
    ref = np.asarray(js.ssub.poly)
    # the sheet's and the sphere's vertices are fitted, per channel
    assert np.abs(ref).max(-1).min() > 0
    _close(ts.ssub.poly, ref, 0, FIT_ATOL_REL * np.abs(ref).max())
    # the internal dielectric of a subsurface shape without a BSDF
    np.testing.assert_array_equal(_np(ts.bsdfs.params),
                                  np.asarray(js.bsdfs.params))
    np.testing.assert_array_equal(_np(ts.bsdfs.btype),
                                  np.asarray(js.bsdfs.btype))


def test_absent_model_turns_the_vae_off(model):
    """Both builders turn the VAE off when the model is missing: the shape
    renders as its internal dielectric (the port warns once)."""
    d = sphere_dict("vaescatter", res=8)
    missing = model[0] + "_missing"
    with substituted(missing, model[1], jvae, tvae):
        js = lr.load_dict(d)
        with pytest.warns(UserWarning, match="no VAE model"):
            ts = lrt.load_dict(d, device="cpu")
    for s in (js.ssub, ts.ssub):
        assert not s.enabled and not s.has_vae and s.weights is None
    assert np.abs(_np(ts.ssub.poly)).max() == 0
    np.testing.assert_array_equal(_np(ts.ssub.params),
                                  np.asarray(js.ssub.params))
    # a dipole beside it keeps the subsurface on
    d2 = sphere_dict("vaescatter", res=8, extra={
        "blob2": dict(sphere_dict("dipole")["blob"],
                      to_world=lrt.Transform().translate([3, 0, 0]).matrix)})
    with substituted(missing, model[1], jvae, tvae), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js2, ts2 = lr.load_dict(d2), lrt.load_dict(d2, device="cpu")
    for s in (js2.ssub, ts2.ssub):
        assert s.enabled and s.has_dipole and not s.has_vae


# ---------------------------------------------------------------------------
# the event
# ---------------------------------------------------------------------------

def test_subsurface_event_matches_jax(vae_scenes, monkeypatch):
    js, _, bs = vae_scenes
    o, d = event_rays(N)
    n = len(o)
    jsi = jisect.ray_intersect(js, JRay(o=o, d=d, maxt=jnp.full((n,),
                                                                jnp.inf)))
    tsi = tisect.ray_intersect(bs, TRay(o=_t(o), d=_t(d),
                                        maxt=torch.full((n,), np.inf)))
    active = np.asarray(jsi.valid)
    # refracted into the object: the ray's direction bent toward -n
    refr = d - 0.3 * np.asarray(jsi.ng)
    refr = (refr / np.linalg.norm(refr, axis=-1, keepdims=True)).astype(
        np.float32)
    lane = np.arange(n)
    j_smp = jrng.make_sampler(jnp.asarray(lane, jnp.uint32), 0, 9)
    t_smp = trng.make_sampler(_t(lane), 0, 9)
    # record the port's intersection queries: zero-scatter, the bounded
    # and the unbounded projection pairs
    found = []
    orig = tevent.ray_intersect

    def rec(scene, ray, **kw):
        si = orig(scene, ray, **kw)
        found.append(si.valid)
        return si
    monkeypatch.setattr(tevent, "ray_intersect", rec)
    jev, j_smp = jevent.subsurface_event(js, jsi, refr, j_smp, active)
    tev, t_smp = tevent.subsurface_event(bs, tsi, _t(refr), t_smp,
                                         _t(active))
    for f in ("seed", "dim", "samp", "pix"):
        np.testing.assert_array_equal(_np(getattr(t_smp, f)),
                                      np.asarray(getattr(j_smp, f)).astype(
                                          np.int64), err_msg=f)
    same = np.ones(n, bool)
    for f in ("alive", "passthrough", "absorbed"):
        a, b = _np(getattr(tev, f)), np.asarray(getattr(jev, f))
        assert (a == b).mean() >= MASK_FRAC, f
        same &= a == b
    for f in ("out_p", "out_d", "out_n", "weight", "pdf", "L_nee",
              "absorb_p"):
        a, b = _np(getattr(tev, f)), np.asarray(getattr(jev, f))
        np.testing.assert_allclose(a[same], b[same], rtol=EV_RTOL,
                                   atol=EV_ATOL, err_msg=f)
    # the degenerate branches ran: zero-scatter rays through the open
    # sheet found no exit, and the unbounded projection caught points the
    # bounded one missed
    zs, b1, b2, u1, u2 = (_np(x) for x in found)
    assert (active & ~zs).sum() > 0
    assert (~(b1 | b2) & (u1 | u2) & _np(tev.alive)).sum() > 0
    ab = _np(tev.absorbed)
    assert ab.sum() > 0 and _np(tev.passthrough).sum() > 0
    assert (_np(tev.alive) & ~_np(tev.passthrough)).sum() > 0


# ---------------------------------------------------------------------------
# the ground-truth walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("albedo,eta", [(0.9, 1.0), (0.99, 1.33)])
def test_volpath3d_walk_matches_jax(albedo, eta):
    n = 2048
    p0 = np.zeros((n, 3), np.float32)
    p0[:, 2] = -1e-4
    d0 = np.zeros((n, 3), np.float32)
    d0[:, 2] = -1.0
    lane = np.arange(n)
    jr, j_smp = jwalk.sample_paths(
        jwalk.flat_halfspace_coeffs(), p0, d0, 10.0, albedo, 0.3,
        jrng.make_sampler(jnp.asarray(lane, jnp.uint32), 0, 1),
        max_bounces=64, eta=eta)
    tr, t_smp = twalk.sample_paths(
        twalk.flat_halfspace_coeffs(), _t(p0), _t(d0), 10.0, albedo, 0.3,
        trng.make_sampler(_t(lane), 0, 1), max_bounces=64, eta=eta)
    same = np.ones(n, bool)
    for f in ("absorbed", "exited", "n_bounces"):
        a, b = _np(getattr(tr, f)), np.asarray(getattr(jr, f))
        assert (a == b).mean() >= MASK_FRAC, f
        same &= a == b
    ex = _np(tr.exited) & same
    assert ex.sum() > n // 4
    for f in ("out_p", "out_d"):
        np.testing.assert_allclose(_np(getattr(tr, f))[ex],
                                   np.asarray(getattr(jr, f))[ex],
                                   rtol=1e-3, atol=1e-4, err_msg=f)
    # exits lie on the plane z = 0
    assert np.abs(_np(tr.out_p)[ex, 2]).max() < 2e-2
    np.testing.assert_array_equal(_np(t_smp.dim),
                                  np.asarray(j_smp.dim).astype(np.int64))
