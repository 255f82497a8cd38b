"""The gradient slice as a whole: `render_grad` of the port against the JAX
package's on the CPU, on the scenes of test_prb_replay.py and the liver
proxy.

The slab scenes are those of test_prb_replay.py (a null-BSDF sphere around
a homogeneous medium under a constant environment) rendered by biovolpath
instead of volpath: biovolpath runs the stock transport in a homogeneous
medium and never reaches next-event estimation there, while volpath would
add NEE through the medium (tests/test_torch_nee_slice.py covers that).
Both packages render the same dict.

Tolerances.  Both packages walk the same paths (bit-identical counter RNG),
so gradients agree to the order in which per-lane terms are summed:
rtol 2e-3 with atol 1e-4 * max|g_jax|; images at the per-pixel tolerances
of test_torch_render.py.  Measured: within 3e-6 * max|g_jax|, images
equal.
The port's own comparisons keep the JAX tests' tolerances: replay vs scan
adjoint (cosine > 0.999, norms within 2 %), tiled vs single walk (rtol
2e-3, atol 1e-7), the analytic slab (rtol 0.1) and finite differences
(rtol 0.05).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import liverrenderer_tpu as lr
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.bridge import params_from_numpy
from liverrenderer_tpu_torch.integrators import prb_replay as treplay
from liverrenderer_tpu_torch.integrators import regen as tregen
from liverrenderer_tpu_torch.scene.liver_proxy import liver_proxy_dict
from liverrenderer_tpu_torch.scene.transform import Transform
from torch_threads import torch_threads_per_worker  # noqa: F401

G_RTOL, G_ATOL_REL = 2e-3, 1e-4
PIX_RTOL, PIX_ATOL, PIX_FRAC, MEAN_RTOL = 1e-3, 1e-4, 0.99, 1e-3


def _slab(sigma_t=0.6, albedo=0.0, rfilter="box", res=4):
    cam = Transform().look_at([0, 0, 5], [0, 0, 0], [0, 1, 0])
    return {
        "type": "scene",
        "integrator": {"type": "biovolpath", "max_depth": 8},
        "sensor": {
            "type": "perspective", "fov": 3.0, "to_world": cam.matrix.copy(),
            "film": {"type": "hdrfilm", "width": res, "height": res,
                     "rfilter": {"type": rfilter}},
        },
        "ball": {"type": "sphere", "radius": 1.0, "bsdf": {"type": "null"},
                 "interior": {"type": "homogeneous",
                              "sigma_t": {"type": "rgb",
                                          "value": [sigma_t] * 3},
                              "albedo": {"type": "rgb",
                                         "value": [albedo] * 3}}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [1.0] * 3}},
    }


def _pair(d):
    return lr.load_dict(d), lrt.load_dict(d, device="cpu")


def _jax_grad(js, key, spp, seed, **kw):
    """JAX render_grad of mean(image) -> (grad, image) as numpy."""
    _, g, img = lr.render_grad(js, {key: lr.traverse(js)[key]},
                               lambda im: jnp.mean(im), spp=spp, seed=seed,
                               **kw)
    return np.asarray(g[key]), np.asarray(img)


def _port_grad(ts, js, key, spp, seed, **kw):
    """The port's, with the JAX scene's parameters handed over as numpy."""
    params = params_from_numpy({key: np.asarray(lr.traverse(js)[key])},
                               "cpu")
    loss, g, img = lrt.render_grad(ts, params, lambda im: im.mean(), spp=spp,
                                   seed=seed, **kw)
    assert loss.shape == () and abs(float(loss) - float(img.mean())) < 1e-6
    return g[key].numpy(), img.numpy()


def _assert_grads_agree(g, ref):
    assert np.isfinite(g).all() and np.abs(ref).max() > 0
    np.testing.assert_allclose(g, ref, rtol=G_RTOL,
                               atol=G_ATOL_REL * np.abs(ref).max())


def _assert_images_agree(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.abs(img - ref) <= PIX_ATOL + PIX_RTOL * np.abs(ref)
    assert close.all(-1).mean() >= PIX_FRAC
    assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())


def _cosine_and_norms(a, b):
    assert np.isfinite(a).all() and np.isfinite(b).all()
    cos = (a * b).sum() / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-12)
    assert cos > 0.999, cos
    np.testing.assert_allclose(np.linalg.norm(a), np.linalg.norm(b),
                               rtol=0.02)


@pytest.fixture(scope="module")
def scattering():
    """The scattering slab and the JAX replay gradient of its medium."""
    js, ts = _pair(_slab(sigma_t=1.2, albedo=0.7))
    return js, ts, _jax_grad(js, "media.params", 64, 3, replay=True)


def test_absorbing_slab_matches_jax_and_analytic():
    """Absorbing slab: L = exp(-2 sigma), so dL/dsigma = -2 L."""
    js, ts = _pair(_slab())
    ref, ref_img = _jax_grad(js, "media.params", 512, 5, replay=True)
    g, img = _port_grad(ts, js, "media.params", 512, 5)
    _assert_grads_agree(g, ref)
    _assert_images_agree(img, ref_img)
    np.testing.assert_allclose(g[0, 0:3].sum(), -2.0 * img.mean(), rtol=0.1)


def test_scattering_slab_replay_matches_jax(scattering):
    js, ts, (ref, ref_img) = scattering
    g, img = _port_grad(ts, js, "media.params", 64, 3, replay=True)
    _assert_grads_agree(g, ref)
    _assert_images_agree(img, ref_img)


def test_scattering_slab_replay_matches_scan_adjoint(scattering):
    """Same seed, same paths: the two adjoints of the port agree as the
    JAX package's do (test_prb_replay.py)."""
    js, ts, _ = scattering
    g_r, img_r = _port_grad(ts, js, "media.params", 64, 3, replay=True)
    g_s, img_s = _port_grad(ts, js, "media.params", 64, 3, replay=False)
    _cosine_and_norms(g_r, g_s)
    np.testing.assert_allclose(img_r, img_s, rtol=1e-4, atol=1e-5)


def test_tent_filter_matches_jax_and_scan():
    """The tent filter's 2x2 splat adjoint against the JAX replay and the
    port's scan adjoint (which differentiates the splat directly)."""
    js, ts = _pair(_slab(sigma_t=1.0, albedo=0.6, rfilter="tent", res=6))
    ref, ref_img = _jax_grad(js, "media.params", 64, 11, replay=True)
    g, img = _port_grad(ts, js, "media.params", 64, 11)
    _assert_grads_agree(g, ref)
    _assert_images_agree(img, ref_img)
    g_s, _ = _port_grad(ts, js, "media.params", 64, 11, replay=False)
    _cosine_and_norms(g, g_s)


def test_tiled_schedules_match_single_walk(monkeypatch):
    """64 pixels in 4 tiles of 16 and a pool cap of 128 paths (spp chunks
    of 8): the keep-pools schedule and the low-memory one reproduce the
    single walk."""
    ts = lrt.load_dict(_slab(sigma_t=1.2, albedo=0.7, res=8), device="cpu")
    params = {"media.params": ts.media.params}

    def run():
        _, g, img = lrt.render_grad(ts, params, lambda im: im.mean(),
                                    spp=16, seed=3)
        return g["media.params"].numpy(), img.numpy()

    g_one, img_one = run()
    monkeypatch.setattr(tregen, "TILE_PIX", 16)
    monkeypatch.setattr(treplay, "MAX_STORE_PATHS", 16 * 8)
    calls = []
    orig = treplay._tile_walk
    monkeypatch.setattr(treplay, "_tile_walk",
                        lambda *a: calls.append(a[4].shape) or orig(*a))
    g_t, img_t = run()
    assert calls == [(128, 3)] * 8
    np.testing.assert_allclose(img_t, img_one, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(g_t, g_one, rtol=2e-3, atol=1e-7)

    monkeypatch.setattr(treplay, "POOL_BYTES_CAP", 0)
    g_lm, img_lm = run()
    assert len(calls) == 16
    np.testing.assert_allclose(img_lm, img_one, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(g_lm, g_one, rtol=2e-3, atol=1e-7)


def test_env_radiance_gradient_matches_jax_and_fd():
    """The constant environment's radiance: through the env_weight
    cotangent and the env term's own cotangent at lane death."""
    js, ts = _pair(_slab(sigma_t=0.3, albedo=0.5))
    ref, _ = _jax_grad(js, "emitters.params", 128, 9, replay=True)
    g, _ = _port_grad(ts, js, "emitters.params", 128, 9)
    _assert_grads_agree(g, ref)
    eps = 1e-2

    def loss_at(delta):
        ep = ts.emitters.params.clone()
        ep[:, 0:3] += delta
        sc = lrt.apply_params(ts, {"emitters.params": ep})
        return float(lrt.render(sc, spp=128, seed=9).mean())

    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    np.testing.assert_allclose(g[:, 0:3].sum(), fd, rtol=0.05)
    assert g[:, 0:3].sum() > 0


def test_liver_proxy_media_gradient_matches_jax():
    """The main path's workload at test size: the liver proxy (16x12,
    4 spp, 320 triangles, biovolpath depth 12), the bio score term and the
    dielectric boundary included."""
    js, ts = _pair(liver_proxy_dict(16, 12, 4, 2, 0))
    ref, ref_img = _jax_grad(js, "media.params", 4, 0)
    g, img = _port_grad(ts, js, "media.params", 4, 0)
    _assert_grads_agree(g, ref)
    _assert_images_agree(img, ref_img)
    # the layered medium's coefficients all receive a gradient
    assert (np.abs(g[0, 12:36]) > 0).sum() >= 12


def test_render_fwd_grad_matches_jax():
    """Forward mode (JVP with unit tangents) through the scan walk."""
    js, ts = _pair(_slab(sigma_t=0.8, albedo=0.5))
    key = "media.params"
    img_j, jvp_j = lr.render_fwd_grad(js, {key: lr.traverse(js)[key]},
                                      spp=8, seed=1)
    img_t, jvp_t = lrt.render_fwd_grad(
        ts, params_from_numpy({key: np.asarray(lr.traverse(js)[key])},
                              "cpu"), spp=8, seed=1)
    _assert_images_agree(img_t.numpy(), np.asarray(img_j))
    jvp_j = np.asarray(jvp_j)
    _assert_grads_agree(jvp_t.numpy(), jvp_j)
