"""The port's sunsky (emitter/sunsky.py and the builder's sunsky, sun, sky
and timed_sunsky plugins) against the JAX package on the CPU.

Tolerances: the host numpy functions (sun_direction, preetham_envmap) and
the baked envmap are bit for bit (both packages run the same numpy
operations); the sun-lit bumped liver proxy (biovolpath, depth 12, the
main path with the synthetic sky replaced by a sunsky) per pixel, >= 99 %
of pixels within rtol 1e-3 / atol 1e-4 and the means within 1e-3
relative, and its media.params gradient within 3e-6 of the largest entry
(those of tests/test_torch_bump_env_slice.py).  The proxy's dielectric
never samples the envmap by NEE, so the port renders its own build (the
two builders sum the envmap's CDF in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import liverrenderer_tpu as lr
from liverrenderer_tpu.emitter import sunsky as jsun
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.bridge import numpy_tree, params_from_numpy
from liverrenderer_tpu_torch.emitter import sunsky as tsun
from liverrenderer_tpu_torch.scene.liver_proxy import liver_proxy_dict
from torch_m10_scenes import sunsky_proxy
from torch_threads import torch_threads_per_worker  # noqa: F401

PIX_RTOL, PIX_ATOL, PIX_FRAC, MEAN_RTOL = 1e-3, 1e-4, 0.99, 1e-3
G_ATOL_REL = 3e-6

# the calls of tests/test_sunsky.py's five tests: (turbidity, hour, res,
# sun_scale) per bake
_BAKES = {
    "cie_clear_sky_shape": [(2.5, 10.0, 64, 0.0)],
    "zenith_luminance": [(2.5, 10.0, 32, 0.0)],
    "circumsolar_turbidity": [(2.0, 10.0, 48, 0.0), (6.0, 10.0, 48, 0.0)],
    "sun_disc_energy": [(3.0, 12.0, r, s) for r in (64, 128, 256)
                        for s in (0.0, 1.0)],
    "direct_to_diffuse": [(2.5, 11.0, 96, 0.0), (2.5, 11.0, 96, 1.0)],
}


@pytest.mark.parametrize("case", sorted(_BAKES))
def test_sunsky_functions_bit_equal(case):
    """sun_direction and preetham_envmap equal the JAX package's bit for
    bit at the inputs of tests/test_sunsky.py's test."""
    for turb, hour, res, sun_scale in _BAKES[case]:
        sd_t = tsun.sun_direction(hour=hour)
        sd_j = jsun.sun_direction(hour=hour)
        np.testing.assert_array_equal(sd_t, sd_j)
        img_t = tsun.preetham_envmap(turbidity=turb, sun_dir=sd_t, res=res,
                                     sun_scale=sun_scale)
        img_j = jsun.preetham_envmap(turbidity=turb, sun_dir=sd_j, res=res,
                                     sun_scale=sun_scale)
        assert img_t.dtype == np.float32 and img_t.shape == (res, 2 * res, 3)
        np.testing.assert_array_equal(img_t, img_j)
    for lat, day in ((35.0, 180), (-20.0, 10), (60.0, 300)):
        for hour in (7.5, 12.0, 16.25):
            np.testing.assert_array_equal(
                tsun.sun_direction(hour, lat, day),
                jsun.sun_direction(hour, lat, day))


def _sky_scene(emitter):
    return {"type": "scene", "integrator": {"type": "path", "max_depth": 2},
            "sensor": {"type": "perspective",
                       "film": {"type": "hdrfilm", "width": 4, "height": 4}},
            "plane": {"type": "rectangle", "bsdf": {"type": "diffuse"}},
            "sky": emitter}


@pytest.mark.parametrize("emitter", [
    {"type": "sunsky"},
    {"type": "sun", "hour": 9.0, "turbidity": 4.0},
    {"type": "sky", "latitude": -30.0, "day": 20, "scale": 2.0},
    {"type": "timed_sunsky", "sun_direction": [0.3, 0.8, -0.5],
     "sky_scale": 0.5, "sun_scale": 2.0}])
def test_sunsky_plugins_bake_the_same_envmap(emitter):
    """Each plugin builds an envmap emitter whose baked image, scale and
    importance map equal the JAX builder's (the map's CDF within fp32: the
    JAX package sums it with XLA's cumsum)."""
    ja, _ = numpy_tree(lr.load_dict(_sky_scene(emitter)))
    ts = lrt.load_dict(_sky_scene(emitter), device="cpu")
    ta, _ = numpy_tree(ts)
    assert ts.emitters.env_index == 0
    for k in ("textures.bitmaps", "textures.quads", "textures.ttype",
              "emitters.etype", "emitters.params", "emitters.to_world"):
        np.testing.assert_array_equal(ta[k], np.asarray(ja[k]), err_msg=k)
    for k in ("cond_cdf", "marg_cdf"):
        k = f"emitters.env_distr.{k}"
        np.testing.assert_allclose(ta[k], ja[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def _assert_images_agree(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.abs(img - ref) <= PIX_ATOL + PIX_RTOL * np.abs(ref)
    assert close.all(-1).mean() >= PIX_FRAC
    assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())


def test_sunsky_proxy_render_and_grad_match_jax():
    """The main path lit by a sunsky: render_grad of mean(image) with
    respect to media.params through the replay adjoint, its primal image
    per pixel and the gradient per entry (seed 1, as the bumped proxy's
    gradient tests: seed 0 puts a bump-frame texel edge on a hit)."""
    d = sunsky_proxy(liver_proxy_dict(12, 9, 4, 2, 0, bump=(32, 0.05)),
                     hour=10.0)
    js = lr.load_dict(d)
    ts = lrt.load_dict(d, device="cpu")
    key = "media.params"
    _, jg, jimg = lr.render_grad(js, {key: lr.traverse(js)[key]},
                                 lambda im: jnp.mean(im), spp=4, seed=1)
    ref = np.asarray(jg[key])
    params = params_from_numpy({key: np.asarray(lr.traverse(js)[key])},
                               "cpu")
    _, tg, timg = lrt.render_grad(ts, params, lambda im: im.mean(), spp=4,
                                  seed=1)
    img = timg.numpy()
    _assert_images_agree(img, np.asarray(jimg))
    assert img.mean() > 1e-2
    g = tg[key].numpy()
    assert np.isfinite(g).all() and np.abs(ref).max() > 0
    np.testing.assert_allclose(g, ref, rtol=0,
                               atol=G_ATOL_REL * np.abs(ref).max())
