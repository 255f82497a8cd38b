"""The media.params gradient of `volpathmis` through the scan adjoint in
the port against the JAX package on the CPU (split from
tests/test_torch_volpathmis.py, whose scenes and tolerances it shares):
within 3e-6 of the largest entry (the order of the per-lane sums
differs), on the JAX side with its weight update guarded as the port's
is.  Clearing JAX's caches around the guarded render keeps the guard out
of other tests' traces."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu.integrators import volpathmis as jvm
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.bridge import params_from_numpy
from test_torch_volpathmis import (G_ATOL_REL, _assert_images_agree, _pair,
                                   chroma_fog)
from torch_threads import torch_threads_per_worker  # noqa: F401


def _jax_update_weights_guarded(W, p, f, active):
    """The JAX package's update_weights with the denominator f = 0
    replaced before the divide (same values; its reverse pass is then
    finite wherever no weight overflows)."""
    n = W.shape[0]
    p = jvm._spec(p, n)
    f = jvm._spec(f, n)
    fz = (f == 0.0)[:, :, None]
    ratio = p[:, None, :] / jnp.where(fz, 1.0, f[:, :, None])
    ratio = jnp.where(~fz & jnp.isfinite(ratio), ratio, 0.0)
    Wn = W * ratio
    Wn = jnp.where(jnp.isnan(Wn), 0.0, Wn)
    return jnp.where(active[:, None, None], Wn, W)


def test_media_params_gradient_scan_matches_jax(monkeypatch):
    """The media.params gradient of test_volpathmis.py's mildly chromatic
    fog through the scan adjoint (volpathmis is not regen-able).  The JAX
    package's own gradient is nan on such fogs (measured on the strongly
    chromatic one): its weight update divides by sigma_n = 0 at a
    homogeneous medium's null collisions, and the masked lanes' zero
    cotangents meet 1/0.  The port guards that term
    (volpathmis._WeightUpdate), so it is held to the JAX package with the
    same guard, in every entry.  On the strongly chromatic fog, where the
    weights overflow to inf on long paths, the port's gradient is finite
    too."""
    js, ts = _pair(res=8, max_depth=4, sigma=(0.5, 0.35, 0.2))
    key = "media.params"

    def loss(im):
        return jnp.mean(im * jnp.asarray([1.0, 0.5, 0.25]))

    def tloss(im):
        return torch.mean(im * torch.tensor([1.0, 0.5, 0.25]))

    monkeypatch.setattr(jvm, "update_weights", _jax_update_weights_guarded)
    jax.clear_caches()
    _, jg, jimg = lr.render_grad(js, {key: js.media.params}, loss, spp=2,
                                 seed=0)
    jax.clear_caches()
    params = params_from_numpy({key: np.asarray(js.media.params)}, "cpu")
    _, tg, timg = lrt.render_grad(ts, params, tloss, spp=2, seed=0)
    g, ref = tg[key].numpy(), np.asarray(jg[key])
    assert np.isfinite(ref).all()
    _assert_images_agree(timg.numpy(), np.asarray(jimg))
    scale = np.abs(ref).max()
    assert scale > 0 and np.abs(ref[:, 0:3]).min() > 0
    np.testing.assert_allclose(g, ref, atol=G_ATOL_REL * scale, rtol=0)
    strong = lrt.load_dict(chroma_fog(8, max_depth=4), device="cpu")
    _, tg, _ = lrt.render_grad(
        strong, {key: strong.media.params.clone()}, tloss, spp=2, seed=0)
    assert torch.isfinite(tg[key]).all() and tg[key].abs().max() > 0
