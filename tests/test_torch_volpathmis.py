"""The spectral-MIS volumetric path tracer (`volpathmis`) in the port
against the JAX package on the CPU: its weight-matrix updates and MIS
weights on identical inputs, the images of tests/test_volpathmis.py's
chromatic fog and of a bio scene, and its routing (its media.params
gradient through the scan adjoint: tests/test_torch_volpathmis_grad.py;
a grid medium under volpathmis: tests/test_torch_grid_slice.py).

Tolerances.  Weight updates: fp32, rtol 1e-5 / atol 1e-6.  Images: those
of test_torch_render.py (>= 99 % of pixels within rtol 1e-3 / atol 1e-4,
the mean within 1e-3 relative): both packages draw bit-identical random
numbers, so paths agree lane by lane unless an ulp flips a discrete
decision.  Gradients: within 3e-6 of the largest entry (the order of the
per-lane sums differs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu.integrators import volpathmis as jvm
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.integrators import common as tcommon
from liverrenderer_tpu_torch.integrators import volpathmis as tvm
from liverrenderer_tpu_torch.integrators.regen import regen_applicable
from liverrenderer_tpu_torch.scene import cornell as tcornell
from liverrenderer_tpu_torch.scene.liver_proxy import liver_proxy_dict
from torch_threads import torch_threads_per_worker  # noqa: F401

PIX_RTOL, PIX_ATOL, PIX_FRAC, MEAN_RTOL = 1e-3, 1e-4, 0.99, 1e-3
G_ATOL_REL = 3e-6


def chroma_fog(res, integrator="volpathmis", max_depth=8,
               sigma=(0.9, 0.3, 0.05), albedo=0.8, cornell=None):
    """tests/test_volpathmis.py's Cornell box in a strongly chromatic
    homogeneous fog (each package's own cornell_box())."""
    d = (cornell or tcornell.cornell_box)()
    d["integrator"] = {"type": integrator, "max_depth": max_depth}
    d["sensor"]["film"] = {"type": "hdrfilm", "width": res, "height": res,
                           "rfilter": {"type": "box"}}
    d["sensor"]["medium"] = {
        "type": "homogeneous",
        "sigma_t": {"type": "rgb", "value": list(sigma)},
        "albedo": {"type": "rgb", "value": [albedo] * 3},
        "phase": {"type": "isotropic"}}
    return d


def _pair(**kw):
    return (lr.load_dict(chroma_fog(cornell=lr.cornell_box, **kw)),
            lrt.load_dict(chroma_fog(**kw), device="cpu"))


def _assert_images_agree(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.abs(img - ref) <= PIX_ATOL + PIX_RTOL * np.abs(ref)
    assert close.all(-1).mean() >= PIX_FRAC
    assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())


def _weight_inputs(rng, n=2048):
    W = rng.uniform(0.0, 3.0, (n, 3, 3)).astype(np.float32)
    W[rng.uniform(size=(n, 3, 3)) < 0.05] = np.inf
    W[rng.uniform(size=(n, 3, 3)) < 0.05] = 0.0
    p = rng.uniform(0.0, 2.0, (n, 3)).astype(np.float32)
    p[rng.uniform(size=(n, 3)) < 0.1] = 0.0
    f = rng.uniform(0.0, 2.0, (n, 3)).astype(np.float32)
    f[rng.uniform(size=(n, 3)) < 0.1] = 0.0
    f[rng.uniform(size=(n, 3)) < 0.05] = np.inf
    active = rng.uniform(size=n) < 0.8
    return W, p, f, active


def test_update_weights_and_mis_weights_match_jax():
    """update_weights with (N,3), (N,) and scalar p and f (zeros, infs and
    infinite W entries included), mis_weight and mis_weight2."""
    rng = np.random.default_rng(5)
    W, p, f, active = _weight_inputs(rng)
    W2 = rng.uniform(0.0, 2.0, W.shape).astype(np.float32)
    for pp, ff in ((p, f), (p[:, 0], f), (p, f[:, 1]), (1.0, f),
                   (p[:, 2], 1.0)):
        j = jvm.update_weights(jnp.asarray(W), jnp.asarray(pp),
                               jnp.asarray(ff), jnp.asarray(active))
        t = tvm.update_weights(torch.from_numpy(W), torch.as_tensor(pp),
                               torch.as_tensor(ff), torch.from_numpy(active))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)
    for a in (W, W2, np.zeros_like(W)):
        np.testing.assert_allclose(
            tvm.mis_weight(torch.from_numpy(a)).numpy(),
            np.asarray(jvm.mis_weight(jnp.asarray(a))), rtol=1e-5)
    np.testing.assert_allclose(
        tvm.mis_weight2(torch.from_numpy(W2), torch.from_numpy(W)).numpy(),
        np.asarray(jvm.mis_weight2(jnp.asarray(W2), jnp.asarray(W))),
        rtol=1e-5)


@pytest.mark.parametrize("kind", ["chroma_fog", "absorbing", "bio"])
def test_volpathmis_image_matches_jax(kind):
    """chroma_fog: the strongly chromatic fog of test_volpathmis.py (NEE
    through the MIS'd ratio-tracked walk); absorbing: its purely absorbing
    variant (albedo 0); bio: the liver proxy under volpathmis (bio media
    through the base majorant sampling, in the spectral-MIS module as in
    the JAX package)."""
    if kind == "bio":
        d = liver_proxy_dict(16, 12, 4, 2, 0)
        d["integrator"]["type"] = "volpathmis"
        js, ts = lr.load_dict(d), lrt.load_dict(d, device="cpu")
        spp = 4
    else:
        albedo = 0.0 if kind == "absorbing" else 0.8
        js, ts = _pair(res=12, max_depth=6, albedo=albedo)
        spp = 4
    assert ts.integrator == "volpathmis"
    ref = np.asarray(lr.render(js, spp=spp, seed=1))
    img = lrt.render(ts, spp=spp, seed=1).numpy()
    assert img.mean() > 1e-3
    _assert_images_agree(img, ref)


def test_every_volpathmis_scene_runs_the_mis_module(monkeypatch):
    """Stock and bio volpathmis scenes run volpathmis.sample on the fixed
    wavefront (never regen, as in the JAX package)."""
    calls = []
    orig = tvm.sample

    def spy(scene, sampler, ray, mode="primal"):
        calls.append(mode)
        return orig(scene, sampler, ray, mode=mode)

    monkeypatch.setattr(tcommon.volpathmis_mod, "sample", spy)
    d = liver_proxy_dict(4, 4, 1, 1, 0)
    d["integrator"]["type"] = "volpathmis"
    for sc in (lrt.load_dict(chroma_fog(4, max_depth=2), device="cpu"),
               lrt.load_dict(d, device="cpu")):
        assert not regen_applicable(sc, "primal")
        lrt.render(sc, spp=1, seed=0)
    assert calls == ["primal", "primal"]
