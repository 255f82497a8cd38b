"""The primal biovolpath slice as a whole: the port against the JAX
package on the liver proxy (320 triangles, depth 12), on the CPU.

Tolerances.  Both packages draw bit-identical random numbers and run the
same fp32 formulas, so paths agree lane by lane; a path can still diverge
where an ulp-level difference (XLA's and PyTorch's log/exp/sin, or a sum
taken in another order) flips a discrete decision: the dielectric's
reflect-or-refract test u <= F, the null/real collision test, Russian
roulette u < q, or a hit on a shared triangle edge.  A flipped path moves
its pixel by a whole sample's worth.  Hence the per-pixel criterion is a
fraction: >= 99 % of pixels within rtol 1e-3 / atol 1e-4, and the image
mean within 1e-3 relative.  Measured on this scene: every pixel equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu.integrators import regen as jregen
from liverrenderer_tpu.integrators import volpath as jvp
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.integrators import common as tcommon
from liverrenderer_tpu_torch.integrators import regen as tregen
from liverrenderer_tpu_torch.integrators import volpath as tvp
from liverrenderer_tpu_torch.scene.liver_proxy import liver_proxy_dict
from torch_threads import torch_threads_per_worker  # noqa: F401

PIX_RTOL, PIX_ATOL, PIX_FRAC, MEAN_RTOL = 1e-3, 1e-4, 0.99, 1e-3


def _assert_images_agree(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.abs(img - ref) <= PIX_ATOL + PIX_RTOL * np.abs(ref)
    assert close.all(-1).mean() >= PIX_FRAC
    assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())


@pytest.fixture(scope="module")
def scenes():
    d = liver_proxy_dict(16, 12, 4, 2, 0)
    return lr.load_dict(d), lrt.load_dict(d, device="cpu")


def test_bounce_matches_on_identical_state(scenes):
    """Camera lanes seeded by both packages, then three bounces: through
    the dielectric boundary into the liver medium and its collisions."""
    js, ts = scenes
    ids = np.arange(768)
    jst, jpos = jregen._make_lanes(js, jnp.asarray(ids, jnp.uint32), 0, 4)
    tst, tpos = tregen._make_lanes(ts, torch.from_numpy(ids), 0, 4)
    np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), rtol=1e-6)
    for it in range(3):
        jst = jvp.bounce(js, jst, False)
        tst = tvp.bounce(ts, tst)
        same = (tst.active.numpy() == np.asarray(jst.active)) \
            & (tst.medium.numpy() == np.asarray(jst.medium)) \
            & (tst.depth.numpy() == np.asarray(jst.depth))
        assert same.mean() >= 0.99, it
        for f in dataclasses.fields(tst):
            # lam: the spectral variant's packet, None in RGB
            if f.name == "sampler" or getattr(tst, f.name) is None:
                continue
            a = getattr(tst, f.name).numpy()[same]
            b = np.asarray(getattr(jst, f.name))[same]
            if np.issubdtype(b.dtype, np.floating):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                           err_msg=f"{f.name} @ {it}")
            else:
                np.testing.assert_array_equal(a, b.astype(a.dtype),
                                              err_msg=f"{f.name} @ {it}")
        np.testing.assert_array_equal(tst.sampler.dim.numpy(),
                                      np.asarray(jst.sampler.dim))
    # the walk reached the medium and scattered there
    assert (tst.medium.numpy() >= 0).any() and (tst.tissue_depth > 0).any()


def test_render_matches_jax_per_pixel(scenes):
    js, ts = scenes
    ref = np.asarray(lr.render(js, spp=4, seed=0))
    img = lrt.render(ts, spp=4, seed=0).numpy()
    _assert_images_agree(img, ref)
    # misses see the white environment; the liver attenuates
    assert np.allclose(img[0, 0], 1.0) and img[6, 8].mean() < 1.0


def test_render_pass_matches_regen(scenes):
    """The fixed wavefront and the regenerating one compute the same
    per-sample estimate; only the film sums' order differs."""
    _, ts = scenes
    fixed = tcommon._render_jit(ts, 0, 4, 4).numpy()
    two_pass = tcommon._render_jit(ts, 0, 4, 2).numpy()
    regen = lrt.render(ts, spp=4, seed=0).numpy()
    _assert_images_agree(fixed, regen)
    np.testing.assert_allclose(two_pass, fixed, rtol=1e-5, atol=1e-6)


def test_tiled_regen_matches_untiled(scenes, monkeypatch):
    _, ts = scenes
    ref = lrt.render(ts, spp=2, seed=3).numpy()
    monkeypatch.setattr(tregen, "TILE_PIX", 64)
    monkeypatch.setattr(tregen, "REGEN_WAVEFRONT", 96)
    np.testing.assert_allclose(lrt.render(ts, spp=2, seed=3).numpy(), ref,
                               rtol=1e-5, atol=1e-6)


def test_tent_filter_matches_jax():
    d = liver_proxy_dict(12, 8, 2, 1, 1)
    d["sensor"]["film"]["rfilter"] = {"type": "tent"}
    ref = np.asarray(lr.render(lr.load_dict(d), spp=2, seed=1))
    _assert_images_agree(lrt.render(lrt.load_dict(d, device="cpu"), spp=2,
                                    seed=1).numpy(),
                         ref)


def test_nee_scenes_raise():
    """Next-event estimation is ported: the liver under stock volpath in a
    fog (medium NEE through the ratio-tracked shadow walk) renders, with
    a directional sun and a sunsky added."""
    d = liver_proxy_dict(4, 4, 1, 0)
    d["integrator"]["type"] = "volpath"
    d["fog"] = {"type": "homogeneous", "sigma_t": 0.5}
    d["liver"]["exterior"] = {"type": "ref", "id": "fog"}
    ts = lrt.load_dict(d, device="cpu")
    assert ts.needs_medium_nee
    assert torch.isfinite(lrt.render(ts, spp=1)).all()
    # a directional sun (ported since) is sampled by NEE as well
    d["sun"] = {"type": "directional", "direction": [0, -1, 0]}
    assert torch.isfinite(lrt.render(lrt.load_dict(d, device="cpu"),
                                     spp=1)).all()
    # and a sunsky (ported since), its baked envmap sampled by NEE
    d["sky"] = {"type": "sunsky"}
    ts = lrt.load_dict(d, device="cpu")
    assert ts.emitters.env_index >= 0
    assert torch.isfinite(lrt.render(ts, spp=1)).all()
