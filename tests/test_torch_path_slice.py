"""The surface path family as a whole: the port's bounce, images and
gradients against the JAX package on the CPU.

- one `path.bounce` on identical lane state (the JAX state after a first
  bounce, carried over as numpy), primal and ad=True, and the VJP of the
  recorded bounce;
- per-pixel images of BASELINE's `cornell_box()` at 16x16, 4 spp, on the
  fixed wavefront (its gaussian filter) and on the regenerating wavefront
  (a box filter), and of `direct` and `prb` plane scenes;
- `render_grad` on the dict-built configs of tests/test_ad_configs.py
  (the plane under an area, constant or point light; a rough conductor)
  through the replay adjoint, and on a gaussian-filtered and a `prb`
  scene through the scan adjoint, whose primal image comes from the same
  fixed passes as its adjoint.

Tolerances: both packages draw bit-identical random numbers and run the
same fp32 formulas, so every path agrees lane by lane; the sums differ by
ulps (XLA's and PyTorch's transcendentals, another summation order).
Images: every pixel within rtol 1e-4 and atol 1e-6 (seen: 4e-6
relative).  Gradients: every entry within 1e-5 of the largest |entry|
(seen: 1.7e-7).  Lane state after a bounce: rtol 1e-4, atol 1e-5, with
discrete outcomes (active, depth, valid) equal.

The recorded bounce's VJP and the scan-adjoint gradients run from
tests/test_torch_path_adjoint.py, which shares this file's scenes and
tolerances, so that xdist's file scheduler can start them apart from
this file (a long file holds one worker to its end).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu.integrators import path as jpath
from liverrenderer_tpu.integrators import regen as jregen
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.bridge import params_from_numpy
from liverrenderer_tpu_torch.core.rng import Sampler as TSampler
from liverrenderer_tpu_torch.integrators import path as tpath
from liverrenderer_tpu_torch.integrators import regen as tregen
from liverrenderer_tpu_torch.scene import cornell as tcornell
from torch_threads import torch_threads_per_worker  # noqa: F401

PIX_RTOL, PIX_ATOL = 1e-4, 1e-6
G_ATOL_REL = 1e-5

# the configs of tests/test_ad_configs.py:80-103 built from one dict
_CONFIGS = {
    "diffuse_albedo": ({}, "textures.data"),
    "area_radiance": ({}, "emitters.params"),
    "env_radiance": ({"light": {"type": "constant",
                                "radiance": {"type": "rgb",
                                             "value": [1.5] * 3}}},
                     "emitters.params"),
    "point_intensity": ({"light": {"type": "point",
                                   "position": [0.5, 0.5, 1.5],
                                   "intensity": {"type": "rgb",
                                                 "value": [6.0] * 3}}},
                        "emitters.params"),
    "rough_alpha": ({"bsdf": {"type": "roughconductor", "alpha": 0.3,
                              "material": "Al"}}, "bsdfs.params"),
}


def _pair(d):
    return lr.load_dict(d), lrt.load_dict(d, device="cpu")


def _cornell(res, rfilter):
    """(JAX scene, port scene): each package's own cornell_box()."""
    out = []
    for d in (lr.cornell_box(), tcornell.cornell_box()):
        d["sensor"]["film"].update(width=res, height=res,
                                   rfilter={"type": rfilter})
        out.append(d)
    return lr.load_dict(out[0]), lrt.load_dict(out[1], device="cpu")


def _assert_images_equal(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    np.testing.assert_allclose(img, ref, rtol=PIX_RTOL, atol=PIX_ATOL)


def _grads(js, ts, key, spp, seed=0, loss=("mean", jnp.mean, torch.mean),
           **kw):
    """(JAX, port) render_grad of loss(image) with respect to key."""
    _, jg, jimg = lr.render_grad(js, {key: lr.traverse(js)[key]}, loss[1],
                                 spp=spp, seed=seed, **kw)
    params = params_from_numpy({key: np.asarray(lr.traverse(js)[key])},
                               "cpu")
    _, tg, timg = lrt.render_grad(ts, params, loss[2], spp=spp, seed=seed,
                                  **kw)
    return (np.asarray(jg[key]), np.asarray(jimg)), \
        (tg[key].numpy(), timg.numpy())


def _assert_grads_equal(g, ref):
    assert np.isfinite(g).all() and np.abs(ref).max() > 0
    np.testing.assert_allclose(g, ref, rtol=0,
                               atol=G_ATOL_REL * np.abs(ref).max())


# ---------------------------------------------------------------------------
# one bounce
# ---------------------------------------------------------------------------

def _to_port_state(jst) -> tpath.PathState:
    """The JAX PathState's lanes as the port's (numpy in between)."""
    def t(x):
        a = np.asarray(x)
        return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "ui"
                                else a.copy())
    smp = jst.sampler
    return tpath.PathState(
        active=t(jst.active), depth=t(jst.depth), ray_o=t(jst.ray_o),
        ray_d=t(jst.ray_d), L=t(jst.L), throughput=t(jst.throughput),
        eta=t(jst.eta), prev_p=t(jst.prev_p), prev_pdf=t(jst.prev_pdf),
        prev_smooth=t(jst.prev_smooth),
        sampler=TSampler(seed=t(smp.seed), dim=t(smp.dim), samp=t(smp.samp),
                         pix=t(smp.pix)),
        valid=t(jst.valid))


def _assert_states_equal(tst, jst):
    for k in ("active", "depth", "valid", "prev_smooth"):
        np.testing.assert_array_equal(getattr(tst, k).numpy(),
                                      np.asarray(getattr(jst, k)), err_msg=k)
    np.testing.assert_array_equal(tst.sampler.dim.numpy(),
                                  np.asarray(jst.sampler.dim))
    for k in ("ray_o", "ray_d", "L", "throughput", "eta", "prev_p",
              "prev_pdf"):
        np.testing.assert_allclose(getattr(tst, k).numpy(),
                                   np.asarray(getattr(jst, k)), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def cornell_lanes():
    """The Cornell box (textures under a blend of a diffuse and a rough
    conductor on the large box, so the bounce reaches a glossy lobe) and
    the JAX lane state after one bounce of 1,024 camera lanes."""
    dicts = []
    for d in (lr.cornell_box(), tcornell.cornell_box()):
        d["sensor"]["film"].update(width=32, height=32)
        d["large-box"]["bsdf"] = {
            "type": "blendbsdf", "weight": 0.5,
            "a": {"type": "diffuse"},
            "b": {"type": "roughconductor", "alpha": 0.2, "material": "Au"}}
        dicts.append(d)
    js, ts = lr.load_dict(dicts[0]), lrt.load_dict(dicts[1], device="cpu")
    st, _ = jregen._make_lanes(js, jnp.arange(1024, dtype=jnp.uint32), 0,
                               4)
    st1 = jax.jit(lambda s, x: jpath.bounce(s, x, False))(js, st)
    return js, ts, st, st1


@pytest.mark.parametrize("ad", [False, True], ids=["primal", "ad"])
def test_path_bounce_matches_jax(cornell_lanes, ad):
    """The camera lanes' first bounce, made by each package from its own
    lane seeding, and a second bounce on the identical state."""
    js, ts, st0, st1 = cornell_lanes
    tst0, _ = tregen._make_lanes(ts, torch.arange(1024), 0, 4)
    _assert_states_equal(tst0, st0)
    f = jax.jit(lambda s, x: jpath.bounce(s, x, ad))
    _assert_states_equal(tpath.bounce(ts, tst0, ad), f(js, st0))
    jst2 = f(js, st1)
    tst2 = tpath.bounce(ts, _to_port_state(st1), ad)
    _assert_states_equal(tst2, jst2)
    assert bool(tst2.active.any()) and bool((tst2.L > 0).any())


# ---------------------------------------------------------------------------
# images
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rfilter", ["gaussian", "box"])
def test_cornell_box_matches_jax_per_pixel(rfilter):
    """BASELINE's Cornell box (path, depth 8): its own gaussian filter on
    the fixed wavefront, a box filter on the regenerating one."""
    js, ts = _cornell(16, rfilter)
    assert tregen.regen_applicable(ts, "primal") == (rfilter == "box") \
        == jregen.regen_applicable(js, "primal")
    ref = np.asarray(lr.render(js, spp=4, seed=0))
    img = lrt.render(ts, spp=4, seed=0).numpy()
    _assert_images_equal(img, ref)
    assert img.mean() > 0.1


@pytest.mark.parametrize("integrator", ["direct", "prb"])
def test_plane_integrators_match_jax_per_pixel(integrator):
    """`direct` on the regenerating wavefront (its lane cap is max_depth)
    and `prb` on the fixed one, on the gradient tests' plane with a rough
    plastic under the area light."""
    js, ts = _pair(tcornell.plane_light_dict(
        12, integrator=integrator, max_depth=3,
        bsdf={"type": "roughplastic", "alpha": 0.2}))
    ref = np.asarray(lr.render(js, spp=4, seed=1))
    img = lrt.render(ts, spp=4, seed=1).numpy()
    _assert_images_equal(img, ref)
    assert img.mean() > 1e-2


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(_CONFIGS))
def test_ad_config_grad_matches_jax(name):
    """render_grad of mean(image) on tests/test_ad_configs.py's plane
    scene (path, depth 3, 12x12, box filter) through the replay adjoint,
    in both packages."""
    kw, key = _CONFIGS[name]
    js, ts = _pair(tcornell.plane_light_dict(12, integrator="path",
                                             max_depth=3, **kw))
    from liverrenderer_tpu_torch.integrators.prb_replay import \
        replay_applicable
    assert replay_applicable(ts, {key: None}, 8)
    (ref, jimg), (g, timg) = _grads(js, ts, key, spp=8)
    _assert_grads_equal(g, ref)
    _assert_images_equal(timg, jimg)
