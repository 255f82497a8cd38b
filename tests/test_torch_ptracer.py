"""The adjoint light tracer: the port's `render_ptracer` and its pieces
against the JAX package's on the CPU, on the tiny Cornell box and on
tests/test_components.py's plane under infinite emitters
(tests/torch_m10_scenes.py).

Tolerances: the pieces within 3e-5 relative / 5e-5 absolute on seeded
lanes (the same fp32 formulas and random numbers; XLA's and PyTorch's
sin and cos differ by ulps, which the cosine warp's sqrt(1 - r^2)
amplifies near the hemisphere's rim, 1.7e-5 on one component of 4,096
directions, and the envmap's pdf through sin(theta), 1.1e-5 relative on
two of its weights); images those of
test_torch_nee_slice.py: >= 99 % of pixels within rtol 1e-3 / atol 1e-4,
the mean within 1e-3 relative (the splat's scatter-add sums in another
order).  Measured: every pixel within 2e-7 of the JAX package's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
import liverrenderer_tpu_torch as lrt
import torch_m10_scenes as ms
from liverrenderer_tpu.core.rng import make_sampler as jmake_sampler
from liverrenderer_tpu.integrators import ptracer as jpt
from liverrenderer_tpu_torch.bridge import numpy_tree, scene_from_numpy
from liverrenderer_tpu_torch.core.rng import make_sampler as tmake_sampler
from liverrenderer_tpu_torch.integrators import ptracer as tpt
from liverrenderer_tpu_torch.scene import cornell as tcornell
from torch_threads import torch_threads_per_worker  # noqa: F401

PIX_RTOL, PIX_ATOL, PIX_FRAC, MEAN_RTOL = 1e-3, 1e-4, 0.99, 1e-3
FN_RTOL, FN_ATOL = 3e-5, 5e-5


def _cornell(res=16, cornell=tcornell.cornell_box):
    d = cornell()
    d["sensor"]["film"]["width"] = res
    d["sensor"]["film"]["height"] = res
    return d


def _envmap():
    """A 16 x 32 sky: a horizon-to-zenith ramp and a bright patch."""
    v = np.linspace(0.2, 1.0, 16, dtype=np.float32)[:, None, None]
    img = np.broadcast_to(v * np.float32([0.6, 0.7, 1.0]), (16, 32, 3)).copy()
    img[3:5, 10:13] = 20.0
    return {"sky": {"type": "envmap", "data": img}}


def _scene_dict(kind):
    if kind == "cornell":
        return _cornell()
    if kind == "envmap":
        return ms.plane_light_dict(_envmap(), res=12)
    return ms.plane_light_dict(ms.INFINITE_EMITTERS[kind], res=12)


def _pair(kind):
    d = _scene_dict(kind)
    jd = _cornell(cornell=lr.cornell_box) if kind == "cornell" else d
    js = lr.load_dict(jd)
    if kind == "envmap":
        # the envmap's 2-D CDF is summed by numpy in the port and by XLA
        # in the JAX package, a few ulps apart: the port runs on the
        # JAX-built tables (as test_torch_bump_env_slice.py's NEE tests)
        return js, scene_from_numpy(*numpy_tree(js), "cpu")
    return js, lrt.load_dict(d, device="cpu")


def _assert_images_agree(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.abs(img - ref) <= PIX_ATOL + PIX_RTOL * np.abs(ref)
    assert close.all(-1).mean() >= PIX_FRAC
    assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())


@pytest.mark.parametrize("kind", ["cornell", "constant", "directional",
                                  "envmap"])
def test_sample_emitter_ray_matches_jax(kind):
    """The emitted rays (position, direction, power / pdf, normal) and the
    sampler's dimension after the draws, lane by lane."""
    js, ts = _pair(kind)
    lane = np.arange(4096, dtype=np.uint32)
    jout = jpt._sample_emitter_ray(js, jmake_sampler(jnp.asarray(lane), 0,
                                                     5))
    tout = tpt._sample_emitter_ray(ts, tmake_sampler(
        torch.from_numpy(lane.astype(np.int64)), 0, 5))
    for a, b in zip(jout[:4], tout[:4]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=FN_RTOL,
                                   atol=FN_ATOL)
    assert int(tout[4].dim[0]) == int(np.asarray(jout[4].dim)[0])


def test_film_projection_and_importance_match_jax():
    js, ts = _pair("cornell")
    rng = np.random.default_rng(3)
    p = rng.uniform(-1.2, 1.2, (2048, 3)).astype(np.float32)
    p[:, 2] = rng.uniform(-1.5, 4.5, 2048)       # some behind the camera
    jpos, jdir, jok = jpt.project_to_film(js, jnp.asarray(p))
    tpos, tdir, tok = tpt.project_to_film(ts, torch.from_numpy(p))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    ok = np.asarray(jok)
    assert ok.sum() > 200
    np.testing.assert_allclose(tpos.numpy()[ok], np.asarray(jpos)[ok],
                               rtol=FN_RTOL, atol=1e-4)
    np.testing.assert_allclose(tdir.numpy(), np.asarray(jdir), rtol=FN_RTOL,
                               atol=FN_ATOL)
    d = np.array(jdir)
    np.testing.assert_allclose(
        tpt._importance(ts, torch.from_numpy(d)).numpy(),
        np.asarray(jpt._importance(js, jnp.asarray(d))), rtol=FN_RTOL)


@pytest.mark.parametrize("kind", ["cornell", "constant", "directional",
                                  "envmap"])
def test_render_ptracer_matches_jax_per_pixel(kind):
    js, ts = _pair(kind)
    ref = np.asarray(lr.render_ptracer(js, spp=16, seed=0))
    img = lrt.render_ptracer(ts, spp=16, seed=0).numpy()
    assert img.shape == ref.shape == (ts.film_h, ts.film_w, 3)
    _assert_images_agree(img, ref)
    assert img.mean() > 1e-3


def _lamp_only(res=8):
    """The camera sees an area light and nothing else."""
    d = ms.area_floor_dict(res=res, integrator="ptracer")
    del d["floor"]
    d["lamp"]["to_world"] = lrt.Transform().scale(0.5).matrix.copy()
    return d


def test_emitter_vertex_is_never_connected():
    """Both packages splat only scattered light: a camera that sees an
    area light and nothing else gets a black image."""
    d = _lamp_only()
    ref = np.asarray(lr.render_ptracer(lr.load_dict(d), spp=8))
    img = lrt.render_ptracer(lrt.load_dict(d, device="cpu"), spp=8).numpy()
    assert not ref.any() and not img.any()
    # the path tracer sees it
    assert lrt.render(lrt.load_dict(dict(
        d, integrator={"type": "path", "max_depth": 3}), device="cpu"),
        spp=2).mean() > 1.0


def test_unequal_emitter_triangles_follow_jax():
    """The emitting triangle is drawn uniformly by index while the weight
    uses the whole shape's area, in both packages: with a small and a
    large triangle the light tracer's estimate is biased, the same way in
    both."""
    d = ms.area_floor_dict(res=12, integrator="ptracer")
    d["lamp"] = {"type": "mesh",
                 "vertices": np.float32([[-0.1, -0.1, 3], [0.1, -0.1, 3],
                                         [-0.1, 0.1, 3], [0.5, 0.5, 3],
                                         [0.1, -0.1, 3], [-0.1, 0.1, 3]]),
                 "faces": np.int32([[0, 2, 1], [3, 4, 5]]),
                 "emitter": d["lamp"]["emitter"]}
    js, ts = lr.load_dict(d), lrt.load_dict(d, device="cpu")
    area = ts.shape_area[1].item()
    assert abs(area - (0.02 + 0.1)) < 1e-5      # 0.2^2 / 2 + 0.2 / 2
    ref = np.asarray(lr.render_ptracer(js, spp=16, seed=1))
    img = lrt.render_ptracer(ts, spp=16, seed=1).numpy()
    _assert_images_agree(img, ref)


def test_render_of_a_ptracer_scene_raises_as_jax():
    """render has no branch for ptracer in either package (render_ptracer
    renders it): the same ValueError."""
    d = _lamp_only(4)
    with pytest.raises(ValueError, match="unknown integrator ptracer"):
        lr.render(lr.load_dict(d), spp=1)
    with pytest.raises(ValueError, match="unknown integrator ptracer"):
        lrt.render(lrt.load_dict(d, device="cpu"), spp=1)
