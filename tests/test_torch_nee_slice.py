"""Next-event estimation as a whole: the port's images and gradients
against the JAX package's on the CPU, on the fog Cornell box (surface NEE
through the Beer-Lambert shadow branch), the fog-cube plane scene (the
ratio-tracked shadow walk and medium NEE) and a point-light plane scene.

Tolerances (those of test_torch_render.py).  Both packages draw
bit-identical random numbers and run the same fp32 formulas, so paths
agree lane by lane; a path can still diverge where an ulp-level difference
(XLA's and PyTorch's log/exp/sin, or a sum taken in another order) flips a
discrete decision: a BSDF or roulette test, the null/real collision test,
or a hit on a shared triangle edge.  A flipped path moves its pixel by a
whole sample's worth.  Hence images: >= 99 % of pixels within rtol 1e-3 /
atol 1e-4, and the image mean within 1e-3 relative.  Gradients: within
3e-6 of the largest entry (the order of the per-lane sums differs).
Measured on these scenes: every pixel equal, gradients within 4e-7 of the
largest entry.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import liverrenderer_tpu as lr
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.bridge import params_from_numpy
from liverrenderer_tpu_torch.scene import cornell as tcornell
from torch_threads import torch_threads_per_worker  # noqa: F401

PIX_RTOL, PIX_ATOL, PIX_FRAC, MEAN_RTOL = 1e-3, 1e-4, 0.99, 1e-3
G_ATOL_REL = 3e-6

POINT = {"type": "point", "position": [0.5, 0.5, 1.5],
         "intensity": {"type": "rgb", "value": [6.0] * 3}}


def _fog_cornell(res, max_depth=6):
    """(JAX scene, port scene): each package's own cornell_box() in the
    fog of BASELINE's cornell_box_1080x1080_fog_st_albedo."""
    return (lr.load_dict(tcornell.fog_cornell_box(res, max_depth=max_depth,
                                                  cornell=lr.cornell_box)),
            lrt.load_dict(tcornell.fog_cornell_box(res, max_depth=max_depth),
                          device="cpu"))


def _pair(d):
    return lr.load_dict(d), lrt.load_dict(d, device="cpu")


def _assert_images_agree(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.abs(img - ref) <= PIX_ATOL + PIX_RTOL * np.abs(ref)
    assert close.all(-1).mean() >= PIX_FRAC
    assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())


@pytest.mark.parametrize("kind,spp", [
    ("fog_cornell", 4), ("fog_cube", 8), ("point_light", 8)])
def test_nee_render_matches_jax_per_pixel(kind, spp):
    if kind == "fog_cornell":
        js, ts = _fog_cornell(24)
    elif kind == "fog_cube":
        js, ts = _pair(tcornell.plane_light_dict(12, fog_cube=True))
    else:
        js, ts = _pair(tcornell.plane_light_dict(12, light=POINT))
    assert ts.needs_surface_nee
    assert ts.needs_medium_nee == (kind == "fog_cube")
    ref = np.asarray(lr.render(js, spp=spp, seed=0))
    img = lrt.render(ts, spp=spp, seed=0).numpy()
    _assert_images_agree(img, ref)
    assert img.mean() > 1e-3


@pytest.mark.parametrize("kind,key,spp", [
    ("fog_cornell", "media.params", 4), ("fog_cube", "media.params", 16),
    ("area_light", "emitters.params", 8),
    ("point_light", "emitters.params", 8)])
def test_nee_render_grad_matches_jax(kind, key, spp):
    """render_grad of mean(image) through the replay adjoint: the stored
    forward walks NEE shadow paths unbounded, the replay bounded at
    max_depth steps, in both packages."""
    if kind == "fog_cornell":
        js, ts = _fog_cornell(12)
    elif kind == "point_light":
        js, ts = _pair(tcornell.plane_light_dict(8, light=POINT))
    else:
        # the fog cube's walk is the file's longest: a 6 x 6 film keeps its
        # 16 spp (576 paths) inside the suite's time
        js, ts = _pair(tcornell.plane_light_dict(
            6 if kind == "fog_cube" else 8, fog_cube=kind == "fog_cube"))
    _, jg, jimg = lr.render_grad(js, {key: lr.traverse(js)[key]},
                                 lambda im: jnp.mean(im), spp=spp, seed=0)
    ref = np.asarray(jg[key])
    params = params_from_numpy({key: np.asarray(lr.traverse(js)[key])},
                               "cpu")
    _, tg, timg = lrt.render_grad(ts, params, lambda im: im.mean(), spp=spp,
                                  seed=0)
    g = tg[key].numpy()
    assert np.isfinite(g).all() and np.abs(ref).max() > 0
    np.testing.assert_allclose(g, ref, rtol=0,
                               atol=G_ATOL_REL * np.abs(ref).max())
    _assert_images_agree(timg.numpy(), np.asarray(jimg))
    if key == "media.params":
        # more fog darkens the image: d mean / d sigma_t < 0
        assert g[0, 0:3].sum() < 0
    else:
        # the light's radiance (area) or intensity (point) brightens it
        row = g[ts.emitters.count - 1]
        assert (row[0:3] if kind == "area_light" else row[3:6]).sum() > 0


def test_walk_scene_scan_adjoint_matches_replay():
    """The scan adjoint (every bounce and its NEE walk bounded at max_depth
    under an activation checkpoint) against the replay adjoint on the
    fog-cube scene: the same paths but for walks longer than max_depth
    steps, so the port's own tolerance of the two adjoints holds (cosine
    > 0.999, norms within 2 %, as tests/test_torch_grad_slice.py)."""
    ts = lrt.load_dict(tcornell.plane_light_dict(8, fog_cube=True),
                       device="cpu")

    def grad(replay):
        _, g, img = lrt.render_grad(ts, {"media.params": ts.media.params},
                                    lambda im: im.mean(), spp=4, seed=2,
                                    replay=replay)
        return g["media.params"].numpy().ravel(), img.numpy()

    (g_r, img_r), (g_s, img_s) = grad(True), grad(False)
    assert np.isfinite(g_s).all() and np.abs(g_s).max() > 0
    cos = (g_r * g_s).sum() / (np.linalg.norm(g_r) * np.linalg.norm(g_s))
    assert cos > 0.999, cos
    np.testing.assert_allclose(np.linalg.norm(g_s), np.linalg.norm(g_r),
                               rtol=0.02)
    _assert_images_agree(img_s, img_r)


def test_fog_direct_transmission_beer_lambert():
    """The port's own lamp check (as tests/test_fog_golden.py): the lamp
    seen through a purely absorbing fog is L_e exp(-sigma d); compares the
    fogged and fog-free renders of the same lamp pixels (no scattering:
    each sample of a lamp pixel carries L_e exp(-sigma d) exactly, so 4 spp
    suffice)."""
    sigma = 0.3
    clear_d = tcornell.cornell_box()
    clear_d["integrator"] = {"type": "volpath", "max_depth": 2}
    clear_d["sensor"]["film"] = {"type": "hdrfilm", "width": 64,
                                 "height": 64, "rfilter": {"type": "box"}}
    clear = lrt.load_dict(clear_d, device="cpu")
    foggy = lrt.load_dict(tcornell.fog_cornell_box(
        64, sigma=sigma, albedo=0.0, scale=1.0, max_depth=2), device="cpu")
    img_c = lrt.render(clear, spp=4, seed=0).numpy()
    img_f = lrt.render(foggy, spp=4, seed=0).numpy()
    # lamp pixels (top centre); camera at z = 3.9, lamp at y = 0.99 with z
    # in [-0.23, 0.16]: the path length spreads a little over the lamp
    ratio = (img_f[8:11, 28:36].mean((0, 1))
             / img_c[8:11, 28:36].mean((0, 1))).mean()
    assert np.exp(-sigma * 4.3) * 0.9 < ratio < np.exp(-sigma * 3.7) * 1.1
