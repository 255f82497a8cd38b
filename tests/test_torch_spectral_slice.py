"""The spectral variant as a whole: the port's images, binned spectral
films and gradients against the JAX package's on the CPU.

Scenes (the JAX package's tests/test_spectral.py and the port's main
path): the spectral Cornell box (path, depth 4: box filter on the regen
wavefront, gaussian on the fixed one), the spectral fog Cornell box
(volpath, surface NEE), the same fog under volpathmis (which the spectral
variant routes to volpath), the bio sphere (biovolpath in a
glissonCapsule), and the bumped, sky-lit liver proxy at 16 x 12
(biovolpath depth 12, a height map, an envmap: the main path).

Tolerances (those of tests/test_torch_nee_slice.py): images and specfilm
bins >= 99 % within rtol 1e-3 / atol 1e-4 and means within 1e-3
relative; gradients within 3e-6 of the largest entry.  Both packages draw
the same random numbers (the hero packet too) and run the same fp32
formulas, so paths agree lane by lane; an ulp-level difference can still
flip a discrete decision and move one pixel by a sample's worth.
Measured: every pixel and bin within tolerance, gradients within 6e-7 of
the largest entry.  The gradients run from two files of their own,
tests/test_torch_spectral_grad_replay.py and _scan.py (one adjoint
each), so that xdist's file scheduler can start them apart.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import liverrenderer_tpu as lr
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.bridge import params_from_numpy
from liverrenderer_tpu_torch.scene import cornell as tcornell
from liverrenderer_tpu_torch.scene.liver_proxy import liver_proxy_dict
from torch_threads import torch_threads_per_worker  # noqa: F401

PIX_RTOL, PIX_ATOL, PIX_FRAC, MEAN_RTOL = 1e-3, 1e-4, 0.99, 1e-3
G_ATOL_REL = 3e-6


def _cornell(cornell, res, rfilter="box"):
    d = cornell()
    d["integrator"] = {"type": "path", "max_depth": 4}
    d["sensor"]["film"] = {"type": "hdrfilm", "width": res, "height": res,
                           "rfilter": {"type": rfilter}}
    return d


def _fog(cornell, res, integrator="volpath"):
    d = tcornell.fog_cornell_box(res, max_depth=6, cornell=cornell)
    d["integrator"]["type"] = integrator
    return d


def _bio_sphere(transform, res=12):
    """tests/test_spectral.py's bio sphere: a dielectric sphere holding a
    glissonCapsule under a white environment."""
    return {
        "type": "scene",
        "integrator": {"type": "biovolpath", "max_depth": 6},
        "sensor": {"type": "perspective", "fov": 40.0,
                   "to_world": transform().look_at([0, 0, 4], [0, 0, 0],
                                                   [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": res, "height": res,
                            "rfilter": {"type": "box"}}},
        "blob": {"type": "sphere",
                 "bsdf": {"type": "dielectric", "int_ior": 1.36},
                 "interior": {
                     "type": "glissonCapsule",
                     "layer1Limit": 0.001, "layer2Limit": 0.002,
                     "layer3Limit": 0.003, "layer4Limit": 10.0,
                     "sigma_collagen1_R": 8.0, "sigma_collagen1_G": 10.0,
                     "sigma_collagen1_B": 12.0,
                     "sigma_elastin1_R": 2.0, "sigma_elastin1_G": 2.5,
                     "sigma_elastin1_B": 3.0}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [1.0] * 3}},
    }


def _proxy():
    return liver_proxy_dict(16, 12, 4, 2, 0, bump=(32, 0.05), sky=(64, 32))


def _pair(kind, res=None):
    """(JAX scene, port scene) of `kind`, both spectral."""
    if kind in ("cornell_regen", "cornell_fixed"):
        f = "box" if kind == "cornell_regen" else "gaussian"
        jd = _cornell(lr.cornell_box, res or 16, f)
        td = _cornell(tcornell.cornell_box, res or 16, f)
    elif kind in ("fog", "fog_volpathmis"):
        integ = "volpath" if kind == "fog" else "volpathmis"
        jd = _fog(lr.cornell_box, res or 16, integ)
        td = _fog(tcornell.cornell_box, res or 16, integ)
    elif kind == "bio_sphere":
        jd, td = _bio_sphere(lr.Transform), _bio_sphere(lrt.Transform)
    else:
        jd = td = _proxy()
    return (lr.load_dict(jd, variant="spectral"),
            lrt.load_dict(td, device="cpu", variant="spectral"))


def _assert_images_agree(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.abs(img - ref) <= PIX_ATOL + PIX_RTOL * np.abs(ref)
    assert close.all(-1).mean() >= PIX_FRAC
    assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())


@pytest.mark.parametrize("kind,spp", [
    ("cornell_regen", 8), ("cornell_fixed", 8), ("fog", 4),
    ("fog_volpathmis", 4), ("bio_sphere", 8), ("bump_sky_proxy", 4)])
def test_spectral_render_matches_jax_per_pixel(kind, spp):
    js, ts = _pair(kind)
    assert ts.spectral
    ref = np.asarray(lr.render(js, spp=spp, seed=0))
    img = lrt.render(ts, spp=spp, seed=0).numpy()
    _assert_images_agree(img, ref)
    assert img.mean() > 1e-3


def test_specfilm_matches_jax_per_bin():
    """render_specfilm of the spectral Cornell box, per (pixel, bin), and
    its energy against the spectral render's luminance (the JAX test's
    5 % gate)."""
    js, ts = _pair("cornell_regen")
    ref = np.asarray(lr.render_specfilm(js, n_bins=16, spp=8, seed=0))
    bins = lrt.render_specfilm(ts, n_bins=16, spp=8, seed=0).numpy()
    assert bins.shape == (16, 16, 16) and (bins >= 0).all()
    _assert_images_agree(bins, ref)
    from liverrenderer_tpu_torch.core import spectrum as tspec
    centers = tspec.SPEC_MIN + (np.arange(16) + 0.5) * (
        tspec.SPEC_MAX - tspec.SPEC_MIN) / 16
    Y = (bins * tspec.cie1931_xyz_bar(centers)[:, 1]).sum(-1) \
        / tspec._CIE_Y_INT
    lum = tspec.luminance(lrt.render(ts, spp=8, seed=0)).numpy()
    np.testing.assert_allclose(Y.mean(), lum.mean(), rtol=0.05)


def check_render_grad(kind, key, replay, spp, seed):
    """render_grad of mean(image) of `kind` in both packages (the split
    files tests/test_torch_spectral_grad_replay.py and _scan.py run it):
    every entry within G_ATOL_REL of the largest, images as above."""
    js, ts = _pair(kind, 8 if kind != "bump_sky_proxy" else None)
    _, jg, jimg = lr.render_grad(js, {key: lr.traverse(js)[key]},
                                 lambda im: jnp.mean(im), spp=spp, seed=seed,
                                 replay=replay)
    ref = np.asarray(jg[key])
    params = params_from_numpy({key: np.asarray(lr.traverse(js)[key])},
                               "cpu")
    _, tg, timg = lrt.render_grad(ts, params, lambda im: im.mean(), spp=spp,
                                  seed=seed, replay=replay)
    g = tg[key].numpy()
    assert np.isfinite(g).all() and np.abs(ref).max() > 0
    np.testing.assert_allclose(g, ref, rtol=0,
                               atol=G_ATOL_REL * np.abs(ref).max())
    _assert_images_agree(timg.numpy(), np.asarray(jimg))
