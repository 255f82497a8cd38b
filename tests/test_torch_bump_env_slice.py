"""Bump mapping, bitmap textures and the envmap as a whole: the port's
images and gradients against the JAX package's on the CPU, on the bumped,
sky-lit liver proxy (bench.py's workload path: biovolpath, depth 12, a
height map on the dielectric, an envmap), on an envmap-lit plane (NEE
through the envmap's 2-D importance map), and on bumped and normal-mapped
planes under a point light.

Tolerances (those of tests/test_torch_nee_slice.py): images >= 99 % of
pixels within rtol 1e-3 / atol 1e-4 and means within 1e-3 relative;
gradients within 3e-6 of the largest entry.  Scenes whose envmap is
sampled by NEE run on the JAX-built tables through the bridge: the two
builders sum its CDF in another order (tests/test_torch_texture.py).
Measured: every pixel within tolerance (bit-identical: 34 % of the
bumped proxy's, 19 % of the env-lit plane's, 13 % and 10 % of the bumped
and normal-mapped planes'; XLA's and PyTorch's atan2, acos, sqrt and sums
differ by ulps), gradients within 4e-7 of the largest entry.

The bump frame is discontinuous across texel edges (the derivative of the
bilinear height patch jumps there), so where the two packages' hit uv
differ by an ulp at an edge, a normal tilts by a finite step and the path
bends a little: on the bumped proxy at 16 x 12, 4 spp, seed 0 moves three
pixels by up to 2.2e-4 and the media.params gradient by 2.7e-5 of its
largest entry.  Its gradient tests run seed 1 (every pixel within 1.3e-6,
the gradient within 1.7e-7); the image test keeps seed 0.

The render_grad tests run from tests/test_torch_bump_env_grad.py, which
shares this file's scenes and tolerances, so that xdist's file scheduler
can start them apart from this file (a long file holds one worker to its
end).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import liverrenderer_tpu as lr
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.bridge import numpy_tree, scene_from_numpy
from liverrenderer_tpu_torch.scene import cornell as tcornell
from liverrenderer_tpu_torch.scene.liver_proxy import (height_map,
                                                       liver_proxy_dict,
                                                       sky_map)
from torch_threads import torch_threads_per_worker  # noqa: F401

PIX_RTOL, PIX_ATOL, PIX_FRAC, MEAN_RTOL = 1e-3, 1e-4, 0.99, 1e-3
G_ATOL_REL = 3e-6

POINT = {"type": "point", "position": [0.5, 0.5, 1.5],
         "intensity": {"type": "rgb", "value": [6.0] * 3}}


def _sky(w=32, h=16):
    return {"type": "envmap", "data": sky_map(w, h), "scale": 1.25}


def _bumped(bsdf, res=16, normal=False):
    if normal:
        rng = np.random.default_rng(5)
        n = np.concatenate([rng.normal(0, 0.4, (res, res, 2)),
                            np.ones((res, res, 1))], -1)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        return {"type": "normalmap", "bsdf": bsdf,
                "normalmap": {"type": "bitmap",
                              "data": (0.5 * n + 0.5).astype(np.float32)}}
    return {"type": "bumpmap", "scale": 0.2, "bsdf": bsdf,
            "texture": {"type": "bitmap", "data": height_map(res, 2)}}


def _scene_dict(kind, res=12):
    if kind == "bump_sky_proxy":
        return liver_proxy_dict(16, 12, 4, 2, 0, bump=(32, 0.05),
                                sky=(64, 32))
    if kind == "env_nee_plane":
        return tcornell.plane_light_dict(res, light=_sky())
    if kind == "bump_sky_plane":
        d = tcornell.plane_light_dict(res, light=_sky())
        d["plane"]["bsdf"] = _bumped(d["plane"]["bsdf"])
        return d
    d = tcornell.plane_light_dict(res, light=POINT)
    d["plane"]["bsdf"] = _bumped(d["plane"]["bsdf"],
                                 normal=kind == "normalmap_point_plane")
    return d


def _pair(kind, res=12):
    """(JAX scene, port scene): NEE on the envmap runs the port on the
    JAX-built tables, the others each package's own build."""
    d = _scene_dict(kind, res)
    js = lr.load_dict(d)
    if kind in ("env_nee_plane", "bump_sky_plane"):
        return js, scene_from_numpy(*numpy_tree(js), "cpu")
    return js, lrt.load_dict(d, device="cpu")


def _assert_images_agree(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.abs(img - ref) <= PIX_ATOL + PIX_RTOL * np.abs(ref)
    assert close.all(-1).mean() >= PIX_FRAC
    assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())


@pytest.mark.parametrize("kind,spp", [
    ("bump_sky_proxy", 4), ("env_nee_plane", 8),
    ("bump_point_plane", 8), ("normalmap_point_plane", 8)])
def test_bump_env_render_matches_jax_per_pixel(kind, spp):
    js, ts = _pair(kind)
    assert ts.has_bump == (kind != "env_nee_plane")
    assert (ts.emitters.env_index >= 0) == ("sky" in kind or "env" in kind)
    # the liver is delta-only (no NEE); the planes sample their lights
    assert ts.needs_surface_nee == (kind != "bump_sky_proxy")
    ref = np.asarray(lr.render(js, spp=spp, seed=0))
    img = lrt.render(ts, spp=spp, seed=0).numpy()
    _assert_images_agree(img, ref)
    assert img.mean() > 1e-2
    # shown with pytest -s: ulps apart, few pixels are bit-identical
    print(f"{kind}: pixels exactly equal "
          f"{(img == ref).all(-1).mean():.4f}, largest |difference| "
          f"{np.abs(img - ref).max():.3g}")


@pytest.mark.parametrize("quads", [True, False], ids=["quads", "four_tap"])
def test_bitmaps_gradient_matches_jax(quads):
    """The textures.bitmaps key on a bumped plane under the sky (a height
    map and the envmap in one padded stack).  With quads the taps read
    `quads`, so the gradient is exactly zero in both packages; the four-tap
    path (forced) reads `bitmaps`, and the port's gradient equals JAX's."""
    js, ts = _pair("bump_sky_plane", res=8)
    if not quads:
        js = js.replace(textures=js.textures.replace(has_quads=False))
        ts = ts.replace(textures=ts.textures.replace(has_quads=False))
    key = "textures.bitmaps"
    _, jg, _ = lr.render_grad(js, {key: lr.traverse(js)[key]},
                              lambda im: jnp.mean(im), spp=4, seed=0)
    ref = np.asarray(jg[key])
    _, tg, _ = lrt.render_grad(ts, {key: ts.textures.bitmaps},
                               lambda im: im.mean(), spp=4, seed=0)
    g = tg[key].numpy()
    assert g.shape == ref.shape == tuple(ts.textures.bitmaps.shape)
    if quads:
        assert not ref.any() and not g.any()
        return
    assert np.isfinite(g).all() and np.abs(ref[0]).max() > 0 \
        and np.abs(ref[1]).max() > 0
    np.testing.assert_allclose(g, ref, rtol=0,
                               atol=G_ATOL_REL * np.abs(ref).max())
