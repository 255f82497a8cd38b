"""Mesh-attribute and volume textures with the vertex attributes behind
them: the port against the JAX package on the CPU.

Tolerances: the builders' tables (vertex_attrs, the texture rows and the
volume grids) bit for bit; the attribute tap and the trilinear volume
tap per lane at rtol 1e-6 / atol 1e-7, and compute_si's interpolated
attribute at rtol 1e-5 / atol 1e-6 (XLA contracts the interpolation's
products and sums into FMAs, PyTorch does not); the scenes of
tests/test_components.py::test_mesh_attribute_texture and
::test_volume_texture per pixel (>= 99 % of pixels within rtol 1e-3 /
atol 1e-4, the means within 1e-3 relative) and their textures.data
gradients (the volume texture's scale, the attribute's scale) within
3e-6 of the largest entry.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu.accel import intersect as jint
from liverrenderer_tpu.core.types import Ray as JRay
from liverrenderer_tpu.texture import eval as jtex
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.accel import intersect as tint
from liverrenderer_tpu_torch.bridge import numpy_tree, params_from_numpy
from liverrenderer_tpu_torch.core.types import Ray as TRay
from liverrenderer_tpu_torch.scene import ir
from liverrenderer_tpu_torch.texture import eval as ttex
from torch_m10_scenes import attr_quad_dict, volume_wall_dict
from torch_threads import torch_threads_per_worker  # noqa: F401

PIX_RTOL, PIX_ATOL, PIX_FRAC, MEAN_RTOL = 1e-3, 1e-4, 0.99, 1e-3
G_ATOL_REL = 3e-6
N = 4096

_SCENES = {"mesh_attribute": attr_quad_dict, "volume": volume_wall_dict}


def _grid_scene():
    """The volume wall with a seeded 5 x 6 x 7 grid under a to_world."""
    rng = np.random.default_rng(3)
    d = volume_wall_dict(8, grid=rng.uniform(0, 1, (5, 6, 7, 3))
                         .astype(np.float32), scale=0.8)
    d["wall"]["bsdf"]["reflectance"]["to_world"] = np.diag(
        [1.2, 1.1, 0.5, 1.0]).astype(np.float32)
    return d


@pytest.mark.parametrize("kind", ["mesh_attribute", "volume", "grid"])
def test_builders_pack_the_same_tables(kind):
    d = _grid_scene() if kind == "grid" else _SCENES[kind](8)
    ja, js = numpy_tree(lr.load_dict(d))
    ta, ts = numpy_tree(lrt.load_dict(d, device="cpu"))
    for k in ("vertex_attrs", "textures.ttype", "textures.data",
              "textures.bitmap_id", "textures.vgrids", "textures.vgrid_whd",
              "textures.vgrid_to_local", "tri_si"):
        np.testing.assert_array_equal(ta[k], np.asarray(ja[k]), err_msg=k)
    assert ts["has_vertex_attr"] == js["has_vertex_attr"] \
        == (kind == "mesh_attribute")
    assert ts["textures.types_present"] == tuple(js["textures.types_present"])


def test_texture_taps_match_jax_per_lane():
    """eval_texture over seeded lanes that pick each texture of a scene
    holding both families, with p and attr given: per lane."""
    d = _grid_scene()
    d["quad"] = attr_quad_dict(8)["quad"]
    js = lr.load_dict(d)
    ts = lrt.load_dict(d, device="cpu")
    assert {ir.TEX_MESHATTR, ir.TEX_VOLUME} <= set(
        ts.textures.types_present)
    rng = np.random.default_rng(0)
    n_tex = int(ts.textures.ttype.shape[0])
    idx = rng.integers(-1, n_tex, N)
    uv = rng.uniform(size=(N, 2)).astype(np.float32)
    p = rng.uniform(-0.3, 1.3, (N, 3)).astype(np.float32)
    attr = rng.uniform(size=(N, 3)).astype(np.float32)
    ref = np.asarray(jtex.eval_texture(js.textures, jnp.asarray(idx),
                                       jnp.asarray(uv), p=jnp.asarray(p),
                                       attr=jnp.asarray(attr)))
    out = ttex.eval_texture(ts.textures, torch.from_numpy(idx),
                            torch.from_numpy(uv), p=torch.from_numpy(p),
                            attr=torch.from_numpy(attr)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    ttype = ts.textures.ttype.numpy()[np.maximum(idx, 0)]
    for code in (ir.TEX_MESHATTR, ir.TEX_VOLUME):
        assert ((ttype == code) & (idx >= 0)).sum() > N // (2 * n_tex)
    # without p and attr both packages read the two families as white
    ref = np.asarray(jtex.eval_texture(js.textures, jnp.asarray(idx),
                                       jnp.asarray(uv)))
    out = ttex.eval_texture(ts.textures, torch.from_numpy(idx),
                            torch.from_numpy(uv)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_compute_si_interpolates_vertex_attributes():
    """compute_si's attr on rays at the vertex-coloured quad, per lane."""
    d = attr_quad_dict(8)
    js = lr.load_dict(d)
    ts = lrt.load_dict(d, device="cpu")
    rng = np.random.default_rng(1)
    o = np.tile(np.float32([[0.0, 0.0, 2.5]]), (N, 1))
    tgt = np.concatenate([rng.uniform(-1.2, 1.2, (N, 2)),
                          np.zeros((N, 1))], -1).astype(np.float32)
    dd = (tgt - o) / np.linalg.norm(tgt - o, axis=-1, keepdims=True)
    mx = np.full(N, np.inf, np.float32)
    a = jint.ray_intersect(js, JRay(o=jnp.asarray(o), d=jnp.asarray(dd),
                                    maxt=jnp.asarray(mx)))
    b = tint.ray_intersect(ts, TRay(o=torch.from_numpy(o),
                                    d=torch.from_numpy(dd),
                                    maxt=torch.from_numpy(mx)))
    hit = np.isfinite(np.asarray(a.t))
    np.testing.assert_array_equal(hit, b.valid.numpy())
    assert hit.mean() > 0.5
    np.testing.assert_allclose(b.attr.numpy()[hit], np.asarray(a.attr)[hit],
                               rtol=1e-5, atol=1e-6)
    # a scene without vertex attributes carries none
    assert tint.ray_intersect(lrt.load_dict(volume_wall_dict(4),
                                            device="cpu"),
                              TRay(o=torch.from_numpy(o[:4]),
                                   d=torch.from_numpy(dd[:4]),
                                   maxt=torch.from_numpy(mx[:4]))
                              ).attr is None


def _assert_images_agree(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.abs(img - ref) <= PIX_ATOL + PIX_RTOL * np.abs(ref)
    assert close.all(-1).mean() >= PIX_FRAC
    assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())


@pytest.mark.parametrize("kind", ["mesh_attribute", "volume"])
def test_textured_scene_render_and_grad_match_jax(kind):
    """tests/test_components.py's scene at 16^2, 16 spp: render_grad of
    mean(image) with respect to textures.data (the scene's texture rows:
    the attribute's or the grid's scale) through the replay adjoint; the
    image per pixel, with the JAX test's colour checks, and the gradient
    per entry."""
    d = _SCENES[kind](16)
    js = lr.load_dict(d)
    ts = lrt.load_dict(d, device="cpu")
    key = "textures.data"
    _, jg, jimg = lr.render_grad(js, {key: lr.traverse(js)[key]},
                                 lambda im: jnp.mean(im), spp=16, seed=0)
    params = params_from_numpy({key: np.asarray(lr.traverse(js)[key])},
                               "cpu")
    _, tg, timg = lrt.render_grad(ts, params, lambda im: im.mean(), spp=16,
                                  seed=0)
    img = timg.numpy()
    _assert_images_agree(img, np.asarray(jimg))
    if kind == "mesh_attribute":
        # world bottom-left (red) at the bottom rows, bottom-right green
        assert img[13, 2, 0] > 2 * img[13, 2, 2]
        assert img[13, 13, 1] > 2 * img[13, 13, 2]
    else:
        assert img[8, 4, 0] > 2 * img[8, 4, 1]           # the red half
        assert img[8, 12, 1] > 0.5 * img[8, 12, 0]       # the yellow half
    ref = np.asarray(jg[key])
    g = tg[key].numpy()
    row = int(np.flatnonzero(ts.textures.ttype.numpy() == (
        ir.TEX_MESHATTR if kind == "mesh_attribute" else ir.TEX_VOLUME))[0])
    assert np.abs(ref[row, 0:3]).max() > 0
    np.testing.assert_allclose(g, ref, rtol=0,
                               atol=G_ATOL_REL * np.abs(ref).max())


@pytest.mark.parametrize("slot", ["emitter", "bumpmap"])
def test_textures_outside_bsdf_slots_are_refused(slot):
    """A mesh-attribute or volume texture where the JAX package evaluates
    it without the interaction (an emitter's radiance, a bump map), and
    so as white, is refused at load."""
    d = attr_quad_dict(4)
    if slot == "emitter":
        d["quad"]["emitter"] = {"type": "area",
                                "radiance": {"type": "mesh_attribute"}}
    else:
        d["quad"]["bsdf"] = {"type": "bumpmap",
                             "texture": {"type": "volume",
                                         "data": np.ones((2, 2, 2, 1),
                                                         np.float32)},
                             "bsdf": {"type": "diffuse"}}
    with pytest.raises(ValueError, match="not evaluated at the interaction"):
        lrt.load_dict(d, device="cpu")
