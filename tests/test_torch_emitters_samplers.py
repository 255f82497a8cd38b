"""The directional, spot and projector emitters, the pattern samplers
(stratified, multijitter, orthogonal, ldsampler) and the mitchell,
catmullrom and lanczos filters: the port against the JAX package on the
CPU, on identical inputs made with numpy from a seed.

Tolerances: emitter samples fp32, rtol 1e-5 with atol 1e-6 (discrete
outcomes equal); sampler streams bit-exact (the uint32 words and every
float drawn from them); filter weights rtol 1e-6 with atol 1e-7 (fp32
polynomials and sines, a few ulps); images those of
tests/test_torch_nee_slice.py (>= 99 % of pixels within rtol 1e-3 / atol
1e-4, means within 1e-3 relative; measured: every pixel within 3e-7), and
the scan adjoint's gradient within 4e-7 of its largest entry.

The scan adjoint's gradient runs from tests/test_torch_filter_grad.py,
which shares this file's scenes and tolerances, so that xdist's file
scheduler can start it apart from this file (a long file holds one
worker to its end).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu import film as jfilm
from liverrenderer_tpu.core import rng as jrng
from liverrenderer_tpu.emitter import dispatch as jem
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch import film as tfilm
from liverrenderer_tpu_torch.bridge import numpy_tree
from liverrenderer_tpu_torch.core import rng as trng
from liverrenderer_tpu_torch.emitter import dispatch as tem
from liverrenderer_tpu_torch.scene import cornell as tcornell
from liverrenderer_tpu_torch.scene.ir import (EMITTER_DIRECTIONAL,
                                              EMITTER_PROJECTOR, EMITTER_SPOT,
                                              FILTER_CATMULLROM,
                                              FILTER_LANCZOS, FILTER_MITCHELL)
from liverrenderer_tpu_torch.scene.transform import Transform
from torch_threads import torch_threads_per_worker  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
N = 4096
PIX_RTOL, PIX_ATOL, PIX_FRAC, MEAN_RTOL = 1e-3, 1e-4, 0.99, 1e-3
G_ATOL_REL = 4e-7
KINDS = ("stratified", "multijitter", "orthogonal", "ldsampler")

# a light above the plane, pointing down at it
_DOWN = Transform().translate([0.0, 0.0, 1.5]).rotate([1, 0, 0], 180) \
    .matrix.copy()


def _projector_image():
    return np.random.default_rng(3).uniform(0.0, 1.0, (8, 8, 3)) \
        .astype(np.float32)


LIGHTS = {
    "directional": {"type": "directional", "direction": [0.2, -0.3, -1.0],
                    "irradiance": {"type": "rgb", "value": [3.0, 2.5, 2.0]}},
    "spot": {"type": "spot", "to_world": _DOWN, "cutoff_angle": 30.0,
             "beam_width": 18.0,
             "intensity": {"type": "rgb", "value": [8.0, 7.0, 6.0]}},
    "projector": {"type": "projector", "to_world": _DOWN, "fov": 60.0,
                  "scale": 5.0,
                  "irradiance": {"type": "bitmap",
                                 "data": _projector_image()}},
}


def _close(t, j, name="", rtol=RTOL, atol=ATOL):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    if np.issubdtype(j.dtype, np.floating):
        np.testing.assert_allclose(t, j, rtol=rtol, atol=atol, err_msg=name)
    else:
        np.testing.assert_array_equal(t, j.astype(t.dtype), err_msg=name)


def _assert_images_agree(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.abs(img - ref) <= PIX_ATOL + PIX_RTOL * np.abs(ref)
    assert close.all(-1).mean() >= PIX_FRAC
    assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())


def _plane(light=None, sampler=None, rfilter=None, res=10):
    """The gradient tests' plane (path, depth 3) under a light."""
    d = tcornell.plane_light_dict(res, integrator="path", max_depth=3,
                                  light=light)
    if sampler is not None:
        d["sensor"]["sampler"] = {"type": sampler[0],
                                  "sample_count": sampler[1]}
    if rfilter is not None:
        d["sensor"]["film"]["rfilter"] = {"type": rfilter}
    return d


def _pair(d):
    js, ts = lr.load_dict(d), lrt.load_dict(d, device="cpu")
    pa, ps = numpy_tree(ts)
    ja, jss = numpy_tree(js)
    for k in ("emitters.params", "emitters.to_world", "emitters.tex0",
              "emitters.etype", "textures.data", "textures.bitmaps"):
        _close(pa[k], ja[k], k, rtol=1e-6, atol=0)
    for k in ("rfilter", "sampler_kind", "spp", "emitters.types_present"):
        assert ps[k] == jss[k], k
    return js, ts


@pytest.fixture(scope="module")
def three_lights():
    """One scene holding all three emitters (picked uniformly by NEE)."""
    d = _plane(LIGHTS["directional"])
    d["spot"] = LIGHTS["spot"]
    d["projector"] = LIGHTS["projector"]
    return _pair(d)


def test_sample_emitter_direction_matches(np_rng, three_lights):
    js, ts = three_lights
    assert set(ts.emitters.types_present) == {
        EMITTER_DIRECTIONAL, EMITTER_SPOT, EMITTER_PROJECTOR}
    ref = np_rng.uniform(-1, 1, (N, 3)).astype(np.float32) * [1, 1, 0.2]
    ref = ref.astype(np.float32)
    u2 = np_rng.uniform(size=(N, 2)).astype(np.float32)
    u1 = np_rng.uniform(size=N).astype(np.float32)
    tds, tw = tem.sample_emitter_direction(
        ts, torch.from_numpy(ref), torch.from_numpy(u2), torch.from_numpy(u1))
    jds, jw = jem.sample_emitter_direction(
        js, jnp.asarray(ref), jnp.asarray(u2), jnp.asarray(u1))
    for k in ("p", "n", "d", "dist", "pdf", "delta", "emitter"):
        _close(getattr(tds, k), getattr(jds, k), k)
    _close(tw, jw, "weight")
    # all three are delta lights; the spot's cone and the projector's
    # frustum leave some lanes dark
    assert tds.delta.all() and set(tds.emitter.tolist()) == {0, 1, 2}
    et = ts.emitters.etype[tds.emitter]
    for t in (EMITTER_SPOT, EMITTER_PROJECTOR):
        w = tw[et == t]
        assert (w == 0).all(-1).any() and (w > 0).all(-1).any()


def test_delta_emitters_have_no_direction_pdf(np_rng, three_lights):
    """A BSDF-sampled ray never lands on a delta light: its NEE density
    for MIS is 0 in both packages, and no shape carries one."""
    js, ts = three_lights
    ref = np_rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    d = np_rng.normal(size=(64, 3)).astype(np.float32)
    eidx = np.arange(64) % 3
    args = [ref, eidx, ref + d, d, d]
    tp = tem.pdf_emitter_direction(ts, *map(torch.from_numpy, args))
    jp = jem.pdf_emitter_direction(
        js, *[jnp.asarray(a, jnp.int32) if a.dtype.kind == "i"
              else jnp.asarray(a) for a in args])
    _close(tp, jp, "pdf")
    assert not tp.any() and (ts.shape_emitter < 0).all()


@pytest.mark.parametrize("light", sorted(LIGHTS))
def test_emitter_images_match_jax(light):
    js, ts = _pair(_plane(LIGHTS[light]))
    ref = np.asarray(lr.render(js, spp=8, seed=0))
    img = lrt.render(ts, spp=8, seed=0).numpy()
    _assert_images_agree(img, ref)
    assert img.mean() > 1e-2


def _u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("spp", [1, 4, 8, 16])
def test_sampler_streams_bit_exact(kind, spp):
    """Every sample of 40 pixels (ids up to 2^32 - 1, where the products
    wrap), two seeds, a bounce's draw sequence: 2d, 1d, nd(6), 2d, 1d,
    2d."""
    pix = np.repeat(np.r_[np.arange(38), 2**31 - 1, 2**32 - 1], spp)
    samp = np.tile(np.arange(spp), 40)
    for seed in (0, 2**32 - 1):
        js = jrng.make_sampler(jnp.asarray(pix.astype(np.uint32)),
                               jnp.asarray(samp.astype(np.uint32)),
                               np.uint32(seed), kind=kind, spp=spp)
        ts = trng.make_sampler(torch.from_numpy(pix.astype(np.int64)),
                               torch.from_numpy(samp.astype(np.int64)),
                               seed, kind=kind, spp=spp)
        np.testing.assert_array_equal(ts.seed.numpy(), _u32(js.seed))
        for step in ("2d", "1d", "nd", "2d", "1d", "2d"):
            if step == "1d":
                ju, js = js.next_1d()
                tu, ts = ts.next_1d()
            elif step == "2d":
                ju, js = js.next_2d()
                tu, ts = ts.next_2d()
            else:
                ju, js = js.next_nd(6)
                tu, ts = ts.next_nd(6)
            assert tu.dtype == torch.float32
            np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
            np.testing.assert_array_equal(ts.dim.numpy(), _u32(js.dim))


@pytest.mark.parametrize("n", [2, 3, 5, 16, 37])
def test_kensler_permutation_bit_exact(np_rng, n):
    i = np.tile(np.arange(n), 64)
    key = np_rng.integers(0, 2**32, i.size, dtype=np.uint64)
    j = np.asarray(jrng._kensler_permute(
        jnp.asarray(i.astype(np.uint32)), n, jnp.asarray(key.astype(np.uint32))))
    t = trng._kensler_permute(torch.from_numpy(i), n,
                              torch.from_numpy(key.astype(np.int64)))
    np.testing.assert_array_equal(t.numpy(), _u32(j))
    assert t.min() >= 0 and t.max() < n
    v = np_rng.integers(0, 2**32, 512, dtype=np.uint64)
    np.testing.assert_array_equal(
        trng._bit_reverse(torch.from_numpy(v.astype(np.int64))).numpy(),
        _u32(jrng._bit_reverse(jnp.asarray(v.astype(np.uint32)))))


@pytest.mark.parametrize("kind", KINDS)
def test_sampler_images_match_jax(kind):
    """spp 8: a non-square count (CMJ's 2 x 4 grid, the orthogonal array's
    p = 3 prefix)."""
    js, ts = _pair(_plane(sampler=(kind, 8)))
    assert ts.sampler_kind == kind
    ref = np.asarray(lr.render(js, spp=8, seed=0))
    img = lrt.render(ts, spp=8, seed=0).numpy()
    _assert_images_agree(img, ref)


@pytest.mark.parametrize("rfilter", [FILTER_MITCHELL, FILTER_CATMULLROM,
                                     FILTER_LANCZOS])
def test_filter_weights_match_jax(np_rng, rfilter):
    r = tfilm.filter_radius(rfilter)
    assert r == jfilm.filter_radius(rfilter)
    dx = np_rng.uniform(-r - 0.5, r + 0.5, N).astype(np.float32)
    dy = np_rng.uniform(-r - 0.5, r + 0.5, N).astype(np.float32)
    dx[:3] = [0.0, 1.0, -2.0]                  # the kernels' break points
    t = tfilm._filter_weight(rfilter, torch.from_numpy(dx),
                             torch.from_numpy(dy))
    j = jfilm._filter_weight(rfilter, jnp.asarray(dx), jnp.asarray(dy))
    _close(t, j, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("rfilter", ["mitchell", "catmullrom", "lanczos"])
def test_filter_images_match_jax(rfilter):
    """Not regen-able: the fixed wavefront, (2 r)^2 splats per sample."""
    js, ts = _pair(_plane(rfilter=rfilter))
    ref = np.asarray(lr.render(js, spp=8, seed=0))
    img = lrt.render(ts, spp=8, seed=0).numpy()
    _assert_images_agree(img, ref)
