"""Polarized transport: the port's Mueller calculus, polarization elements
and `stokes` integrator against the JAX package's on the CPU, on
tests/test_polarization.py's scenes (tests/torch_m10_scenes.py), in RGB
and in the spectral x polarized variant.

Tolerances: Mueller functions within 1e-6 on seeded inputs (both run the
same fp32 formulas; a 4x4 product may sum in another order).  Images,
per pixel and per Stokes component, those of test_torch_nee_slice.py:
>= 99 % of pixels within rtol 1e-3 / atol 1e-4, the mean within 1e-3
relative.  Measured: every Stokes image within 3e-5 of the JAX package's.

Its gradients run from tests/test_torch_stokes_grad.py, which shares
this file's scenes and tolerances, so that xdist's file scheduler can
start them apart from this file (a long file holds one worker to its
end).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
import liverrenderer_tpu_torch as lrt
import torch_m10_scenes as ms
from liverrenderer_tpu.core import mueller as jmu
from liverrenderer_tpu_torch.core import mueller as tmu
from torch_threads import torch_threads_per_worker  # noqa: F401

PIX_RTOL, PIX_ATOL, PIX_FRAC, MEAN_RTOL = 1e-3, 1e-4, 0.99, 1e-3
FN_ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _assert_images_agree(img, ref):
    """Per pixel over the trailing axes (Stokes components and
    channels)."""
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.abs(img - ref) <= PIX_ATOL + PIX_RTOL * np.abs(ref)
    assert close.reshape(close.shape[:2] + (-1,)).all(-1).mean() >= PIX_FRAC
    assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean()) \
        + PIX_ATOL


# incidence: normal (cos 1), oblique, grazing (cos 1e-7: clamped to 1e-6);
# eta: a real dielectric, a complex conductor, below 1 (total internal
# reflection)
@pytest.mark.parametrize("incidence", ["normal", "oblique", "grazing"])
@pytest.mark.parametrize("eta", ["real", "complex", "below_one"])
def test_fresnel_mueller_matches_jax(incidence, eta):
    rng = np.random.default_rng(
        ["normal", "oblique", "grazing"].index(incidence) * 3
        + ["real", "complex", "below_one"].index(eta))
    n = 256
    ci = {"normal": np.ones(n), "oblique": rng.uniform(0.05, 0.99, n),
          "grazing": np.full(n, 1e-7)}[incidence].astype(np.float32)
    er = {"real": rng.uniform(1.1, 2.5, n),
          "complex": rng.uniform(0.1, 1.7, n),
          "below_one": rng.uniform(0.5, 0.9, n)}[eta].astype(np.float32)
    ei = (rng.uniform(1.5, 5.0, n) if eta == "complex"
          else np.zeros(n)).astype(np.float32)
    ref = np.asarray(jmu.specular_reflection_fresnel(
        jnp.asarray(ci), jnp.asarray(er), jnp.asarray(ei)))
    got = tmu.specular_reflection_fresnel(_t(ci), _t(er), _t(ei)).numpy()
    assert got.shape == (n, 4, 4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=FN_ATOL)
    if eta == "real":
        # eta_im omitted is a dielectric, as in the JAX package
        np.testing.assert_allclose(
            tmu.specular_reflection_fresnel(_t(ci), _t(er)).numpy(), ref,
            rtol=0, atol=FN_ATOL)


def test_mueller_elements_and_frames_match_jax():
    rng = np.random.default_rng(7)
    n = 128
    th = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    v = rng.uniform(0.0, 1.0, n).astype(np.float32)
    pairs = [
        (jmu.rotator(jnp.asarray(th)), tmu.rotator(_t(th))),
        (jmu.linear_retarder(jnp.asarray(th)), tmu.linear_retarder(_t(th))),
        (jmu.linear_polarizer(jnp.asarray(v)), tmu.linear_polarizer(_t(v))),
        (jmu.linear_polarizer(1.0), tmu.linear_polarizer(1.0)),
        (jmu.depolarizer(jnp.asarray(v)), tmu.depolarizer(_t(v))),
        (jmu.circular_polarizer(False), tmu.circular_polarizer(False)),
        (jmu.circular_polarizer(True), tmu.circular_polarizer(True)),
    ]
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = d.astype(np.float32)
    d[0] = [0, 0, -1]          # the Duff basis's branch at nz < 0
    b_tgt = np.cross(d, rng.normal(size=(n, 3)))
    b_tgt = (b_tgt / np.linalg.norm(b_tgt, axis=-1,
                                    keepdims=True)).astype(np.float32)
    jb = jmu.stokes_basis(jnp.asarray(d))
    tb = tmu.stokes_basis(_t(d))
    pairs += [
        (jb, tb),
        (jmu.rotation_angle(jnp.asarray(d), jb, jnp.asarray(b_tgt)),
         tmu.rotation_angle(_t(d), tb, _t(b_tgt))),
    ]
    M = rng.normal(size=(n, 4, 4)).astype(np.float32)
    pairs.append((jmu.rotate_mueller_basis(
        jnp.asarray(M), jnp.asarray(d), jb, jnp.asarray(b_tgt),
        -jnp.asarray(d), jmu.stokes_basis(-jnp.asarray(d)),
        jnp.asarray(b_tgt)),
        tmu.rotate_mueller_basis(_t(M), _t(d), tb, _t(b_tgt), -_t(d),
                                 tmu.stokes_basis(-_t(d)), _t(b_tgt))))
    for ref, got in pairs:
        ref, got = np.asarray(ref), got.numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=4 * FN_ATOL)


STACKS = {
    "polarizer": [{"type": "polarizer"}],
    "malus_30": [{"type": "polarizer", "theta": 30.0},
                 {"type": "polarizer", "theta": 0.0}],
    "crossed": [{"type": "polarizer", "theta": 90.0},
                {"type": "polarizer", "theta": 0.0}],
    "quarter_wave": [{"type": "polarizer", "theta": 90.0},
                     {"type": "retarder", "theta": 45.0, "delta": 90.0},
                     {"type": "polarizer", "theta": 0.0}],
    "half_wave": [{"type": "polarizer", "theta": 90.0},
                  {"type": "retarder", "theta": 45.0, "delta": 180.0},
                  {"type": "polarizer", "theta": 0.0}],
    "circular": [{"type": "circular"}],
    "circular_left": [{"type": "circular", "handedness": "left"},
                      {"type": "polarizer", "theta": 20.0,
                       "transmittance": [0.9, 0.8, 0.7]}],
}


def _scene(kind):
    if kind in STACKS:
        return ms.stack_dict(STACKS[kind])
    return {"gold_mirror": ms.gold_mirror_dict,
            "gold_floor": ms.gold_floor_dict,
            "area_floor": ms.area_floor_dict}[kind]()


@pytest.mark.parametrize("kind,variant", [
    ("polarizer", None), ("malus_30", None), ("crossed", None),
    ("quarter_wave", None), ("circular_left", None), ("gold_mirror", None),
    ("gold_floor", None), ("area_floor", None),
    ("half_wave", "spectral"), ("circular", "spectral"),
    ("gold_mirror", "spectral"), ("area_floor", "spectral")])
def test_render_stokes_matches_jax_per_pixel(kind, variant):
    d = _scene(kind)
    spp = 16
    ref = np.asarray(lr.render_stokes(lr.load_dict(d, variant=variant),
                                      spp=spp, seed=0))
    ts = lrt.load_dict(d, device="cpu", variant=variant)
    assert ts.spectral == (variant == "spectral")
    img = lrt.render_stokes(ts, spp=spp, seed=0).numpy()
    assert img.shape == ref.shape == (ts.film_h, ts.film_w, 4, 3)
    _assert_images_agree(img, ref)


def test_render_stokes_passes_split_by_whole_spp(monkeypatch):
    """A film past the pass budget renders in chunks of whole spp, whose
    sums differ from one pass's in fp32 summation order only."""
    from liverrenderer_tpu_torch.integrators import common
    ts = lrt.load_dict(ms.gold_floor_dict(), device="cpu")
    one = lrt.render_stokes(ts, spp=6, seed=2)
    monkeypatch.setattr(common, "MAX_WAVEFRONT", 8 * 8 * 4)
    passes = lrt.render_stokes(ts, spp=6, seed=2)
    torch.testing.assert_close(passes, one, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("variant", [None, "spectral"])
def test_render_of_a_stokes_scene_is_s0_as_jax(variant):
    """render of a stokes scene goes through the film with S0, the
    unpolarized image, in both packages."""
    d = ms.area_floor_dict()
    ref = np.asarray(lr.render(lr.load_dict(d, variant=variant), spp=8,
                               seed=0))
    img = lrt.render(lrt.load_dict(d, device="cpu", variant=variant),
                     spp=8, seed=0).numpy()
    assert img.shape == ref.shape == (12, 12, 3)
    _assert_images_agree(img, ref)
    assert img.mean() > 0.1


STACK_XML = """<scene version="3.0.0">
  <integrator type="stokes"><integer name="max_depth" value="8"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="10"/>
    <transform name="to_world">
      <lookat origin="0, 0, 3" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="4"/><integer name="height" value="4"/>
      <rfilter type="box"/>
    </film>
  </sensor>
  <emitter type="constant"><rgb name="radiance" value="1, 1, 1"/></emitter>
  <shape type="rectangle">
    <transform name="to_world"><translate x="0" y="0" z="2"/></transform>
    <bsdf type="polarizer"><float name="theta" value="30"/></bsdf>
  </shape>
  <shape type="rectangle">
    <transform name="to_world"><translate x="0" y="0" z="1.5"/></transform>
    <bsdf type="retarder">
      <float name="theta" value="45"/><float name="delta" value="90"/>
    </bsdf>
  </shape>
  <shape type="rectangle">
    <transform name="to_world"><translate x="0" y="0" z="1"/></transform>
    <bsdf type="polarizer"/>
  </shape>
</scene>
"""


def test_load_file_of_a_stokes_scene_equals_load_dict(tmp_path):
    f = tmp_path / "stack.xml"
    f.write_text(STACK_XML)
    d = ms.stack_dict([{"type": "polarizer", "theta": 30.0},
                       {"type": "retarder", "theta": 45.0, "delta": 90.0},
                       {"type": "polarizer"}])
    sx = lrt.load_file(str(f), device="cpu")
    sd = lrt.load_dict(d, device="cpu")
    for k in ("bsdfs.btype", "bsdfs.params", "bsdfs.flags"):
        a, b = (getattr(getattr(s, "bsdfs"), k.split(".")[1])
                for s in (sx, sd))
        assert torch.equal(a, b), k
    img = lrt.render_stokes(sx, spp=8).numpy()
    np.testing.assert_array_equal(img, lrt.render_stokes(sd, spp=8).numpy())
    # the polarizer at 30 deg: S0 = 1/2 cos^2(30) through the second one,
    # and the quarter-wave plate between them circularly polarizes
    assert abs(img[1:3, 1:3, 0].mean() - 0.25) < 2e-3


def test_element_bsdfs_build_as_jax():
    """The elements' rows: theta and delta in radians (delta defaults to
    90 deg), handedness, transmittance as tex0, flags null | delta
    transmission, twosided."""
    d = ms.stack_dict(STACKS["circular_left"] + STACKS["quarter_wave"])
    js, ts = lr.load_dict(d), lrt.load_dict(d, device="cpu")
    for k in ("btype", "params", "tex0", "flags", "twosided"):
        a = np.asarray(getattr(js.bsdfs, k))
        b = getattr(ts.bsdfs, k).numpy()
        np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=k)
    assert set(ts.bsdfs.types_present) == set(js.bsdfs.types_present)
