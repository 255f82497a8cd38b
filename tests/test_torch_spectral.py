"""The spectral variant's functions and gate: the port's core/spectrum.py
against the JAX package's on seeded inputs, the builder's gate side by
side with the JAX builder's, the bridge carrying the variant across, and
load_file of a spectral scene.

Tolerances: sample_hero bit for bit (the same fp32 multiply and add); the
lifts and the CIE functions within 1e-6 absolute (values of order 1; the
matrix products may sum in another order); the lift's gradient at a zero
output exactly JAX's (jnp.maximum splits it 0.5 / 0.5, as torch.maximum
does).  Measured: every lift bit-identical, the CIE functions within
4.8e-7.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu.core import spectrum as jspec
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.bridge import numpy_tree, scene_from_numpy
from liverrenderer_tpu_torch.core import spectrum as tspec
from liverrenderer_tpu_torch.integrators import common as tcommon
from liverrenderer_tpu_torch.integrators import regen as tregen
from liverrenderer_tpu_torch.integrators import volpathmis as tvolpathmis
from liverrenderer_tpu_torch.scene import cornell as tcornell
from liverrenderer_tpu_torch.scene import meshio as tmeshio
from liverrenderer_tpu_torch.scene import xml as txml
import torch_sss_inputs as sssi
import torch_xml_files as xf
from torch_threads import torch_threads_per_worker  # noqa: F401

ATOL = 1e-6
N = 4096


def _inputs(seed=0):
    """(u, lam, rgb, L) as numpy: uniforms, their hero packets (JAX), RGB
    values with ties between channels and zeros, packet radiances in
    [0, 1) (every value of order 1, so 1e-6 absolute is a few ulps)."""
    rng = np.random.default_rng(seed)
    u = rng.random(N).astype(np.float32)
    lam = np.asarray(jspec.sample_hero(jnp.asarray(u)))
    rgb = rng.random((N, 3)).astype(np.float32)
    rgb[:64, 1] = rgb[:64, 0]               # R == G: the first case wins
    rgb[64:128] = rgb[64:128, :1]            # grey: every case ties
    rgb[128:192] = 0.0
    L = rng.random((N, tspec.N_SPEC)).astype(np.float32)
    return u, lam, rgb, L


def test_sample_hero_bit_for_bit():
    u, lam, _, _ = _inputs()
    out = tspec.sample_hero(torch.from_numpy(u)).numpy()
    assert out.shape == (N, tspec.N_SPEC)
    np.testing.assert_array_equal(out, lam)
    assert out.min() >= tspec.SPEC_MIN and out.max() < tspec.SPEC_MAX


@pytest.mark.parametrize("name", [
    "smits_upsample", "smits_upsample_illum", "xyz_bar", "d65",
    "spec_to_rgb_estimate", "rgb_estimate_weights"])
def test_spectrum_function_matches_jax(name):
    _, lam, rgb, L = _inputs()
    jfn = {"xyz_bar": jspec.xyz_bar_jax, "d65": jspec.d65_jax}.get(
        name, getattr(jspec, name, None))
    args = {"smits_upsample": (rgb, lam), "smits_upsample_illum": (rgb, lam),
            "spec_to_rgb_estimate": (L, lam)}.get(name, (lam,))
    ref = np.asarray(jfn(*(jnp.asarray(a) for a in args)))
    out = getattr(tspec, name)(*(torch.from_numpy(a) for a in args)).numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_tables_match_jax():
    assert tspec._CIE_Y_INT == jspec._CIE_Y_INT
    np.testing.assert_array_equal(tspec._D65_TABLE, jspec._D65_TABLE)
    np.testing.assert_array_equal(tspec._CIE_TABLE, jspec._CIE_TABLE)
    np.testing.assert_array_equal(tspec._SMITS_TABLE,
                                  jspec._smits_eval_np().T)


def test_smits_gradient_at_zero_output_matches_jax():
    """d/d rgb of a weighted sum of the lift, with lanes whose lift is
    exactly 0 (black, and saturated primaries where their basis is 0)."""
    _, lam, rgb, _ = _inputs()
    rgb[192:256] = [1.0, 0.0, 0.0]
    w = np.random.default_rng(1).normal(size=lam.shape).astype(np.float32)
    out0 = np.asarray(jspec.smits_upsample(jnp.asarray(rgb),
                                           jnp.asarray(lam)))
    assert (out0 == 0).sum() > 100

    def jloss(c):
        return jnp.sum(jspec.smits_upsample(c, jnp.asarray(lam)) * w)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(rgb)))
    c = torch.from_numpy(rgb).requires_grad_()
    (tspec.smits_upsample(c, torch.from_numpy(lam))
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(c.grad.numpy(), ref, rtol=0, atol=ATOL)


def test_packet_lifts_equal_the_functions():
    """Packet shares the bases of one packet between lifts (and lifts
    (N, 5, 3) at once, as the bio media's five sigmas): the same values
    as smits_upsample and smits_upsample_illum, bit for bit."""
    _, lam, rgb, _ = _inputs()
    lam_t, rgb_t = torch.from_numpy(lam), torch.from_numpy(rgb)
    pk = tspec.Packet(lam_t)
    assert torch.equal(pk.refl(rgb_t), tspec.smits_upsample(rgb_t, lam_t))
    assert torch.equal(pk.illum(rgb_t),
                       tspec.smits_upsample_illum(rgb_t, lam_t))
    five = torch.stack([rgb_t.roll(k, 0) for k in range(5)], 1)
    out = pk.refl(five)
    assert out.shape == (N, 5, tspec.N_SPEC)
    for k in range(5):
        assert torch.equal(out[:, k],
                           tspec.smits_upsample(rgb_t.roll(k, 0), lam_t))


def test_upsample_round_trip():
    """The Smits lift then the CIE estimate give the RGB back: whites
    (D65-referenced) and saturated colours within the JAX package's own
    bounds (tests/test_spectral.py)."""
    lam = tspec.sample_hero(torch.from_numpy(
        np.random.default_rng(0).random(100000).astype(np.float32)))
    for rgb, tol in (([1.0, 1.0, 1.0], 0.05), ([0.3, 0.3, 0.3], 0.05),
                     ([0.8, 0.1, 0.1], 0.08), ([0.1, 0.2, 0.7], 0.08)):
        r = torch.tensor(rgb).expand(lam.shape[0], 3)
        back = tspec.spec_to_rgb_estimate(
            tspec.smits_upsample_illum(r, lam), lam).mean(0).numpy()
        np.testing.assert_allclose(back, rgb, atol=tol)


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

def _cornell(cornell, integrator, res=8):
    d = cornell()
    d["integrator"] = {"type": integrator, "max_depth": 4}
    d["sensor"]["film"] = {"type": "hdrfilm", "width": res, "height": res,
                           "rfilter": {"type": "box"}}
    return d


@pytest.mark.parametrize("integrator", [
    "path", "direct", "volpath", "volpathmis", "biovolpath", "biovolpath06",
    "prbvolpath"])
def test_gate_admits_what_jax_admits(integrator):
    js = lr.load_dict(_cornell(lr.cornell_box, integrator),
                      variant="spectral")
    ts = lrt.load_dict(_cornell(tcornell.cornell_box, integrator),
                       device="cpu", variant="spectral")
    assert js.spectral and ts.spectral
    assert not lrt.load_dict(_cornell(tcornell.cornell_box, integrator),
                             device="cpu").spectral


@pytest.mark.parametrize("kind", [
    "aov", "depth", "moment", "prb", "prb_basic", "dipole"])
def test_gate_refuses_what_jax_refuses(kind):
    if kind == "dipole":
        d = sssi.sphere_dict("dipole", res=4)
        jd = d
    else:
        d = _cornell(tcornell.cornell_box, kind)
        jd = _cornell(lr.cornell_box, kind)
    with pytest.raises(AssertionError):
        lr.load_dict(jd, variant="spectral")
    with pytest.raises(ValueError, match="spectral variant"):
        lrt.load_dict(d, device="cpu", variant="spectral")
    # the same scene in RGB loads
    assert not lrt.load_dict(d, device="cpu").spectral


def test_gate_keeps_stokes_unported():
    """The JAX builder admits stokes under spectral, and so does the port
    (the spectral x polarized variant); an RGB load of the same dict
    stays RGB."""
    d = _cornell(tcornell.cornell_box, "stokes")
    assert lr.load_dict(_cornell(lr.cornell_box, "stokes"),
                        variant="spectral").spectral
    ts = lrt.load_dict(d, device="cpu", variant="spectral")
    assert ts.spectral and ts.integrator == "stokes"
    assert not lrt.load_dict(d, device="cpu").spectral


def test_variant_key_in_the_dict():
    d = _cornell(tcornell.cornell_box, "path")
    d["variant"] = "scalar_spectral"
    assert lrt.load_dict(d, device="cpu").spectral
    d["variant"] = "rgb"
    assert not lrt.load_dict(d, device="cpu").spectral


def test_routing_of_the_spectral_variant(monkeypatch):
    """A spectral volpathmis scene runs the volpath bounce on the regen
    wavefront (an RGB one keeps its own module, off regen); the pool holds
    the packet."""
    d = _cornell(tcornell.cornell_box, "volpathmis")
    rgb = lrt.load_dict(d, device="cpu")
    sp = lrt.load_dict(d, device="cpu", variant="spectral")
    assert tregen.regen_applicable(sp, "primal")
    assert not tregen.regen_applicable(rgb, "primal")
    assert tregen._family(sp).__name__.endswith(".volpath")
    assert (tregen.pool_channels(sp), tregen.pool_channels(rgb)) \
        == (tspec.N_SPEC, 3)

    def refuse(*a, **k):
        raise AssertionError("volpathmis module on a spectral scene")

    monkeypatch.setattr(tvolpathmis, "sample", refuse)
    img = tcommon.render(sp, spp=1)
    assert img.shape == (8, 8, 3) and torch.isfinite(img).all()
    with pytest.raises(AssertionError, match="volpathmis module"):
        tcommon._render_jit(rgb, 0, 1, 1)


def test_render_specfilm_refuses_rgb():
    ts = lrt.load_dict(_cornell(tcornell.cornell_box, "path"), device="cpu")
    with pytest.raises(ValueError, match="spectral variant"):
        lrt.render_specfilm(ts, n_bins=4, spp=1)


# ---------------------------------------------------------------------------
# carrying the variant across: the bridge and scene files
# ---------------------------------------------------------------------------

def test_bridge_carries_the_spectral_variant():
    """scene_from_numpy of a JAX-built spectral scene keeps spectral=True
    and renders the image of the port's own load_dict."""
    js = lr.load_dict(_cornell(lr.cornell_box, "path"), variant="spectral")
    arrays, statics = numpy_tree(js)
    assert statics["spectral"] is True
    tb = scene_from_numpy(arrays, statics, "cpu")
    ts = lrt.load_dict(_cornell(tcornell.cornell_box, "path"), device="cpu",
                       variant="spectral")
    assert tb.spectral and ts.spectral
    a, b = lrt.render(tb, spp=2, seed=3), lrt.render(ts, spp=2, seed=3)
    assert torch.isfinite(a).all() and float(a.mean()) > 0
    assert torch.equal(a, b)


def test_load_file_spectral_equals_load_dict(tmp_path):
    """load_file(..., variant="spectral") of the proxy's files builds the
    buffers of load_dict of the same scene with the files read back, and
    renders its image bit for bit."""
    path, _ = xf.write_proxy_files(str(tmp_path), 8, 6, 2, subdiv=2,
                                   bump_res=32, sky=(64, 32))
    d = xf.inline_files(txml.parse_xml(path), os.path.dirname(path),
                        lrt.read_image, tmeshio.load_mesh)
    a = lrt.load_file(path, device="cpu", variant="spectral")
    b = lrt.load_dict(d, device="cpu", variant="spectral")
    pa, sa = numpy_tree(a)
    pb, sb = numpy_tree(b)
    assert sa == sb and sa["spectral"] is True
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
    img = lrt.render(a, spp=2, seed=3)
    assert torch.isfinite(img).all() and float(img.mean()) > 0
    assert torch.equal(img, lrt.render(b, spp=2, seed=3))


def test_specfilm_walks_the_surface_path_whatever_the_integrator():
    """The JAX package's render_specfilm walks every scene with the
    surface path's bounce, whatever its integrator: the spectral fog box
    (volpath) gives the bins of the same dict under `path`, its fog passed
    through as a null surface, in both packages; the port equals the JAX
    package per bin."""
    def fog(cornell, integrator):
        d = tcornell.fog_cornell_box(8, max_depth=4, cornell=cornell)
        d["integrator"]["type"] = integrator
        return d

    bins = {i: lrt.render_specfilm(
        lrt.load_dict(fog(tcornell.cornell_box, i), device="cpu",
                      variant="spectral"), n_bins=8, spp=2).numpy()
        for i in ("volpath", "path")}
    np.testing.assert_array_equal(bins["volpath"], bins["path"])
    ref = np.asarray(lr.render_specfilm(
        lr.load_dict(fog(lr.cornell_box, "volpath"), variant="spectral"),
        n_bins=8, spp=2))
    close = np.abs(bins["volpath"] - ref) <= 1e-4 + 1e-3 * np.abs(ref)
    assert close.mean() >= 0.99 and bins["volpath"].mean() > 0
