"""The subsurface slice as a whole: images and gradients of vaescatter and
dipole scenes, the port against the JAX package on the CPU.

- images of a vaescatter sphere and a dipole sphere (tests/
  torch_sss_inputs.py) under a box and a tent filter (the
  regenerating wavefront) and a gaussian (the fixed passes, capped at 2^17
  lanes for a subsurface scene in both packages), each rendered from the
  JAX build carried over by the bridge and from the port's own build;
- a named vaescatter in the sigmaS / sigmaA form through a ref, and a
  test-written scene.xml with a <subsurface> through load_file;
- the emitters.params gradient of the vaescatter sphere through the scan
  adjoint (both packages send subsurface surface scenes there).

The vaescatter sphere's images, the load_file scene and the gradient run
from tests/test_torch_sss_vae_images.py and tests/test_torch_sss_grad.py,
which share this file's model, scene helpers and tolerances, so that xdist's
file scheduler can start them apart.

Both packages read the same seeded synthetic model (tests/
torch_sss_inputs.py).  Tolerances: images >= 99 % of pixels within rtol
1e-3 and atol 1e-4, means within 1e-3 (the VAE's products and the
least-squares fits sum in another order, which may move a rare exit);
gradients every entry within 1e-5 of the largest |entry|.
"""
import os

import numpy as np
import pytest

import liverrenderer_tpu as lr
from liverrenderer_tpu.integrators import common as jcommon
from liverrenderer_tpu.ssub import vae as jvae
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.bridge import numpy_tree, scene_from_numpy
from liverrenderer_tpu_torch.integrators import common as tcommon
from liverrenderer_tpu_torch.ssub import vae as tvae
from torch_sss_inputs import sphere, sphere_dict, substituted, write_model
from torch_threads import torch_threads_per_worker  # noqa: F401
from torch_xml_files import write_ply

PIX_RTOL, PIX_ATOL, PIX_FRAC, MEAN_RTOL = 1e-3, 1e-4, 0.99, 1e-3
G_ATOL_REL = 1e-5
SPP = 4


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return write_model(str(tmp_path_factory.mktemp("vae")), seed=3)


def _build(d, model, **kw):
    """(JAX scene, port scene built from d, port scene bridged from the
    JAX one)."""
    with substituted(*model, jvae, tvae):
        js = lr.load_dict(d)
        ts = lrt.load_dict(d, device="cpu", **kw)
    return js, ts, scene_from_numpy(*numpy_tree(js), "cpu")


def _assert_images_agree(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.abs(img - ref) <= PIX_ATOL + PIX_RTOL * np.abs(ref)
    assert close.all(-1).mean() >= PIX_FRAC, close.all(-1).mean()
    assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())


def check_sphere_images(model, kind, rfilter):
    """The sphere's image from the bridged JAX build and from the port's
    own build, against the JAX package's."""
    js, ts, bs = _build(sphere_dict(kind, res=16, rfilter=rfilter), model)
    assert ts.ssub.enabled and bs.ssub.enabled
    assert (ts.ssub.has_vae, ts.ssub.has_dipole) == (kind == "vaescatter",
                                                     kind == "dipole")
    ref = np.asarray(lr.render(js, spp=SPP, seed=1))
    assert ref.mean() > 1e-3
    for sc in (bs, ts):
        _assert_images_agree(lrt.render(sc, spp=SPP, seed=1).numpy(), ref)


@pytest.mark.parametrize("rfilter", ["box", "tent", "gaussian"])
@pytest.mark.parametrize("kind", ["dipole"])
def test_sss_sphere_images_match_jax(model, kind, rfilter):
    check_sphere_images(model, kind, rfilter)


def test_named_sigma_form_through_a_ref(model):
    d = sphere_dict("vaescatter", res=12)
    d["skin"] = {"type": "vaescatter", "id": "skin", "g": 0.2, "eta": 1.4,
                 "kernelEpsScale": 1.5,
                 "sigmaS": {"type": "rgb", "value": [2.0, 2.5, 3.0]},
                 "sigmaA": {"type": "rgb", "value": [0.05, 0.1, 0.4]}}
    d["blob"]["subsurface"] = {"type": "ref", "id": "skin"}
    js, ts, bs = _build(d, model)
    np.testing.assert_array_equal(ts.ssub.params.numpy(),
                                  np.asarray(js.ssub.params))
    prm = ts.ssub.params.numpy()[0]
    np.testing.assert_allclose(prm[0:3], [2.05, 2.6, 3.4], rtol=1e-6)
    assert prm[6] == np.float32(0.2) and prm[7] == np.float32(1.4)
    assert ts.ssub.kernel_eps_scale == js.ssub.kernel_eps_scale == 1.5
    ref = np.asarray(lr.render(js, spp=SPP, seed=2))
    _assert_images_agree(lrt.render(bs, spp=SPP, seed=2).numpy(), ref)
    _assert_images_agree(lrt.render(ts, spp=SPP, seed=2).numpy(), ref)


def _sss_xml(tmp_path):
    v, f = sphere(3)
    write_ply(os.path.join(tmp_path, "blob.ply"), v, f)
    path = os.path.join(tmp_path, "scene.xml")
    with open(path, "w") as fh:
        fh.write("""<scene version="2.1.0">
  <integrator type="path"><integer name="max_depth" value="6"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="40"/>
    <transform name="to_world">
      <lookat origin="0,0,4" target="0,0,0" up="0,1,0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="12"/><integer name="height" value="12"/>
      <rfilter type="tent"/>
    </film>
    <sampler type="ldsampler"><integer name="sample_count" value="4"/>
    </sampler>
  </sensor>
  <subsurface type="dipole" id="milk">
    <rgb name="sigmaS" value="2.0, 2.3, 3.0"/>
    <rgb name="sigmaA" value="0.03, 0.1, 0.3"/>
  </subsurface>
  <shape type="ply">
    <string name="filename" value="blob.ply"/>
    <subsurface type="vaescatter">
      <rgb name="sigmaT" value="0.8, 1.0, 1.4"/>
      <rgb name="albedo" value="0.99, 0.98, 0.95"/>
      <float name="eta" value="1.33"/>
    </subsurface>
  </shape>
  <shape type="ply">
    <string name="filename" value="blob.ply"/>
    <transform name="to_world"><translate x="2.2"/></transform>
    <ref id="milk"/>
  </shape>
  <emitter type="point">
    <point name="position" x="3" y="3" z="3"/>
    <rgb name="intensity" value="40, 40, 40"/>
  </emitter>
</scene>
""")
    return path


def test_fixed_pass_split_matches_jax(model, monkeypatch):
    """A subsurface scene's fixed passes hold at most 2^17 lanes in both
    packages (a 256^2 gaussian film at 8 spp: 4 passes of 2 spp)."""
    d = sphere_dict("dipole", res=256, rfilter="gaussian")
    js, ts, _ = _build(d, model)
    seen = {}
    monkeypatch.setattr(jcommon, "_render_jit",
                        lambda sc, seed, spp, spp_pass, mode: seen.update(
                            jax=spp_pass))
    monkeypatch.setattr(tcommon, "_render_jit",
                        lambda sc, seed, spp, spp_pass, mode: seen.update(
                            port=spp_pass))
    lr.render(js, spp=8, seed=0)
    lrt.render(ts, spp=8, seed=0)
    assert seen == {"jax": 2, "port": 2}


def test_vaescatter_on_an_analytic_sphere_matches_jax(model):
    """Both builders fit polynomials to meshes only: a vaescatter on an
    analytic sphere keeps all-zero coefficients, its projection rays have
    no direction and find no exit, so every lane refracted into it dies
    (darker than its dielectric alone).  The port follows."""
    d = sphere_dict("vaescatter", res=12)
    blob = d.pop("blob")
    d["ball"] = {"type": "sphere", "radius": 1.0,
                 "subsurface": blob["subsurface"]}
    js, ts, _ = _build(d, model)
    assert ts.ssub.has_vae and not ts.ssub.poly.any()
    ref = np.asarray(lr.render(js, spp=SPP, seed=0))
    img = lrt.render(ts, spp=SPP, seed=0).numpy()
    _assert_images_agree(img, ref)
    d["ball"] = {"type": "sphere", "radius": 1.0,
                 "bsdf": {"type": "dielectric", "int_ior": 1.3}}
    plain = lrt.render(lrt.load_dict(d, device="cpu"), spp=SPP,
                       seed=0).numpy()
    assert img.mean() < 0.9 * plain.mean()
