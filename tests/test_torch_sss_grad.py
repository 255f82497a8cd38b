"""The subsurface slice's scene file and gradient (split from
tests/test_torch_sss_slice.py, whose seeded model, scene helpers and
tolerances they share): a test-written scene.xml with a nested
vaescatter and a named dipole through load_file, and the emitters.params
gradient of the vaescatter sphere through the scan adjoint (both
packages send subsurface surface scenes there), every entry within 1e-5
of the largest |entry|."""
import jax.numpy as jnp
import numpy as np
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu.ssub import vae as jvae
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.bridge import params_from_numpy
from liverrenderer_tpu_torch.integrators import prb_replay as treplay
from liverrenderer_tpu_torch.ssub import vae as tvae
from test_torch_sss_slice import (G_ATOL_REL, SPP, _assert_images_agree,
                                  _build, _sss_xml, model)  # noqa: F401
from torch_sss_inputs import sphere_dict, substituted
from torch_threads import torch_threads_per_worker  # noqa: F401


def test_load_file_subsurface_matches_jax(model, tmp_path):
    """A scene file with a nested vaescatter and a named dipole (ref)."""
    path = _sss_xml(str(tmp_path))
    with substituted(*model, jvae, tvae):
        js, ts = lr.load_file(path), lrt.load_file(path, device="cpu")
    assert ts.ssub.has_vae and ts.ssub.has_dipole
    np.testing.assert_array_equal(ts.shape_subsurface.numpy(),
                                  np.asarray(js.shape_subsurface))
    for k in ("params", "ss_type", "dip_points", "dip_area", "dip_consts"):
        np.testing.assert_array_equal(getattr(ts.ssub, k).numpy(),
                                      np.asarray(getattr(js.ssub, k)))
    ref = np.asarray(lr.render(js, spp=SPP, seed=0))
    _assert_images_agree(lrt.render(ts, spp=SPP, seed=0).numpy(), ref)


def test_vaescatter_gradient_scan_adjoint_matches_jax(model):
    d = sphere_dict("vaescatter", res=8, depth=4)
    js, ts, bs = _build(d, model)
    key = "emitters.params"
    params = params_from_numpy({key: np.asarray(lr.traverse(js)[key])},
                               "cpu")
    # subsurface surface scenes keep the scan adjoint in both packages
    assert not treplay.replay_applicable(ts, params, SPP)
    _, jg, jimg = lr.render_grad(js, {key: lr.traverse(js)[key]}, jnp.mean,
                                 spp=SPP, seed=0)
    ref = np.asarray(jg[key])
    assert np.isfinite(ref).all() and np.abs(ref).max() > 0
    for sc in (bs, ts):
        _, tg, timg = lrt.render_grad(sc, params, torch.mean, spp=SPP,
                                      seed=0)
        g = tg[key].numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, ref, rtol=0,
                                   atol=G_ATOL_REL * np.abs(ref).max())
        _assert_images_agree(timg.numpy(), np.asarray(jimg))
