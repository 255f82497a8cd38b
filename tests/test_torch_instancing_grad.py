"""The bsdfs.params gradient of an instanced scene against the JAX
package's on the CPU (split from tests/test_torch_instancing.py, whose
scenes and tolerances it shares).
"""
import jax.numpy as jnp
import numpy as np

import liverrenderer_tpu as lr
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.bridge import params_from_numpy
from test_torch_instancing import G_ATOL_REL, _assert_images_agree
from torch_m10_scenes import instancing_dict
from torch_threads import torch_threads_per_worker  # noqa: F401


def test_instanced_bsdf_grad_matches_jax():
    """render_grad of mean(image) with respect to bsdfs.params, where the
    cap's rough-plastic row is used by instances alone."""
    d = instancing_dict(3, res=(12, 9), cap_bsdf={
        "type": "roughplastic", "alpha": 0.3,
        "diffuse_reflectance": {"type": "rgb", "value": [0.2, 0.6, 0.3]}})
    js = lr.load_dict(d)
    ts = lrt.load_dict(d, device="cpu")
    key = "bsdfs.params"
    _, jg, jimg = lr.render_grad(js, {key: lr.traverse(js)[key]},
                                 lambda im: jnp.mean(im), spp=8, seed=0)
    ref = np.asarray(jg[key])
    params = params_from_numpy({key: np.asarray(lr.traverse(js)[key])},
                               "cpu")
    _, tg, timg = lrt.render_grad(ts, params, lambda im: im.mean(), spp=8,
                                  seed=0)
    g = tg[key].numpy()
    cap = int(np.flatnonzero(ts.bsdfs.btype.numpy() == 8)[0])  # rough
    assert cap in ts.shape_bsdf.numpy()[ts.shape_prim_count.numpy() == 0]
    assert np.abs(ref[cap]).max() > 0 and np.isfinite(g[cap]).all()
    # the diffuse rows' entries are nan in both packages: every lane runs
    # the rough plastic's Fresnel on its own row, where eta = 0 gives
    # 1 / eta = inf, and the masked branch's zero cotangent times inf is
    # nan (ROADMAP Queue 3)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(ref))
    np.testing.assert_allclose(g, ref, rtol=0,
                               atol=G_ATOL_REL * np.nanmax(np.abs(ref)))
    _assert_images_agree(timg.numpy(), np.asarray(jimg))
