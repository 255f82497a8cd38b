"""A reconstruction filter's gradient through the scan adjoint against
the JAX package's on the CPU (split from
tests/test_torch_emitters_samplers.py, whose scenes and tolerances it
shares).
"""
import jax.numpy as jnp
import numpy as np

import liverrenderer_tpu as lr
import liverrenderer_tpu_torch as lrt
from test_torch_emitters_samplers import (G_ATOL_REL, _assert_images_agree,
                                          _pair, _plane)
from torch_threads import torch_threads_per_worker  # noqa: F401


def test_mitchell_scan_adjoint_gradient_matches_jax():
    """bsdfs.params of a rough conductor through the scan adjoint (a
    mitchell filter sends render_grad there)."""
    d = _plane(rfilter="mitchell", res=8)
    d["plane"]["bsdf"] = {"type": "roughconductor", "alpha": 0.3,
                          "material": "Al"}
    js, ts = _pair(d)
    key = "bsdfs.params"
    _, jg, jimg = lr.render_grad(js, {key: lr.traverse(js)[key]},
                                 lambda im: jnp.mean(im), spp=4, seed=0)
    _, tg, timg = lrt.render_grad(ts, {key: ts.bsdfs.params},
                                  lambda im: im.mean(), spp=4, seed=0)
    ref, g = np.asarray(jg[key]), tg[key].numpy()
    assert np.isfinite(g).all() and np.abs(ref).max() > 0
    np.testing.assert_allclose(g, ref, rtol=0,
                               atol=G_ATOL_REL * np.abs(ref).max())
    _assert_images_agree(timg.numpy(), np.asarray(jimg))
