"""Gradients of scenes loaded from XML files against the JAX package's on
the CPU (split from tests/test_torch_xml_slice.py, whose files, loaded
scenes and tolerances it shares).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import liverrenderer_tpu as lr
import liverrenderer_tpu_torch as lrt
from test_torch_xml_slice import loaded, scene_files  # noqa: F401
from torch_threads import torch_threads_per_worker  # noqa: F401


@pytest.mark.parametrize("name,seed,atol_rel", [("sphere", 0, 4e-7),
                                                ("proxy", 1, 3e-6)])
def test_load_file_grad_matches_jax(loaded, name, seed, atol_rel):
    js, ts = loaded[name]
    key = "media.params"
    _, jg, _ = lr.render_grad(js, {key: lr.traverse(js)[key]},
                              lambda im: jnp.mean(im), spp=4, seed=seed)
    _, tg, _ = lrt.render_grad(ts, {key: ts.media.params},
                               lambda im: im.mean(), spp=4, seed=seed)
    ref, g = np.asarray(jg[key]), tg[key].numpy()
    assert np.isfinite(g).all() and np.abs(ref).max() > 0
    np.testing.assert_allclose(g, ref, rtol=0,
                               atol=atol_rel * np.abs(ref).max())
