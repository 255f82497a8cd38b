"""The principled BSDF's parameter gradient against the JAX package's on
the CPU (split from tests/test_torch_principled.py, whose scenes and
tolerances it shares).
"""
import jax.numpy as jnp
import numpy as np
import torch

import liverrenderer_tpu as lr
import liverrenderer_tpu_torch as lrt
from test_torch_principled import _scenes
from torch_m10_scenes import PRINCIPLED, bsdf_plane_dict
from torch_threads import torch_threads_per_worker  # noqa: F401


def test_principled_params_gradient_matches():
    """bsdfs.params through the replay adjoint, principled and
    principledthin rows in one scene, within 3e-6 of the largest entry."""
    d = bsdf_plane_dict(PRINCIPLED["clearcoat_sheen"], res=12)
    d["thin"] = {"type": "rectangle", "bsdf": PRINCIPLED["thin"],
                 "to_world": np.array([[0.4, 0, 0, 0.5], [0, 0.4, 0, 0.4],
                                       [0, 0, 0.4, 0.3], [0, 0, 0, 1.0]])}
    js, ts = _scenes(d)
    _, jg, _ = lr.render_grad(js, {"bsdfs.params": js.bsdfs.params},
                              lambda im: jnp.mean(im ** 2), spp=4, seed=3)
    _, tg, _ = lrt.render_grad(ts, {"bsdfs.params": ts.bsdfs.params},
                               lambda im: torch.mean(im ** 2), spp=4, seed=3)
    a = np.asarray(jg["bsdfs.params"])
    b = tg["bsdfs.params"].numpy()
    assert np.abs(a).max() > 0
    np.testing.assert_allclose(b, a, rtol=0, atol=3e-6 * np.abs(a).max())
