"""render_grad of the bump-mapped, env-lit scenes against the JAX
package's on the CPU (split from tests/test_torch_bump_env_slice.py,
whose scenes and tolerances it shares).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import liverrenderer_tpu as lr
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.bridge import params_from_numpy
from test_torch_bump_env_slice import G_ATOL_REL, _assert_images_agree, _pair
from torch_threads import torch_threads_per_worker  # noqa: F401


@pytest.mark.parametrize("kind,key,seed", [
    ("bump_sky_proxy", "media.params", 1),
    ("bump_sky_proxy", "emitters.params", 1),
    ("env_nee_plane", "emitters.params", 0)])
def test_bump_env_render_grad_matches_jax(kind, key, seed):
    """render_grad of mean(image) through the replay adjoint.  The
    envmap's scale (emitters.params[env, 6]) reaches the loss through the
    replay's deferred env term at lane death and, on the plane, through
    NEE."""
    js, ts = _pair(kind, res=8)
    _, jg, jimg = lr.render_grad(js, {key: lr.traverse(js)[key]},
                                 lambda im: jnp.mean(im), spp=4, seed=seed)
    ref = np.asarray(jg[key])
    params = params_from_numpy({key: np.asarray(lr.traverse(js)[key])},
                               "cpu")
    _, tg, timg = lrt.render_grad(ts, params, lambda im: im.mean(), spp=4,
                                  seed=seed)
    g = tg[key].numpy()
    assert np.isfinite(g).all() and np.abs(ref).max() > 0
    np.testing.assert_allclose(g, ref, rtol=0,
                               atol=G_ATOL_REL * np.abs(ref).max())
    _assert_images_agree(timg.numpy(), np.asarray(jimg))
    if key == "media.params":
        assert g[0, 0:3].sum() < 0
    else:
        # a brighter sky brightens the image
        assert g[ts.emitters.env_index, 6] > 0
