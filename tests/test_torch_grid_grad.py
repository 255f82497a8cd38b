"""The media.grids gradient through the replay adjoint against the JAX
package's on the CPU (split from tests/test_torch_grid_slice.py, whose
scenes and tolerances it shares).
"""
import numpy as np

import liverrenderer_tpu as lr
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.bridge import params_from_numpy
from liverrenderer_tpu_torch.scene.cornell import grid_cube_dict
from test_torch_grid_slice import G_ATOL_REL, POINT, _assert_images_agree
from torch_threads import torch_threads_per_worker  # noqa: F401


def test_grid_gradient_replay_matches_jax():
    """d loss / d media.grids through the replay adjoint (the scene is
    regen-able) against JAX render_grad, in every voxel; non-zero where
    the camera sees the cube, and zero in the unused channels."""
    d = grid_cube_dict(8, scale=2.0, max_depth=4, light=POINT)
    js, ts = lr.load_dict(d), lrt.load_dict(d, device="cpu")
    key = "media.grids"

    def loss(im):
        return (im * im).mean()

    _, jg, jimg = lr.render_grad(js, {key: js.media.grids}, loss, spp=4,
                                 seed=2)
    params = params_from_numpy({key: np.asarray(js.media.grids)}, "cpu")
    _, tg, timg = lrt.render_grad(ts, params, loss, spp=4, seed=2)
    g, ref = tg[key].numpy(), np.asarray(jg[key])
    _assert_images_agree(timg.numpy(), np.asarray(jimg))
    assert np.isfinite(g).all() and g.shape == ref.shape
    assert (g[..., 0] != 0).mean() > 0.5 and not g[..., 1:].any()
    # the voxels at the grid's maximum (x = 1) have sigma_n = 0 there, and
    # the ratio-tracking null weight majorant / max(sigma_n, 1e-30) gives
    # them ~1e21-1e25 in both packages: held by rtol, the rest against
    # the largest of the others
    big = np.abs(ref) > 1e3
    assert big.any() and (np.argwhere(big[..., 0])[:, 3] == 7).all()
    scale = np.abs(ref[~big]).max()
    assert scale > 0
    np.testing.assert_allclose(g, ref, rtol=1e-4, atol=G_ATOL_REL * scale)
