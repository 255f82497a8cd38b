"""The primary boundary term per sample, and render_grad of the
vertices, against the JAX package's on tests/test_projective.py's
occluder and two-mirror scenes (split from tests/test_torch_projective.py,
whose scenes, fixture and tolerance they share): render_grad runs the
replay adjoint plus both boundary terms at their defaults."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu.integrators import projective as jproj
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.integrators import projective as tproj
from test_torch_projective import (_delta, _grad_close, _scenes,
                                   shape_scenes)  # noqa: F401
from torch_m10_scenes import occluder_dict, right_edge_mask
from torch_threads import torch_threads_per_worker  # noqa: F401


def test_render_grad_vertices_matches():
    """render_grad of the vertices on the occluder scene at 16^2, 8 spp
    (the replay adjoint plus both boundary terms at their defaults):
    within 1e-4 of the largest |entry|; the right edge's derivative is
    negative (growing the dark occluder darkens the image)."""
    js, ts = _scenes(occluder_dict(16))
    lj, gj, ij = lr.render_grad(js, {"vertices": js.vertices},
                                lambda im: jnp.mean(im), spp=8, seed=5)
    lt, gt, it = lrt.render_grad(ts, {"vertices": ts.vertices}, torch.mean,
                                 spp=8, seed=5)
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=1e-5,
                               atol=1e-6)
    _grad_close(gt["vertices"], gj["vertices"], "vertices")
    mask, n = right_edge_mask(ts.vertices.numpy(), 0.0, 0.3)
    assert n == 2
    assert float((gt["vertices"] * torch.from_numpy(mask)).sum()) < 0


@pytest.mark.parametrize("name", ["occluder", "two_mirror"])
def test_boundary_samples_match(shape_scenes, name):
    """The primary term per sample: the same edges; |contribution| within
    rtol 1e-4 on lanes both packages keep; at most 0.1 % of lanes kept by
    one package only."""
    js, ts = shape_scenes[name]
    n = 1 << 12
    delta = _delta(js.film_h, js.film_w)
    jv, jf = jproj.edge_table(np.asarray(js.faces), js.n_tris)
    tv, tf = tproj.edge_table(ts.faces, ts.n_tris)
    jw = jproj._sil_weights_jit(js, js.vertices, jv, jf)
    tw = tproj.silhouette_weights(ts, ts.vertices, tv, tf)[0]
    _, jm, je = jproj._boundary_grad_jit(js, js.vertices, jv, jf,
                                         jnp.asarray(delta), jw, 3, n, 6)
    _, tm, te = tproj._boundary_grad(ts, ts.vertices, tv, tf,
                                     torch.from_numpy(delta), tw, 3, n, 6)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    jm, tm = np.asarray(jm), tm.numpy()
    both = (jm > 0) & (tm > 0)
    assert both.sum() > 100
    np.testing.assert_allclose(tm[both], jm[both], rtol=1e-4)
    assert ((jm > 0) != (tm > 0)).mean() <= 1e-3
