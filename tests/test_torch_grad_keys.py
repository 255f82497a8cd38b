"""Parameter traversal of the port (split from tests/test_torch_grad.py):
the keys `traverse` lists, `apply_params` replacing one leaf without a
copy, SceneParameters, and render_grad of the vertices on the liver proxy
(320 triangles, depth 12) bridged from the JAX-built scene.  That render
only shows that the key reaches a finite gradient of the vertices' shape
(tests/test_torch_projective.py holds the values to the JAX package's),
so its two boundary terms take 4,096 samples instead of their default
65,536, for the suite's clock.
"""
import functools

import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.bridge import numpy_tree, scene_from_numpy
from liverrenderer_tpu_torch.integrators import prb
from liverrenderer_tpu_torch.scene.liver_proxy import liver_proxy_dict
from liverrenderer_tpu_torch.util import SceneParameters
from torch_threads import torch_threads_per_worker  # noqa: F401


@pytest.fixture(scope="module")
def scenes():
    """The liver proxy (320 triangles, depth 12) in both packages."""
    js = lr.load_dict(liver_proxy_dict(16, 12, 4, 2, 0))
    return js, scene_from_numpy(*numpy_tree(js), "cpu")


def few_boundary_samples(monkeypatch):
    """render_grad's boundary terms at 4,096 samples."""
    for name in ("boundary_gradient", "indirect_boundary_gradient"):
        monkeypatch.setattr(prb, name, functools.partial(
            getattr(prb, name), n_samples=1 << 12))


def test_traverse_and_apply_params_keys(scenes, monkeypatch):
    few_boundary_samples(monkeypatch)
    _, ts = scenes
    sp = lrt.traverse(ts)
    assert set(sp.keys()) == {"media.params", "bsdfs.params",
                              "emitters.params", "textures.data",
                              "textures.bitmaps", "media.grids",
                              "volprims.opacity", "volprims.sh",
                              "vertices"}
    new = torch.full_like(ts.media.params, 0.5).requires_grad_()
    sc = lrt.apply_params(ts, {"media.params": new})
    # replaced without a copy, everything else shared
    assert sc.media.params is new and sc.tri_buf is ts.tri_buf
    assert sc.bsdfs is ts.bsdfs and ts.media.params is not new
    sp2 = SceneParameters(ts, ["bsdfs.params"])
    sp2["bsdfs.params"] = np.full(tuple(ts.bsdfs.params.shape), 2.0)
    assert float(sp2.update().bsdfs.params[0, 0]) == 2.0
    # the vertices traverse, and render_grad returns their gradient
    V = lrt.traverse(ts, ["vertices"])["vertices"]
    assert V is ts.vertices
    _, g, _ = lrt.render_grad(ts, {"vertices": V}, torch.mean, spp=1)
    assert g["vertices"].shape == V.shape
    assert torch.isfinite(g["vertices"]).all()
    with pytest.raises(KeyError):
        lrt.apply_params(ts, {"sensor.fov": 1.0})
