"""The projective boundary terms of the port against the JAX package on
identical inputs (split from tests/test_torch_projective.py, whose
scenes, fixture and tolerance helpers it shares): both terms with and
without guiding on tests/test_projective.py's occluder, rough-mirror and
two-mirror scenes, and their scope (mesh-only; zero where z_d's BSDF is
a delta lobe).  Gradients within 1e-4 of their largest |entry| (per-lane
fp32 differences summed over 4,096 samples).
"""
import jax.numpy as jnp
import pytest
import torch

from liverrenderer_tpu.integrators import projective as jproj
from liverrenderer_tpu_torch.integrators import projective as tproj
from test_torch_projective import (SCENES, _delta, _grad_close, _scenes,
                                   shape_scenes)  # noqa: F401
from torch_m10_scenes import mirror_dict, occluder_dict
from torch_threads import torch_threads_per_worker  # noqa: F401


_TERMS = [("primary", "none", 1), ("primary", "edges", 1),
          ("indirect", "none", 1), ("indirect", "octree", 1),
          ("indirect", "none", 2)]


@pytest.mark.parametrize("term,guiding,depth", _TERMS)
@pytest.mark.parametrize("name", list(SCENES))
def test_boundary_gradient_matches(shape_scenes, name, term, guiding,
                                   depth):
    """Both terms, each guiding, 4,096 samples: within 1e-4 of the largest
    |entry|."""
    js, ts = shape_scenes[name]
    delta = _delta(js.film_h, js.film_w)
    kw = dict(seed=3, n_samples=1 << 12, guiding=guiding)
    if term == "primary":
        jfn, tfn = jproj.boundary_gradient, tproj.boundary_gradient
    else:
        jfn, tfn = (jproj.indirect_boundary_gradient,
                    tproj.indirect_boundary_gradient)
        kw["depth_max"] = depth
    j = jfn(js, {"vertices": js.vertices}, jnp.asarray(delta), **kw)
    t = tfn(ts, {"vertices": ts.vertices}, torch.from_numpy(delta), **kw)
    assert torch.isfinite(t).all()
    _grad_close(t, j, f"{name} {term} {guiding} {depth}")


def test_boundary_terms_mirror_the_jax_scope():
    """The boundary term is mesh-only (a sphere occluder contributes no
    silhouette), and the indirect term is zero where z_d's BSDF is a delta
    lobe (a smooth mirror), in both packages."""
    d = occluder_dict(12)
    d["occ"] = {"type": "sphere", "radius": 0.4,
                "bsdf": {"type": "diffuse"}}
    js, ts = _scenes(d)
    delta = _delta(12, 12)
    prm = {"vertices": ts.vertices}
    g = tproj.boundary_gradient(ts, prm, torch.from_numpy(delta),
                                n_samples=1 << 12)
    jgr = jproj.boundary_gradient(js, {"vertices": js.vertices},
                                  jnp.asarray(delta), n_samples=1 << 12)
    # only the background rectangle's rim: outside the film, no samples
    assert float(g.abs().max()) == 0.0 == float(jnp.abs(jgr).max())
    d = mirror_dict(12)
    d["mirror"]["bsdf"] = {"type": "conductor", "material": "Al"}
    js, ts = _scenes(d)
    g = tproj.indirect_boundary_gradient(
        ts, {"vertices": ts.vertices}, torch.from_numpy(delta),
        n_samples=1 << 12, guiding="none")
    jgr = jproj.indirect_boundary_gradient(
        js, {"vertices": js.vertices}, jnp.asarray(delta),
        n_samples=1 << 12, guiding="none")
    assert float(g.abs().max()) == 0.0 == float(jnp.abs(jgr).max())
