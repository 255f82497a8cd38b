"""The port's sample-sharded fast paths (liverrenderer_tpu_torch/
parallel/mesh.py: render_regen_sharded on the regenerating wavefront and
render_grad_replay_sharded through the PRB replay adjoint) against the
JAX package's on its 8-device virtual mesh, on tests/test_parallel.py's
fog Cornell box (volpath depth 3, box filter) at 12 x 12 (its spectral
variant: tests/test_torch_parallel_spectral.py; the replay gradient:
tests/test_torch_parallel_replay.py), with the fog cube scaled 0.98
where JAX's test scales it 0.99: at 0.99 the cube's top face lies in the
ceiling light's plane, and which of the two coplanar surfaces a ray hits
is decided by the last ulp of t (XLA contracts a*b + c into an FMA,
PyTorch does not), so ~8 % of the 12 x 12 image's pixels differ between
the two packages' plain regen renders alike
(`test_coplanar_light_tie_is_not_a_sharding_effect` holds that scene's
sharded render to the port's unsharded one).

The per-rank bodies (_sharded_regen_tile; _local_replay_grad in
tests/test_torch_parallel_replay.py) run for each of 8 ranks in turn and
are summed by hand; each rank walks the
(pixel, sample) pairs that the same JAX device walks (spp 13: one more
sample on ranks 0..4, the rest skip the remainder instead of walking a
masked dummy chunk).  The public functions run as a world of one.

Tolerances (JAX's own tests): accumulators within rtol 1e-5 / atol 1e-6
(spectral atol 1e-5), losses rtol 1e-5, media.params gradients rtol 1e-4
/ atol 1e-8.
"""
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu.parallel import mesh as jmesh
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.parallel import mesh as tmesh
from liverrenderer_tpu_torch.scene.transform import Transform
from test_torch_parallel import N, box_dict, needs8
from torch_threads import torch_threads_per_worker  # noqa: F401

KEY = "media.params"


def fog_dict(res=12, scale=0.98):
    d = box_dict(res, integrator="volpath")
    d["fog"] = {"type": "cube", "to_world": Transform().scale(scale).matrix,
                "bsdf": {"type": "null"},
                "interior": {"type": "homogeneous",
                             "sigma_t": {"type": "rgb", "value": [0.4] * 3},
                             "albedo": {"type": "rgb", "value": [0.5] * 3}}}
    return d


@pytest.fixture(scope="module")
def fog():
    d = fog_dict()
    return lr.load_dict(d), lrt.load_dict(d, device="cpu")


def regen_ranks(ts, spp):
    """The 8 ranks' regen films of render_regen_sharded's one tile,
    summed by hand -> (h, w, 4)."""
    n_pix = ts.film_w * ts.film_h
    spp_local, r = divmod(spp, N)
    acc = torch.zeros((n_pix, 4))
    for d in range(N):
        for base, n_valid, sl in ((0, N, spp_local), (spp_local * N, r, 1)):
            f = tmesh._sharded_regen_tile(ts, 0, 0, base, n_valid, spp,
                                          n_pix, sl, d)
            assert (f is None) == (d >= n_valid)
            if f is not None:
                acc += f
    return acc.view(ts.film_h, ts.film_w, 4)


@needs8
@pytest.mark.parametrize("spp", [16, 13])
def test_sharded_regen_ranks_match_jax_mesh(fog, spp):
    js, ts = fog
    ref = np.asarray(jmesh.render_regen_sharded(js, jmesh.make_mesh(N),
                                                spp=spp, seed=0))
    np.testing.assert_allclose(regen_ranks(ts, spp).numpy(), ref, rtol=1e-5,
                               atol=1e-6)
    one = tmesh.render_regen_sharded(ts, tmesh.make_mesh(1, device="cpu"),
                                     spp=spp, seed=0)
    np.testing.assert_allclose(one.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_coplanar_light_tie_is_not_a_sharding_effect():
    """JAX's own fog cube (scale 0.99, its top face in the light's plane):
    the port's 8 ranks equal the port's unsharded regen render; the port
    and the JAX package differ on a few pixels in the plain renders
    alike, most of them in the top rows, which look at the ceiling."""
    from liverrenderer_tpu.integrators import regen as jregen
    from liverrenderer_tpu_torch.integrators import regen as tregen
    d = fog_dict(scale=0.99)
    js, ts = lr.load_dict(d), lrt.load_dict(d, device="cpu")
    plain = tregen.render_regen(ts, 0, 16).numpy()
    np.testing.assert_allclose(regen_ranks(ts, 16).numpy(), plain,
                               rtol=1e-5, atol=1e-6)
    ref = np.asarray(jregen.render_regen(js, 0, 16))
    off = ~np.isclose(plain, ref, rtol=1e-5, atol=1e-6).all(-1)
    top = off[:5].sum()
    assert 0 < off.sum() <= 16 and 2 * top > off.sum(), np.argwhere(off)
