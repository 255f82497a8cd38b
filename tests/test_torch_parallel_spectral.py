"""The port's sample-sharded fast paths on a spectral scene
(liverrenderer_tpu_torch/parallel/mesh.py) against the JAX package's on
its 8-device virtual mesh: tests/test_torch_parallel_regen.py's fog
Cornell box in the spectral variant, 8 ranks' bodies in turn.

Tolerances (JAX's test_sharded_spectral_regen_and_replay): the
accumulator within rtol 1e-5 / atol 1e-5, the loss rtol 1e-5, the
media.params gradient rtol 1e-4 / atol 1e-8.
"""
import jax.numpy as jnp
import numpy as np

import liverrenderer_tpu as lr
from liverrenderer_tpu.parallel import mesh as jmesh
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.integrators import prb_replay as treplay
from test_torch_parallel import N, needs8
from test_torch_parallel_regen import KEY, fog_dict, regen_ranks
from test_torch_parallel_replay import replay_ranks
from torch_threads import torch_threads_per_worker  # noqa: F401


@needs8
def test_sharded_spectral_regen_and_replay_match_jax_mesh():
    """Spectral scenes go through the sharded fast paths unchanged: the
    packet-width pool and the CIE cotangent conversion (JAX's
    test_sharded_spectral_regen_and_replay)."""
    d = fog_dict()
    js = lr.load_dict(d, variant="spectral")
    ts = lrt.load_dict(d, device="cpu", variant="spectral")
    mesh = jmesh.make_mesh(N)
    ref = np.asarray(jmesh.render_regen_sharded(js, mesh, spp=8, seed=0))
    np.testing.assert_allclose(regen_ranks(ts, 8).numpy(), ref, rtol=1e-5,
                               atol=1e-5)
    assert treplay.replay_applicable(ts, {KEY: ts.media.params}, 8)
    jl, jg, _ = jmesh.render_grad_replay_sharded(
        js, mesh, {KEY: js.media.params}, jnp.mean, spp=8, seed=0)
    loss, g, _ = replay_ranks(ts, 8)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg[KEY]), rtol=1e-4,
                               atol=1e-8)
