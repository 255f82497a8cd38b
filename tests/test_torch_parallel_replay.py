"""The port's sample-sharded replay gradient (liverrenderer_tpu_torch/
parallel/mesh.py: render_grad_replay_sharded through the PRB replay
adjoint) against the JAX package's on its 8-device virtual mesh, on
tests/test_torch_parallel_regen.py's fog Cornell box (split from that
file, whose scene, fixture, per-rank regen sum and tolerances it
shares): the 8 ranks' _local_replay_grad summed by hand, and the public
function as a world of one; its refusal outside the adjoint's domain.
Tolerances (JAX's own tests): losses rtol 1e-5, images rtol 1e-5 / atol
1e-6, media.params gradients rtol 1e-4 / atol 1e-8.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu.integrators import prb_replay as jreplay
from liverrenderer_tpu.parallel import mesh as jmesh
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.integrators import prb_replay as treplay
from liverrenderer_tpu_torch.parallel import mesh as tmesh
from test_torch_parallel import N, box_dict, needs8
from test_torch_parallel_regen import KEY, fog, regen_ranks  # noqa: F401
from torch_threads import torch_threads_per_worker  # noqa: F401


def replay_ranks(ts, spp):
    """The 8 ranks' replay gradients on the sharded regen primal's loss
    image, summed by hand -> (loss, gradient, image)."""
    n_pix = ts.film_w * ts.film_h
    params = {KEY: ts.media.params}
    loss, image, g_rgb = treplay._loss_from_acc(regen_ranks(ts, spp),
                                                torch.mean)
    spp_local, r = divmod(spp, N)
    g = torch.zeros_like(ts.media.params)
    for d in range(N):
        for base, n_valid, sl in ((0, N, spp_local), (spp_local * N, r, 1)):
            gd = tmesh._local_replay_grad(ts, params, g_rgb, 0, 0, base,
                                          n_valid, spp, n_pix, sl, d)
            if gd is not None:
                g = g + gd[KEY]
    return loss, g, image


@needs8
@pytest.mark.parametrize("spp", [16, 13])
def test_sharded_replay_ranks_match_jax_mesh(fog, spp):
    js, ts = fog
    jl, jg, ji = jmesh.render_grad_replay_sharded(
        js, jmesh.make_mesh(N), {KEY: js.media.params}, jnp.mean, spp=spp,
        seed=0)
    jg = np.asarray(jg[KEY])
    loss, g, image = replay_ranks(ts, spp)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(image.numpy(), np.asarray(ji), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4, atol=1e-8)
    assert np.abs(jg).max() > 0
    tl, tg, _ = tmesh.render_grad_replay_sharded(
        ts, tmesh.make_mesh(1, device="cpu"), {KEY: ts.media.params},
        torch.mean, spp=spp, seed=0)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tg[KEY].numpy(), jg, rtol=1e-4, atol=1e-8)


def test_replay_outside_its_domain_is_refused():
    """A gaussian filter is outside the replay adjoint's domain: JAX
    asserts, the port raises ValueError (ROADMAP Queue 3's convention)."""
    ts = lrt.load_dict(box_dict(rfilter="gaussian"), device="cpu")
    with pytest.raises(ValueError, match="replay adjoint's domain"):
        tmesh.render_grad_replay_sharded(
            ts, tmesh.make_mesh(1, device="cpu"),
            {"textures.data": ts.textures.data}, torch.mean, spp=4)
    js = lr.load_dict(box_dict(rfilter="gaussian"))
    assert not jreplay.replay_applicable(
        js, {"textures.data": js.textures.data}, 4)
