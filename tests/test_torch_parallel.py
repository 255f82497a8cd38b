"""The port's multi-GPU module (liverrenderer_tpu_torch/parallel/mesh.py)
against the JAX package's on the CPU: the fixed-wavefront sample-sharded
render, the pixel-tiled render, the distributed training step, the
collective accounting and the scaling probe.

One torch process drives one device, so the per-rank bodies run here for
each of 8 ranks in turn and are summed (or assembled) by hand, against
the JAX function on its 8-device virtual mesh (tests/conftest.py).  The
public functions run as a world of one: without a process group, and as
a gloo world of one whose collectives are issued and counted.  Real
ranks in processes: tests/test_torch_parallel_dist.py.

Tolerances (JAX's own tests/test_parallel.py): the sample-sharded image
within atol 1e-4, the tiled ones within atol 1e-5; the training step's
updated parameters within rtol 1e-4 / atol 1e-6 (SGD) and atol 1e-5
(Adam's first step is lr * g / (|g| + eps): an entry whose gradient is
~eps moves by a fraction of lr).
"""
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import liverrenderer_tpu as lr
from liverrenderer_tpu.parallel import mesh as jmesh
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch import film as tfilm
from liverrenderer_tpu_torch.parallel import mesh as tmesh
from liverrenderer_tpu_torch.scene import cornell as tcornell
from torch_sensor_scenes import matrices
from torch_threads import torch_threads_per_worker  # noqa: F401

N = 8
needs8 = pytest.mark.skipif(len(jax.devices()) < N,
                            reason="needs 8 virtual JAX devices")


def box_dict(res=12, integrator="path", depth=3, rfilter="box"):
    d = tcornell.cornell_box()
    d["integrator"] = {"type": integrator, "max_depth": depth}
    d["sensor"]["film"] = {"type": "hdrfilm", "width": res, "height": res,
                           "rfilter": {"type": rfilter}}
    return matrices(d)


@pytest.fixture(scope="module")
def box():
    d = box_dict()
    return lr.load_dict(d), lrt.load_dict(d, device="cpu")


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def gloo_world_of_one():
    """A gloo process group of one rank: the public functions issue their
    collectives (trivially) through it."""
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        yield tmesh.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@needs8
@pytest.mark.parametrize("spp", [16, 13])
def test_sample_sharded_ranks_match_jax_mesh(box, spp):
    """Ranks 0..7 of _local_pass summed by hand = JAX render_sharded on
    make_mesh(8); spp 13 puts one extra sample on ranks 0..4."""
    js, ts = box
    ref = np.asarray(jmesh.render_sharded(js, jmesh.make_mesh(N), spp=spp,
                                          seed=0))
    spp_local, r = divmod(spp, N)
    acc = sum(tmesh._local_pass(ts, 0, spp_local, "primal", r, d, N)
              for d in range(N))
    np.testing.assert_allclose(tfilm.develop(acc).numpy(), ref, atol=1e-4)
    # the public function as a world of one: the whole spp on rank 0
    one = tmesh.render_sharded(ts, tmesh.make_mesh(1, device="cpu"),
                               spp=spp, seed=0)
    np.testing.assert_allclose(one.numpy(), ref, atol=1e-4)


@needs8
@pytest.mark.parametrize("interleave, rfilter", [
    (True, "box"), (False, "box"), (False, "gaussian")])
def test_pixel_tiled_ranks_match_jax_mesh(interleave, rfilter):
    """Ranks 0..7 of _tiled_local assembled = JAX render_tiled on
    make_mesh(8): 12 rows over 8 ranks leave padded rows (masked), and the
    gaussian's slabs clip its splat at their edges, as JAX's do."""
    d = box_dict(rfilter=rfilter)
    js, ts = lr.load_dict(d), lrt.load_dict(d, device="cpu")
    ref = np.asarray(jmesh.render_tiled(js, jmesh.make_mesh(N), spp=8,
                                        seed=0, interleave=interleave))
    slabs = torch.stack([tmesh._tiled_local(ts, 0, 8, "primal", interleave,
                                            d, N) for d in range(N)])
    got = tfilm.develop(tmesh._assemble(slabs, ts.film_h, interleave))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_pixel_tiled_world_of_one_matches_jax(box):
    js, ts = box
    ref = np.asarray(jmesh.render_tiled(js, jmesh.make_mesh(1), spp=8,
                                        seed=0))
    got = tmesh.render_tiled(ts, tmesh.make_mesh(1, device="cpu"), spp=8,
                             seed=0)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    with pytest.raises(ValueError, match="1 px filter"):
        gs = lrt.load_dict(box_dict(rfilter="gaussian"), device="cpu")
        tmesh.render_tiled(gs, tmesh.make_mesh(1, device="cpu"),
                           interleave=True)


def _loss_j(i, t):
    return jnp.mean((i - t) ** 2)


def _loss_t(i, t):
    return torch.mean((i - t) ** 2)


@needs8
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_train_step_matches_jax(box, opt):
    """One make_train_step step: the port's torch.optim step on a world
    of one updates textures.data as JAX's optax step on make_mesh(8)
    does, and the by-hand sum of 8 ranks' differentiated films gives the
    same gradient.  SGD (lr 1) moves each entry by its gradient, so a
    gradient scaled by any factor fails here."""
    js, ts = box
    key = "textures.data"
    p0 = np.asarray(js.textures.data)
    jopt = optax.sgd(1.0) if opt == "sgd" else optax.adam(1e-2)
    jstep = jmesh.make_train_step(js, jmesh.make_mesh(N), _loss_j, jopt,
                                  spp=N)
    jparams = {key: js.textures.data}
    target = np.zeros((12, 12, 3), np.float32)
    jnew, _, jloss = jstep(jparams, jopt.init(jparams), jnp.asarray(target),
                           jnp.uint32(0))
    jnew = np.asarray(jnew[key])

    leaf = torch.tensor(p0, requires_grad=True)
    topt = torch.optim.SGD([leaf], lr=1.0) if opt == "sgd" else \
        torch.optim.Adam([leaf], lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
    tstep = tmesh.make_train_step(ts, tmesh.make_mesh(1, device="cpu"),
                                  _loss_t, topt, spp=N)
    params, state, tloss = tstep({key: leaf}, None, torch.as_tensor(target),
                                 0)
    assert params[key] is leaf and "state" in state
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert np.abs(jnew - p0).sum() > 0
    if opt == "sgd":
        np.testing.assert_allclose(leaf.detach().numpy(), jnew, rtol=1e-4,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(leaf.detach().numpy(), jnew, atol=1e-5)

    # 8 ranks' slabs under autograd, summed by hand
    v = torch.tensor(p0, requires_grad=True)
    sc = lrt.apply_params(ts, {key: v})
    acc = sum(tmesh._local_pass(sc, 0, 1, "ad", 0, d, N) for d in range(N))
    loss = _loss_t(tfilm.develop(acc), torch.as_tensor(target))
    (g8,) = torch.autograd.grad(loss, v)
    if opt == "sgd":
        np.testing.assert_allclose(p0 - g8.numpy(), jnew, rtol=1e-4,
                                   atol=1e-6)


def test_collective_stats_counts_what_is_issued(box, gloo_world_of_one):
    """On a gloo world of one the train step issues the film all-reduce
    and one gradient all-reduce: at least film + parameter bytes in >= 2
    all-reduces (JAX's test_collective_stats_counts_psums); render_tiled
    issues one all-gather of the film; a world of one without a group
    issues nothing."""
    _, ts = box
    mesh = gloo_world_of_one
    assert (mesh.rank, mesh.size) == (0, 1) and mesh.group is not None
    leaf = torch.tensor(ts.textures.data.numpy(), requires_grad=True)
    step = tmesh.make_train_step(ts, mesh, _loss_t,
                                 torch.optim.Adam([leaf], lr=1e-2), spp=1)
    stats = tmesh.collective_stats(step, {"textures.data": leaf}, None,
                                   torch.zeros(12, 12, 3), 0)
    film_bytes = 12 * 12 * 4 * 4
    param_bytes = leaf.numel() * 4
    assert set(stats) == {"all-reduce"}, stats
    assert stats["all-reduce"]["ops"] == 2, stats
    assert stats["all-reduce"]["bytes"] == film_bytes + param_bytes, stats
    st = tmesh.collective_stats(tmesh.render_tiled, ts, mesh, spp=1)
    assert st == {"all-gather": {"ops": 1, "bytes": film_bytes}}, st
    assert tmesh.collective_stats(
        tmesh.render_sharded, ts, tmesh.make_mesh(1, device="cpu"),
        spp=1) == {}


def test_make_mesh_and_init_distributed_world_of_one():
    """make_mesh without a process group is a world of one; asking for
    more ranks than the world raises; init_distributed of one process is
    a no-op, as in the JAX package."""
    m = tmesh.make_mesh(device="cpu")
    assert (m.rank, m.size, m.group, m.device.type) == (0, 1, None, "cpu")
    assert tmesh.AXIS == jmesh.AXIS
    with pytest.raises(ValueError, match="one process drives one device"):
        tmesh.make_mesh(8, device="cpu")
    tmesh.init_distributed("127.0.0.1:1", num_processes=1, process_id=0)
    assert not dist.is_initialized()


def test_measure_scaling_smoke(box, gloo_world_of_one):
    """measure_scaling on a world of one: one device, so the proxy."""
    _, ts = box
    for renderer in ("pass", "regen"):
        stats = tmesh.measure_scaling(ts, spp=2, reps=1, renderer=renderer)
        assert stats["n_devices"] == 1
        assert stats["efficiency_proxy"] > 0.0
