"""The port's multi-GPU module with real ranks: two processes join a gloo
world through `init_distributed` on the CPU (the counterpart of JAX's
test_init_distributed_two_process_smoke), all-reduce, and run the
sharded regen render, the sharded replay gradient and one SGD training
step.  The renders equal the in-process loop over the two ranks' bodies;
the training step's parameters equal the JAX package's optax.sgd step on
a 2-device mesh, which would fail if the film all-reduce's backward
counted the loss cotangent once per rank.

Tolerances: accumulators rtol 1e-5 / atol 1e-6, losses rtol 1e-5,
gradients rtol 1e-4 / atol 1e-8 (tests/test_parallel.py's); the SGD
step's parameters rtol 1e-4 / atol 1e-6.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu.parallel import mesh as jmesh
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.integrators import prb_replay as treplay
from liverrenderer_tpu_torch.parallel import mesh as tmesh
from test_torch_parallel import box_dict, free_port
from test_torch_parallel_regen import fog_dict
from torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
KEY = "media.params"

_WORKER = r"""
import pickle, sys
import numpy as np
import torch
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.parallel import mesh as tmesh

rank, port, workdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
with open(f"{workdir}/scenes.pkl", "rb") as f:
    fog, box = pickle.load(f)
tmesh.init_distributed(f"127.0.0.1:{port}", num_processes=2,
                       process_id=rank, device="cpu")
mesh = tmesh.make_mesh(device="cpu")
assert (mesh.rank, mesh.size) == (rank, 2), mesh
one = tmesh._all_reduce(torch.ones(3) * (rank + 1), mesh)
out = {"all_reduce": one.numpy()}

fs = lrt.load_dict(fog, device="cpu")
out["regen"] = tmesh.render_regen_sharded(fs, mesh, spp=13, seed=0).numpy()
loss, g, img = tmesh.render_grad_replay_sharded(
    fs, mesh, {"media.params": fs.media.params}, torch.mean, spp=13, seed=0)
out.update(loss=float(loss), grad=g["media.params"].numpy(),
           image=img.numpy())

bs = lrt.load_dict(box, device="cpu")
leaf = bs.textures.data.clone().requires_grad_()
step = tmesh.make_train_step(
    bs, mesh, lambda i, t: torch.mean((i - t) ** 2),
    torch.optim.SGD([leaf], lr=1.0), spp=8)
stats = tmesh.collective_stats(step, {"textures.data": leaf}, None,
                               torch.zeros(12, 12, 3), 0)
out.update(sgd=leaf.detach().numpy(), stats=stats)
with open(f"{workdir}/rank{rank}.pkl", "wb") as f:
    pickle.dump(out, f)
print("DIST_OK", rank)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results, from two processes over gloo."""
    work = tmp_path_factory.mktemp("dist")
    with open(work / "scenes.pkl", "wb") as f:
        pickle.dump((fog_dict(), box_dict()), f)
    (work / "worker.py").write_text(_WORKER)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(work / "worker.py"), str(r), str(port),
         str(work)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "DIST_OK" in out, \
            f"rank {r}:\n{out[-2000:]}"
    res = []
    for r in range(WORLD):
        with open(work / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


def test_init_distributed_two_process_all_reduce(ranks):
    for res in ranks:
        np.testing.assert_array_equal(res["all_reduce"], [3.0] * 3)


def test_sharded_regen_and_replay_equal_the_rank_loop(ranks):
    """Each rank returns the same film and gradient, equal to the two
    ranks' bodies run in turn in this process (spp 13: rank 0 walks the
    one remainder sample)."""
    ts = lrt.load_dict(fog_dict(), device="cpu")
    n_pix = ts.film_w * ts.film_h
    acc = torch.zeros((n_pix, 4))
    parts = []
    for d in range(WORLD):
        for base, n_valid, sl in ((0, WORLD, 6), (12, 1, 1)):
            f = tmesh._sharded_regen_tile(ts, 0, 0, base, n_valid, 13,
                                          n_pix, sl, d)
            if f is not None:
                acc += f
                parts.append((base, n_valid, sl, d))
    acc = acc.view(ts.film_h, ts.film_w, 4)
    loss, image, g_rgb = treplay._loss_from_acc(acc, torch.mean)
    g = torch.zeros_like(ts.media.params)
    for base, n_valid, sl, d in parts:
        g = g + tmesh._local_replay_grad(ts, {KEY: ts.media.params}, g_rgb,
                                         0, 0, base, n_valid, 13, n_pix, sl,
                                         d)[KEY]
    for res in ranks:
        np.testing.assert_allclose(res["regen"], acc.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(res["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(res["image"], image.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(res["grad"], g.numpy(), rtol=1e-4,
                                   atol=1e-8)
    assert np.abs(g.numpy()).max() > 0


@pytest.mark.skipif(len(jax.devices()) < WORLD,
                    reason="needs 2 virtual JAX devices")
def test_two_rank_sgd_step_matches_jax(ranks):
    """The two ranks' SGD step (lr 1: each entry moves by its gradient)
    equals JAX's optax.sgd step on make_mesh(2); the step issued the film
    all-reduce and one gradient all-reduce."""
    js = lr.load_dict(box_dict())
    opt = optax.sgd(1.0)
    params = {"textures.data": js.textures.data}
    step = jmesh.make_train_step(js, jmesh.make_mesh(WORLD),
                                 lambda i, t: jnp.mean((i - t) ** 2), opt,
                                 spp=8)
    new, _, _ = step(params, opt.init(params), jnp.zeros((12, 12, 3)),
                     jnp.uint32(0))
    ref = np.asarray(new["textures.data"])
    assert np.abs(ref - np.asarray(js.textures.data)).sum() > 0
    film_bytes = 12 * 12 * 4 * 4
    for res in ranks:
        np.testing.assert_allclose(res["sgd"], ref, rtol=1e-4, atol=1e-6)
        assert res["stats"]["all-reduce"]["ops"] == 2
        assert res["stats"]["all-reduce"]["bytes"] == \
            film_bytes + ref.size * 4
