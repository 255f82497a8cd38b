"""The optimization checkpointer and the partial-render develop
(liverrenderer_tpu_torch/checkpoint.py) on the CPU:
tests/test_parallel.py::test_checkpoint_roundtrip's semantics with a
torch.optim.Adam state, retention equal to the JAX package's orbax
checkpointer's, restore onto the devices of the given tensors, atomic
writes, and the SIGUSR1 develop.
"""
import os
import signal

import numpy as np
import pytest
import torch

import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.checkpoint import (OptimizationCheckpointer,
                                                install_partial_develop)
from torch_threads import torch_threads_per_worker  # noqa: F401


def _state(step=True):
    params = {"a": torch.arange(4.0), "b": torch.ones((2, 3)) * 2}
    leaves = [p.requires_grad_(True) for p in params.values()]
    opt = torch.optim.Adam(leaves, lr=0.1)
    if step:
        sum((p * p).sum() for p in leaves).backward()
        opt.step()
    return params, opt


def test_checkpoint_roundtrip(tmp_path):
    params, opt = _state()
    ck = OptimizationCheckpointer(str(tmp_path / "ck"))
    assert ck.latest_step() is None
    assert ck.restore(params, opt.state_dict()) is None
    ck.save(3, params, opt.state_dict())
    ck.save(7, params, opt.state_dict())
    assert ck.latest_step() == 7
    fresh, fresh_opt = _state(step=False)
    step, p2, s2 = ck.restore(fresh, fresh_opt.state_dict())
    assert step == 7
    np.testing.assert_array_equal(p2["a"].detach().numpy(),
                                  params["a"].detach().numpy())
    np.testing.assert_array_equal(p2["b"].detach().numpy(),
                                  params["b"].detach().numpy())
    fresh_opt.load_state_dict(s2)
    for k, v in opt.state_dict()["state"].items():
        got = fresh_opt.state_dict()["state"][k]
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(got[name], v[name]), (k, name)
    assert ck.restore(fresh, fresh_opt.state_dict(), step=3)[0] == 3
    assert not [n for n in os.listdir(tmp_path / "ck")
                if n.endswith(".tmp")]
    ck.close()


def test_retention_matches_orbax(tmp_path):
    """The steps left after 5 saves with keep=3: the newest three, as the
    JAX package's orbax manager keeps them."""
    pytest.importorskip("orbax.checkpoint")
    import jax.numpy as jnp
    import optax

    from liverrenderer_tpu.checkpoint import \
        OptimizationCheckpointer as JaxCheckpointer
    jp = {"a": jnp.arange(4.0)}
    jst = optax.adam(0.1).init(jp)
    jck = JaxCheckpointer(str(tmp_path / "jax"), keep=3)
    params, opt = _state()
    ck = OptimizationCheckpointer(str(tmp_path / "torch"), keep=3)
    for step in (1, 2, 5, 9, 12):
        jck.save(step, jp, jst)
        ck.save(step, params, opt.state_dict())
    want = sorted(int(n) for n in os.listdir(tmp_path / "jax")
                  if n.isdigit())
    jck.close()
    assert ck.all_steps() == want == [5, 9, 12]
    assert ck.latest_step() == 12
    assert sorted(os.listdir(tmp_path / "torch")) == [
        "step_12.pt", "step_5.pt", "step_9.pt"]


def test_restore_onto_the_given_devices(tmp_path):
    """Each tensor lands on the device of its counterpart in the *_like
    trees; optimizer state the fresh state_dict lacks follows the params'
    device ("meta" stands in for a second device here)."""
    params, opt = _state()
    ck = OptimizationCheckpointer(str(tmp_path))
    ck.save(1, params, opt.state_dict())
    like = {"a": torch.empty(4, device="meta"),
            "b": torch.empty((2, 3), device="meta")}
    step, p, s = ck.restore(like, _state(step=False)[1].state_dict())
    assert step == 1
    assert all(t.device.type == "meta" for t in p.values())
    assert all(t.device.type == "meta" for st in s["state"].values()
               for t in st.values())
    assert s["param_groups"] == opt.state_dict()["param_groups"]


def test_partial_develop_on_sigusr1(tmp_path):
    frame = torch.linspace(0, 1, 8 * 6 * 3).reshape(8, 6, 3)
    path = str(tmp_path / "partial.exr")
    old = {s: signal.getsignal(s) for s in (signal.SIGHUP, signal.SIGUSR1)}
    try:
        install_partial_develop(lambda: frame, path)
        os.kill(os.getpid(), signal.SIGUSR1)
        np.testing.assert_array_equal(lrt.read_image(path), frame.numpy())
        os.remove(path)
        install_partial_develop(lambda: 1 / 0, path)   # a failing frame
        os.kill(os.getpid(), signal.SIGHUP)
        assert not os.path.exists(path)
    finally:
        for s, h in old.items():
            signal.signal(s, h)
