"""The VJP of one bounce against the JAX package's on the CPU, plain and
bumped (split from tests/test_torch_grad.py, whose scenes, state
bridge and tolerances they share).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu.integrators import regen as jregen
from liverrenderer_tpu.integrators import volpath as jvp
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.bridge import (numpy_tree, params_from_numpy,
                                            scene_from_numpy)
from liverrenderer_tpu_torch.integrators import volpath as tvp
from liverrenderer_tpu_torch.scene.liver_proxy import liver_proxy_dict
from test_torch_grad import (KEYS, VJP_ATOL, VJP_RTOL, _port_state,
                             scenes)  # noqa: F401
from torch_threads import torch_threads_per_worker  # noqa: F401


def test_bounce_vjp_matches_jax(scenes):
    """One bounce's VJP with respect to media.params and bsdfs.params on
    identical lane state (the JAX state after two bounces, inside the
    liver medium and at its boundary) and identical cotangents, against
    jax.vjp of the JAX bounce."""
    js, ts = scenes
    W = 768
    jst, _ = jregen._make_lanes(js, jnp.arange(W, dtype=jnp.uint32), 0, 4)
    for _ in range(2):
        jst = jvp.bounce(js, jst, False)
    tst = _port_state(jst)
    assert (tst.medium >= 0).any() and tst.active.any()
    rng = np.random.default_rng(11)
    cts = [rng.normal(size=(W, 3)).astype(np.float32) for _ in range(3)]
    jparams = {k: lr.traverse(js)[k] for k in KEYS}

    def jf(p):
        st2 = jvp.bounce(lr.apply_params(js, p), jst, False)
        return st2.L, st2.throughput, st2.env_weight

    _, vjp_fn = jax.vjp(jf, jparams)
    (jg,) = vjp_fn(tuple(jnp.asarray(c) for c in cts))

    leaves = {k: v.requires_grad_() for k, v in
              params_from_numpy({k: np.asarray(v) for k, v in
                                 jparams.items()}, "cpu").items()}
    st2 = tvp.bounce(lrt.apply_params(ts, leaves), tst)
    tg = torch.autograd.grad(
        (st2.L, st2.throughput, st2.env_weight), list(leaves.values()),
        grad_outputs=[torch.from_numpy(c) for c in cts], allow_unused=True)
    for k, g in zip(KEYS, tg):
        ref = np.asarray(jg[k])
        g = np.zeros_like(ref) if g is None else g.numpy()
        np.testing.assert_allclose(g, ref, rtol=VJP_RTOL, atol=VJP_ATOL,
                                   err_msg=k)
    assert np.abs(np.asarray(jg["media.params"])).max() > 1e-3
    assert np.abs(np.asarray(jg["bsdfs.params"])).max() > 1e-3


def test_bumped_bounce_vjp_matches_jax():
    """One bounce's VJP on the bumped, sky-lit proxy (a height map on the
    dielectric, an envmap): the bump frame turns the refraction whose eta
    is bsdfs.params, and a lane whose bumped wi changes hemisphere takes
    the JAX select chain.  media.params and bsdfs.params, as above; the
    sky's emitters.params row, which the bounce does not read (the replay
    evaluates the environment outside it), gets zero in both."""
    keys = KEYS + ("emitters.params",)
    js = lr.load_dict(liver_proxy_dict(16, 12, 4, 2, 0, bump=(32, 0.05),
                                       sky=(64, 32)))
    ts = scene_from_numpy(*numpy_tree(js), "cpu")
    assert ts.has_heightmap and ts.emitters.env_index >= 0
    W = 768
    jst, _ = jregen._make_lanes(js, jnp.arange(W, dtype=jnp.uint32), 0, 4)
    for _ in range(2):
        jst = jvp.bounce(js, jst, False)
    tst = _port_state(jst)
    assert (tst.medium >= 0).any() and tst.active.any()
    rng = np.random.default_rng(13)
    cts = [rng.normal(size=(W, 3)).astype(np.float32) for _ in range(3)]
    jparams = {k: lr.traverse(js)[k] for k in keys}

    def jf(p):
        st2 = jvp.bounce(lr.apply_params(js, p), jst, False)
        return st2.L, st2.throughput, st2.env_weight

    _, vjp_fn = jax.vjp(jf, jparams)
    (jg,) = vjp_fn(tuple(jnp.asarray(c) for c in cts))
    leaves = {k: v.requires_grad_() for k, v in params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, "cpu").items()}
    st2 = tvp.bounce(lrt.apply_params(ts, leaves), tst)
    tg = torch.autograd.grad(
        (st2.L, st2.throughput, st2.env_weight), list(leaves.values()),
        grad_outputs=[torch.from_numpy(c) for c in cts], allow_unused=True)
    for k, g in zip(keys, tg):
        ref = np.asarray(jg[k])
        g = np.zeros_like(ref) if g is None else g.numpy()
        np.testing.assert_allclose(g, ref, rtol=VJP_RTOL, atol=VJP_ATOL,
                                   err_msg=k)
        assert (np.abs(ref).max() > 1e-3) == (k in KEYS), k
