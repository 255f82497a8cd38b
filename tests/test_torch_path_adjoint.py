"""The surface path family's adjoints against the JAX package's on the
CPU (split from tests/test_torch_path_slice.py, whose scenes, lane
helpers and tolerances they share): the VJP of one recorded bounce, and
render_grad through the scan adjoint on scenes the regenerating
wavefront does not take (a gaussian filter; the prb integrator).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu.integrators import path as jpath
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.integrators import path as tpath
from liverrenderer_tpu_torch.integrators import prb as tprb
from liverrenderer_tpu_torch.integrators import regen as tregen
from liverrenderer_tpu_torch.scene import cornell as tcornell
from test_torch_path_slice import (_assert_grads_equal, _assert_images_equal,
                                   _grads, _pair, _to_port_state,
                                   cornell_lanes)  # noqa: F401
from torch_threads import torch_threads_per_worker  # noqa: F401


def test_recorded_bounce_vjp_matches_jax(cornell_lanes, np_rng):
    """The VJP of one recorded bounce (ad=True: detached continuation,
    smooth lobes re-evaluated) with respect to textures.data and
    bsdfs.params, for random cotangents on L and the throughput."""
    js, ts, _, st1 = cornell_lanes
    ct_l = np_rng.normal(size=(1024, 3)).astype(np.float32)
    ct_t = np_rng.normal(size=(1024, 3)).astype(np.float32)
    keys = ("textures.data", "bsdfs.params")
    jp = {k: lr.traverse(js)[k] for k in keys}

    def jf(p):
        st2 = jpath.bounce(lr.apply_params(js, p), st1, True)
        return jnp.sum(st2.L * ct_l) + jnp.sum(st2.throughput * ct_t)
    jg = jax.jit(jax.grad(jf))(jp)

    leaves = {k: torch.tensor(np.asarray(v), requires_grad=True)
              for k, v in jp.items()}
    st2 = tpath.bounce(lrt.apply_params(ts, leaves), _to_port_state(st1),
                       True)
    f = torch.sum(st2.L * torch.from_numpy(ct_l)) \
        + torch.sum(st2.throughput * torch.from_numpy(ct_t))
    tg = torch.autograd.grad(f, list(leaves.values()))
    for k, g in zip(keys, tg):
        ref = np.asarray(jg[k])
        assert np.abs(ref).max() > 0, k
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=k)


@pytest.mark.parametrize("integrator,rfilter",
                         [("path", "gaussian"), ("prb", "box")])
def test_scan_adjoint_matches_jax(integrator, rfilter, monkeypatch):
    """render_grad of mean(image^2) with respect to textures.data on
    scenes the regenerating wavefront does not take (a gaussian filter; the
    prb integrator): the scan adjoint, whose primal image (the loss, dL/dI
    and the develop weights) comes from the same fixed passes it
    differentiates, as in the JAX package."""
    d = tcornell.plane_light_dict(8, integrator=integrator, max_depth=3)
    d["sensor"]["film"]["rfilter"] = {"type": rfilter}
    js, ts = _pair(d)
    assert not tregen.regen_applicable(ts, "primal")

    def no_regen(*a, **k):
        raise AssertionError("regen render on a non-regen scene")
    monkeypatch.setattr(tprb, "render_regen", no_regen)
    (ref, jimg), (g, timg) = _grads(
        js, ts, "textures.data", spp=4,
        loss=("mse", lambda im: jnp.mean(im * im),
              lambda im: torch.mean(im * im)))
    _assert_grads_equal(g, ref)
    _assert_images_equal(timg, jimg)
