"""Gradients of polarized (stokes) scenes in the port and the JAX package
on the CPU (split from tests/test_torch_stokes.py, whose scenes and
tolerances they share): reverse mode refused as JAX's is, forward mode
equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
import liverrenderer_tpu_torch as lrt
from test_torch_stokes import _assert_images_agree
import torch_m10_scenes as ms
from torch_threads import torch_threads_per_worker  # noqa: F401


def test_render_grad_of_a_stokes_scene_refused_as_in_jax():
    """JAX cannot differentiate the stokes loop (a lax.while_loop) in
    reverse mode: render_grad raises when a parameter reaches the loop,
    and gives zeros when none does.  The port does the same."""
    d = ms.area_floor_dict(res=4)
    js, ts = lr.load_dict(d), lrt.load_dict(d, device="cpu")
    key = "emitters.params"      # the lamp's radiance reaches the loop
    with pytest.raises(ValueError, match="while_loop"):
        lr.render_grad(js, {key: js.emitters.params}, jnp.mean, spp=1)
    with pytest.raises(ValueError, match="while loop"):
        lrt.render_grad(ts, {key: ts.emitters.params}, torch.mean, spp=1)
    # a diffuse scene's bsdfs.params never reach it: zeros in both
    key = "bsdfs.params"
    gj = lr.render_grad(js, {key: js.bsdfs.params}, jnp.mean, spp=1)[1]
    gt = lrt.render_grad(ts, {key: ts.bsdfs.params}, torch.mean, spp=1)[1]
    assert not np.asarray(gj[key]).any() and not gt[key].any()


def test_forward_gradient_of_a_stokes_scene_matches_jax():
    """Forward mode differentiates the stokes loop in both packages
    (JAX's JVP goes through its while_loop): render_fwd_grad of the
    lamp's radiance."""
    d = ms.area_floor_dict(res=4)
    js, ts = lr.load_dict(d), lrt.load_dict(d, device="cpu")
    key = "emitters.params"
    _, jv = lr.render_fwd_grad(js, {key: js.emitters.params}, spp=2)
    _, tv = lrt.render_fwd_grad(ts, {key: ts.emitters.params}, spp=2)
    _assert_images_agree(tv.numpy(), np.asarray(jv))
