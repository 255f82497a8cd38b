"""Differentiable rendering: gradients of image losses with respect to scene
parameters (counterpart of liverrenderer_tpu/integrators/prb.py).

`render_grad` runs the PRB replay adjoint (prb_replay.py) wherever it
applies and the scan adjoint otherwise (the fixed-wavefront scenes, and
every volprim_rf_basic scene: the replay does not carry it): each render
pass walks exactly max_depth bounces (`path.sample`, `volpath.sample` or
`volprim.sample` with mode="ad", every bounce under an activation
checkpoint) and reverse-mode autograd differentiates it, with the
detached-sampling rules of the bounce.  A stokes scene raises where a
parameter reaches its loop, as in the JAX package.  Passes are
independent Monte Carlo estimates, so the gradient of their sum is the
sum of per-pass gradients; the counter RNG makes each pass walk the
primal's paths.

When the vertices are differentiated, the visibility boundary terms of
integrators/projective.py are added to either adjoint's interior
gradient: the primarily visible silhouettes and those seen from interior
path vertices.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..scene.ir import Scene
from ..util import _leaf, apply_params
from .common import MAX_WAVEFRONT, _render_jit, render_pass
from .projective import boundary_gradient, indirect_boundary_gradient
from .prb_replay import (_detach, _leaves, _loss_from_acc,
                         render_grad_replay, replay_applicable)
from .regen import regen_applicable, render_regen

Tensor = torch.Tensor

# The JAX package's stokes loop is a lax.while_loop, which JAX does not
# differentiate in reverse mode: its render_grad raises whenever a
# parameter reaches the loop (and gives zeros when none does).  The port
# refuses the same cases rather than add a gradient the reference lacks.
_STOKES_REFUSAL = ("render_grad: reverse-mode differentiation does not "
                   "work for the stokes integrator's while loop, as in the "
                   "JAX package")


def _grad_jit(scene: Scene, params: Dict[str, Tensor], seed, spp: int,
              spp_pass: int, loss_fn: Callable):
    """The scan adjoint -> (loss, grads, image)."""
    n_passes = (spp + spp_pass - 1) // spp_pass
    keys, values = _leaves(scene, params)
    sc_primal = _detach(apply_params(scene, dict(zip(keys, values))))
    # the primal image for dL/dI: on the regenerating wavefront where it
    # applies, else the same fixed passes as the adjoint differentiates;
    # dL/dI on an independent primal keeps the adjoint unbiased
    with torch.no_grad():
        if regen_applicable(sc_primal, "primal"):
            acc = render_regen(sc_primal, seed, spp)
        else:
            acc = sum(render_pass(sc_primal, seed, spp_pass, i * spp_pass,
                                  mode="ad") for i in range(n_passes))
    loss, image, g_rgb = _loss_from_acc(acc, loss_fn)
    # develop(total) divides by the total filter weight, which carries no
    # parameter dependence: each pass's rgb meets d loss / d rgb
    g_rgb = g_rgb.view(acc.shape[:-1] + (3,))

    grads = [torch.zeros_like(v) for v in values]
    for i in range(n_passes):
        leaves = [v.requires_grad_() for v in (x.detach() for x in values)]
        with torch.enable_grad():
            sc = apply_params(scene, dict(zip(keys, leaves)))
            acc_i = render_pass(sc, seed, spp_pass, i * spp_pass, mode="ad")
            f = torch.sum(acc_i[..., 0:3] * g_rgb)
            if not f.requires_grad:
                continue
            if scene.integrator == "stokes":
                raise ValueError(_STOKES_REFUSAL)
            gs = torch.autograd.grad(f, leaves, allow_unused=True)
        grads = [g if gi is None else g + gi for g, gi in zip(grads, gs)]
    return loss, dict(zip(keys, grads)), image


def _render_grad_scan(scene: Scene, params: Dict[str, Tensor],
                      loss_fn: Callable, spp: int, seed: int,
                      spp_pass: int | None):
    n_pix = scene.film_w * scene.film_h
    max_pass = max(1, min(spp, (MAX_WAVEFRONT // 4) // max(n_pix, 1)))
    spp_pass = spp_pass or max_pass
    while spp % spp_pass != 0:
        spp_pass -= 1
    return _grad_jit(scene, params, seed, spp, spp_pass, loss_fn)


def render_grad(scene: Scene, params: Dict[str, Tensor], loss_fn: Callable,
                spp: int = 16, seed: int = 0, spp_pass: int | None = None,
                replay: bool | None = None):
    """Differentiable render: (loss, grads with respect to params, image).

    `params` maps util.traverse keys to tensors; `loss_fn` maps the
    developed (h, w, 3) image to a scalar tensor.  Runs on the scene's
    device.  The PRB replay adjoint serves every configuration it
    applies to; replay=False forces the scan adjoint.  With "vertices" in
    params the boundary terms are added to its gradient: the primary one
    and the indirect one with prefixes of up to min(3, max_depth - 2)
    bounces, at their default sample counts and guiding."""
    for k in params:
        _leaf(k)       # raises for unknown keys
    if replay is None:
        replay = replay_applicable(scene, params, spp)
    if replay:
        out = render_grad_replay(scene, params, loss_fn, spp=spp, seed=seed)
    else:
        out = _render_grad_scan(scene, params, loss_fn, spp, seed, spp_pass)
    if "vertices" not in params:
        return out
    loss, grads, image = out
    im = image.detach().requires_grad_()
    with torch.enable_grad():
        (delta,) = torch.autograd.grad(loss_fn(im), im)
    g_b = boundary_gradient(scene, params, delta, seed=seed + 7)
    g_i = indirect_boundary_gradient(
        scene, params, delta, seed=seed + 13,
        depth_max=max(1, min(3, scene.max_depth - 2)))
    grads = dict(grads)
    grads["vertices"] = grads["vertices"] + g_b + g_i
    return loss, grads, image


def render_fwd_grad(scene: Scene, params: Dict[str, Tensor], spp: int = 16,
                    seed: int = 0):
    """Forward mode: (image, d image / d params . ones), a JVP with unit
    tangents through the scan walk (the reference's
    ADIntegrator.render_forward).  Callers wanting another direction pass
    scaled params."""
    keys, values = _leaves(scene, params)

    def f(*vals):
        return _render_jit(apply_params(scene, dict(zip(keys, vals))), seed,
                           spp, spp, "ad")

    tangents = tuple(torch.ones_like(v) for v in values)
    return torch.func.jvp(f, tuple(values), tangents)
