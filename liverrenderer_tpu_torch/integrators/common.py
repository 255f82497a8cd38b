"""Render orchestration (counterpart of
liverrenderer_tpu/integrators/common.py): the regenerating wavefront where
it applies, else fixed-wavefront passes accumulated on the film."""
from __future__ import annotations

import torch

from .. import film as film_mod
from ..core.rng import make_sampler
from ..errors import not_ported
from ..scene.ir import Scene
from ..sensor.perspective import ray_weight, sample_ray
from . import volpath as volpath_mod

MAX_WAVEFRONT = 1 << 22   # lanes per pass

_VOLPATH_FAMILY = ("volpath", "biovolpath", "biovolpath06")


def _integrator_sample(scene: Scene, sampler, ray, mode="primal"):
    if scene.integrator in _VOLPATH_FAMILY:
        return volpath_mod.sample(scene, sampler, ray, mode=mode)
    raise not_ported(f"the {scene.integrator!r} integrator",
                     "Queue 1 M8/M10")


def render_pass(scene: Scene, seed: int, spp_pass: int, sample_offset: int,
                mode: str = "primal"):
    """One pass of h*w*spp_pass lanes -> (h, w, 4) film accumulator."""
    w, h = scene.film_w, scene.film_h
    n = w * h * spp_pass
    lane = torch.arange(n, device=scene.device)
    pix = lane // spp_pass
    samp = lane % spp_pass + sample_offset
    sampler = make_sampler(pix, samp, seed, kind=scene.sampler_kind)
    px = (pix % w).to(torch.float32)
    py = (pix // w).to(torch.float32)
    uf, sampler = sampler.next_2d()
    pos = torch.stack([px, py], -1) + uf
    ray = sample_ray(scene, pos)
    L, _, _ = _integrator_sample(scene, sampler, ray, mode=mode)
    L = torch.where(torch.isfinite(L), L, 0.0)
    rw = ray_weight(scene)
    if rw != 1.0:
        L = L * rw
    return film_mod.splat(w, h, scene.rfilter, pos, L)


def _render_jit(scene: Scene, seed, spp: int, spp_pass: int,
                mode: str = "primal"):
    """The JAX package's jitted pass loop, as a plain loop."""
    acc = torch.zeros((scene.film_h, scene.film_w, 4), device=scene.device)
    for i in range((spp + spp_pass - 1) // spp_pass):
        acc += render_pass(scene, seed, spp_pass, i * spp_pass, mode)
    return film_mod.develop(acc)


@torch.no_grad()
def render(scene: Scene, spp: int | None = None, seed: int = 0,
           mode: str = "primal", control=None):
    """Render the scene to an (h, w, 3) linear-RGB image on scene.device."""
    spp = spp or scene.spp
    from .regen import regen_applicable, render_regen_host
    if regen_applicable(scene, mode):
        return film_mod.develop(render_regen_host(scene, seed, spp,
                                                  control=control))
    if control is not None:
        raise not_ported("RenderControl on the fixed wavefront",
                         "Queue 1 M12")
    n_pix = scene.film_w * scene.film_h
    spp_pass = max(1, min(spp, MAX_WAVEFRONT // max(n_pix, 1)))
    while spp % spp_pass != 0:
        spp_pass -= 1
    return _render_jit(scene, seed, spp, spp_pass, mode)
