"""Render orchestration (counterpart of
liverrenderer_tpu/integrators/common.py): the regenerating wavefront where
it applies, else fixed-wavefront passes accumulated on the film."""
from __future__ import annotations

import torch

from .. import film as film_mod
from ..core.rng import make_sampler
from ..scene.ir import Scene
from ..sensor.perspective import APERTURE_SENSORS, ray_weight, sample_ray
from . import path as path_mod
from . import volpath as volpath_mod
from . import volpathmis as volpathmis_mod
from . import volprim as volprim_mod
from .stokes import sample_stokes

MAX_WAVEFRONT = 1 << 22   # lanes per pass
SSS_WAVEFRONT = 1 << 17   # lanes per pass of a subsurface scene

_VOLPATH_FAMILY = ("volpath", "biovolpath", "biovolpath06", "prbvolpath")
_PATH_FAMILY = ("path", "direct", "prb", "prb_basic")


def _integrator_sample(scene: Scene, sampler, ray, mode="primal"):
    if scene.integrator in _PATH_FAMILY:
        return path_mod.sample(scene, sampler, ray, mode=mode)
    if scene.integrator in _VOLPATH_FAMILY:
        return volpath_mod.sample(scene, sampler, ray, mode=mode)
    if scene.integrator == "volpathmis":
        if scene.spectral:
            # the wavelength-packet tracking subsumes the RGB channels'
            # MIS: a spectral volpathmis scene runs the volpath machinery,
            # as in the JAX package
            return volpath_mod.sample(scene, sampler, ray, mode=mode)
        # the JAX package sends an RGB volpathmis scene to volpath only
        # with bio transport on, which needs a biovolpath integrator
        # (volpath._has_bio): bio media reach volpathmis through the base
        # majorant sampling, so every RGB volpathmis scene runs its module
        return volpathmis_mod.sample(scene, sampler, ray, mode=mode)
    if scene.integrator == "volprim_rf_basic":
        return volprim_mod.sample(scene, sampler, ray, mode=mode)
    if scene.integrator == "stokes":
        # render of a stokes scene is S0, the unpolarized image;
        # stokes.render_stokes gives all four components
        S, sampler = sample_stokes(scene, sampler, ray)
        return S[:, :, 0], S.new_ones(S.shape[0], dtype=torch.bool), sampler
    if scene.integrator in ("aov", "depth", "moment"):
        # the JAX package's render refuses them too: integrators/aux.py
        # renders them
        raise ValueError(f"unknown integrator {scene.integrator} (render "
                         "it with render_aovs, render_depth or "
                         "render_moments)")
    # ptracer, as in the JAX package: ptracer.render_ptracer renders it
    raise ValueError(f"unknown integrator {scene.integrator}")


def render_pass(scene: Scene, seed: int, spp_pass: int, sample_offset: int,
                mode: str = "primal"):
    """One pass of h*w*spp_pass lanes -> (h, w, 4) film accumulator."""
    w, h = scene.film_w, scene.film_h
    n = w * h * spp_pass
    lane = torch.arange(n, device=scene.device)
    pix = lane // spp_pass
    samp = lane % spp_pass + sample_offset
    # the pattern samplers stratify the scene's sample count, as in the
    # JAX package's fixed passes
    sampler = make_sampler(pix, samp, seed, kind=scene.sampler_kind,
                           spp=scene.spp)
    px = (pix % w).to(torch.float32)
    py = (pix // w).to(torch.float32)
    uf, sampler = sampler.next_2d()
    pos = torch.stack([px, py], -1) + uf
    # a lens or direction sample after the film sample, as the JAX
    # package draws it
    ua = None
    if scene.sensor.stype in APERTURE_SENSORS:
        ua, sampler = sampler.next_2d()
    ray = sample_ray(scene, pos, ua)
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
    """Render the scene to an (h, w, 3) linear-RGB image on scene.device.

    control: a regen.RenderControl (cancel, timeout, progress), honoured
    between the regenerating wavefront's (pixel tile, spp chunk) runs.
    The fixed wavefront ignores it, as the JAX package's does."""
    spp = spp or scene.spp
    from .regen import regen_applicable, render_regen_host
    if regen_applicable(scene, mode):
        return film_mod.develop(render_regen_host(scene, seed, spp,
                                                  control=control))
    n_pix = scene.film_w * scene.film_h
    # the JAX package caps an SSS scene's passes at 2^17 lanes (its TPU's
    # tiled layouts pad the event's per-lane state); the same cap gives
    # the same pass split, so the images match it
    max_wf = SSS_WAVEFRONT if scene.ssub.enabled else MAX_WAVEFRONT
    spp_pass = max(1, min(spp, max_wf // max(n_pix, 1)))
    while spp % spp_pass != 0:
        spp_pass -= 1
    return _render_jit(scene, seed, spp, spp_pass, mode)
