"""Volumetric path tracer with null scattering and the fork's
tissue-depth-threaded bio-media transport (counterpart of
liverrenderer_tpu/integrators/volpath.py), primal only.

The slice carries the configurations in which next-event estimation is
statically unreachable: delta surfaces (dielectric, null) and bio media
under biovolpath, as in every liver scene.  There the JAX package drops the
whole NEE shadow walk when it traces the program; the port raises when a
scene needs it (`needs_surface_nee` / `needs_medium_nee`).

Every sampler draw of the JAX bounce happens here too, in the same order,
including draws whose value goes unused: the counter RNG keys on the draw
order, so the two packages walk the same paths.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..accel.intersect import ray_intersect
from ..bsdf.dispatch import bsdf_sample
from ..core import math as m
from ..core.rng import Sampler
from ..core.types import INF, Ray
from ..emitter.dispatch import eval_emitter_hit, eval_environment
from ..errors import not_ported
from ..media.dispatch import (_index_spectrum, bio_mode,
                              finalize_interaction, medium_is_bio,
                              medium_phase, sample_interaction_candidate,
                              transmittance_eval_pdf)
from ..phase.dispatch import phase_eval, phase_sample
from ..scene.ir import (F_DELTA, F_NULL, MEDIUM_GLISSON, MEDIUM_LIVER,
                        MEDIUM_PARENCHYMA, Scene)
from .shading import shading_frame_with_bump

Tensor = torch.Tensor


@dataclass
class VolpathState:
    active: Tensor
    depth: Tensor
    ray_o: Tensor
    ray_d: Tensor
    L: Tensor
    throughput: Tensor
    eta: Tensor
    medium: Tensor          # (N,) current medium, -1 = vacuum
    tissue_depth: Tensor    # (N,) fork extension (biovolpath.cpp)
    channel: Tensor         # (N,) tracked RGB channel
    prev_p: Tensor
    prev_pdf: Tensor
    specular_chain: Tensor
    valid: Tensor
    env_weight: Tensor      # (N,3) deferred environment weight
    sampler: Sampler


def _has_bio(scene: Scene) -> bool:
    """Bio transport applies only with a bio medium present AND a bio
    integrator (media/dispatch.bio_mode)."""
    return bio_mode(scene) and any(
        t in scene.media.types_present
        for t in (MEDIUM_GLISSON, MEDIUM_PARENCHYMA, MEDIUM_LIVER))


def check_supported(scene: Scene):
    """Raise for what the primal slice does not carry."""
    if scene.spectral:
        raise not_ported("the spectral variant", "Queue 1 M10")
    if scene.needs_surface_nee or scene.needs_medium_nee:
        raise not_ported("next-event estimation (diffuse, point and area "
                         "emitters with the NEE shadow walk)",
                         "Queue 1 (emitters with NEE)")


def init_state(ray: Ray, sampler: Sampler, scene: Scene) -> VolpathState:
    n = ray.o.shape[0]
    dev = ray.o.device
    # the channel draw stays although the stratified channel below does
    # not read it: the draw order keys the counter RNG
    u, sampler = sampler.next_1d()
    # tracked channel stratified over the pixel's sample indices with a
    # per-pixel hash rotation (exactly floor/ceil(spp/3) per channel)
    rot = (((sampler.pix * 2654435761) & 0xFFFFFFFF) >> 16) % 3
    channel = (sampler.samp + rot) % 3
    f32 = dict(device=dev, dtype=torch.float32)
    return VolpathState(
        active=torch.ones((n,), dtype=torch.bool, device=dev),
        depth=torch.zeros((n,), dtype=torch.int64, device=dev),
        ray_o=ray.o, ray_d=ray.d,
        L=torch.zeros((n, 3), **f32),
        throughput=torch.ones((n, 3), **f32),
        eta=torch.ones((n,), **f32),
        medium=torch.full((n,), scene.camera_medium, dtype=torch.int64,
                          device=dev),
        tissue_depth=torch.zeros((n,), **f32),
        channel=channel,
        prev_p=ray.o,
        prev_pdf=torch.ones((n,), **f32),
        specular_chain=torch.ones((n,), dtype=torch.bool, device=dev),
        valid=torch.zeros((n,), dtype=torch.bool, device=dev),
        env_weight=torch.zeros((n, 3), **f32),
        sampler=sampler,
    )


def _target_medium(scene: Scene, si, d):
    """Medium on the far side of a boundary: leaving (d . ng > 0) ->
    exterior, entering -> interior."""
    shape = torch.clamp(si.shape, min=0)
    outward = torch.sum(d * si.ng, -1) > 0
    return torch.where(outward, scene.shape_ext_medium[shape],
                       scene.shape_int_medium[shape])


def _is_transition(scene: Scene, si):
    shape = torch.clamp(si.shape, min=0)
    return si.valid & ((scene.shape_int_medium[shape] >= 0)
                       | (scene.shape_ext_medium[shape] >= 0))


def bounce(scene: Scene, st: VolpathState) -> VolpathState:
    check_supported(scene)
    n = st.ray_o.shape[0]
    sampler = st.sampler
    active = st.active
    in_medium = active & (st.medium >= 0)
    throughput = st.throughput
    L = st.L
    tissue_depth = st.tissue_depth
    depth = st.depth

    # ---- medium sampling first: the candidate collision bounds the
    # surface query, so the kernel's chunk culling skips geometry beyond it
    cand, sampler = sample_interaction_candidate(
        scene, st.medium, st.ray_o, st.ray_d, sampler, st.channel,
        tissue_depth, in_medium)
    ray_maxt = torch.where(in_medium & torch.isfinite(cand["dist"]),
                           cand["dist"], INF)
    ray = Ray(o=st.ray_o, d=st.ray_d, maxt=ray_maxt)
    si = ray_intersect(scene, ray)
    si = shading_frame_with_bump(scene, si, ray)

    mei = finalize_interaction(cand, si.t, st.channel, in_medium)
    tr_a, ffpdf = transmittance_eval_pdf(scene, st.medium, mei, si.t)
    tr_pdf = _index_spectrum(ffpdf, st.channel)
    ratio = torch.where((tr_pdf > 0)[:, None],
                        tr_a / torch.clamp(tr_pdf, min=1e-30)[:, None], 0.0)
    throughput = torch.where(in_medium[:, None], throughput * ratio,
                             throughput)
    # (bio media: the score-function factor exp(log_p - log_p) is 1 in the
    # primal; it returns with the gradient slice)

    escaped = in_medium & ~mei.valid
    act_medium = in_medium & mei.valid

    # null vs real split
    u_nr, sampler = sampler.next_1d()
    st_c = _index_spectrum(mei.sigma_t, st.channel)
    maj_c = _index_spectrum(mei.combined_extinction, st.channel)
    null_scatter = u_nr >= st_c / torch.clamp(maj_c, min=1e-30)
    act_null = act_medium & null_scatter
    act_real = act_medium & ~null_scatter

    sn_c = _index_spectrum(mei.sigma_n, st.channel)
    w_null = mei.sigma_n * (maj_c / torch.clamp(sn_c, min=1e-30))[:, None]
    throughput = torch.where(act_null[:, None], throughput * w_null,
                             throughput)

    depth = torch.where(act_real, depth + 1, depth)
    reached_max = depth >= scene.max_depth
    act_real = act_real & ~reached_max

    is_bio = medium_is_bio(scene, st.medium) & in_medium
    w_real = mei.sigma_s * (maj_c / torch.clamp(st_c, min=1e-30))[:, None]
    if _has_bio(scene):
        w_real = torch.where(is_bio[:, None], mei.transmittance, w_real)
        if scene.integrator == "biovolpath":
            # per-channel erase of the accumulated result where the event
            # transmittance is zero (biovolpath.cpp spectral mask)
            kill = in_medium[:, None] & (mei.transmittance == 0.0)
            L = torch.where(kill, 0.0, L)
        tissue_depth = torch.where(
            act_real & is_bio,
            tissue_depth + torch.abs(st.ray_d[:, 2] * mei.t), tissue_depth)
    throughput = torch.where(act_real[:, None], throughput * w_real,
                             throughput)

    # ---- phase sampling (detached in the JAX package; primal here)
    ptype, g, pprm = medium_phase(scene, st.medium)
    u2p, sampler = sampler.next_2d()
    wo_med, _, ppdf = phase_sample(ptype, g, st.ray_d, u2p, pprm,
                                   scene.media.phase_types)
    pval = phase_eval(ptype, g, m.dot(st.ray_d, wo_med), pprm, st.ray_d,
                      wo_med, scene.media.phase_types)
    pw = pval / torch.clamp(ppdf, min=1e-20)
    act_real = act_real & (ppdf > 0)
    throughput = torch.where(act_real[:, None], throughput * pw[:, None],
                             throughput)

    # ---- surface interactions
    active_surface = (active & ~in_medium) | escaped
    bsdf_idx = scene.shape_bsdf[torch.clamp(si.shape, min=0)]

    # emission along the current ray; the environment is evaluated once
    # per path after the loop (env_weight records the weight)
    em_val, eidx = eval_emitter_hit(scene, si, st.ray_d)
    esc_env = ~si.valid
    # no NEE anywhere: BSDF sampling owns MIS (emitter pdf 0)
    mis_b = m.mis_weight(st.prev_pdf, torch.zeros_like(st.prev_pdf))
    contrib = torch.where(((eidx >= 0) & si.valid)[:, None], em_val, 0.0)
    hide = scene.hide_emitters & (st.depth == 0)
    gather = active_surface & ~hide & ~reached_max
    L = L + torch.where(gather[:, None],
                        throughput * contrib * mis_b[:, None], 0.0)
    env_weight = st.env_weight + torch.where(
        (gather & esc_env)[:, None], throughput * mis_b[:, None], 0.0)

    active_surface = active_surface & si.valid & ~reached_max
    valid = st.valid | active_surface | act_real

    # ---- BSDF sampling
    ub1, sampler = sampler.next_1d()
    ub2, sampler = sampler.next_2d()
    bs = bsdf_sample(scene, si, bsdf_idx, ub1, ub2)
    wo_surf = si.to_world(bs.wo)
    surf_ok = active_surface & (bs.pdf > 0)
    non_null = surf_ok & ((bs.sampled_type & F_NULL) == 0)
    throughput = torch.where(surf_ok[:, None], throughput * bs.weight,
                             throughput)
    eta = torch.where(surf_ok, st.eta * bs.eta, st.eta)
    depth = torch.where(non_null, depth + 1, depth)
    new_spec = (bs.sampled_type & F_DELTA) != 0

    new_medium = torch.where(surf_ok & _is_transition(scene, si),
                             _target_medium(scene, si, wo_surf), st.medium)

    # ---- next ray
    sr = si.spawn_ray(wo_surf)
    scat = (act_real | act_null)[:, None]
    next_o = torch.where(scat, mei.p,
                         torch.where(surf_ok[:, None], sr.o, st.ray_o))
    next_d = torch.where(act_real[:, None], wo_med,
                         torch.where(surf_ok[:, None], wo_surf, st.ray_d))
    prev_p = torch.where(act_real[:, None], mei.p,
                         torch.where(non_null[:, None], si.p, st.prev_p))
    prev_pdf = torch.where(act_real, ppdf,
                           torch.where(non_null, bs.pdf, st.prev_pdf))
    specular_chain = torch.where(
        act_real, False,
        torch.where(non_null, new_spec, st.specular_chain))
    alive = (act_real | act_null | surf_ok) \
        & torch.any(throughput != 0.0, -1) & (depth < scene.max_depth)

    # ---- Russian roulette on the eta^2-compressed throughput
    urr, sampler = sampler.next_1d()
    q = torch.clamp(torch.amax(throughput, -1) * eta * eta, max=0.95)
    perform_rr = depth > scene.rr_depth
    rr_keep = (urr < q) | ~perform_rr
    throughput = torch.where(
        perform_rr[:, None],
        throughput / torch.clamp(q, min=1e-8)[:, None], throughput)
    alive = alive & rr_keep

    return dataclasses.replace(
        st, active=alive, depth=depth, ray_o=next_o, ray_d=next_d, L=L,
        throughput=throughput, eta=eta,
        medium=torch.where(act_real | act_null, st.medium, new_medium),
        tissue_depth=tissue_depth, prev_p=prev_p, prev_pdf=prev_pdf,
        specular_chain=specular_chain, valid=valid, env_weight=env_weight,
        sampler=sampler)


def sample(scene: Scene, sampler: Sampler, ray: Ray, mode: str = "primal"):
    """Fixed-wavefront walk: bounce every lane until all die or the
    iteration cap (null events do not count depth, so the cap is a
    multiple of max_depth) -> (L, valid, sampler)."""
    if mode != "primal":
        raise not_ported("gradient modes", "Queue 1 M7")
    check_supported(scene)
    st = init_state(ray, sampler, scene)
    for _ in range(scene.max_depth * 4):
        if not bool(st.active.any()):
            break
        st = bounce(scene, st)
    env = eval_environment(scene, st.ray_d)
    return st.L + st.env_weight * env, st.valid, st.sampler
