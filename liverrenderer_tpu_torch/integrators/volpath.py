"""Volumetric path tracer with null scattering, next-event estimation
with MIS, and the fork's tissue-depth-threaded bio-media transport
(counterpart of liverrenderer_tpu/integrators/volpath.py): the primal walk
and, for the gradients, the bounded walk (`sample(mode="ad")`).

Detached sampling (the reference's PRB rules): every sampling density and
sampled direction is `.detach()`ed at the points where the JAX bounce
stops its gradient, so parameter derivatives flow only through
values, transmittances and the bio score term exp(log_p - log_p.detach()).

Next-event estimation (NEE) samples an emitter from surface lanes on a
smooth BSDF and from real-scatter lanes of stock media, and attenuates it
along the shadow path: Beer-Lambert over one occlusion query when every
medium is homogeneous and no BSDF lets shadow rays through, else a
ratio-tracked walk through media and null surfaces.  Where both are
statically unreachable (delta surfaces and bio media, as in every liver
scene) the block is not run at all, as the JAX package drops it when it
traces the program.

Every sampler draw of the JAX bounce happens here too, in the same order,
including draws whose value goes unused: the counter RNG keys on the draw
order, so the two packages walk the same paths.

The spectral variant (scene.spectral): each lane draws a hero-wavelength
packet after its channel draw, and the tracked channel indexes packet
entries (distance sampling at the tracked wavelength, ratio weights per
entry, the bio one-hot on the tracked wavelength; RGB is the 3-band case
of the same scheme).  Medium coefficients, BSDF factors and the null
surfaces' transmission are lifted to the packet by the Smits basis,
emitters and the environment D65-referenced; `sample` returns the CIE
estimate in RGB.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.utils.checkpoint

from ..accel.intersect import ray_intersect, ray_test
from ..bsdf.dispatch import (bsdf_eval_pdf, bsdf_sample,
                             eval_null_transmission)
from ..core import math as m
from ..core import spectrum as spec
from ..core.rng import M32, Sampler
from ..core.types import INF, Ray
from ..emitter.dispatch import (eval_emitter_hit, eval_environment,
                                pdf_emitter_direction,
                                sample_emitter_direction)
from ..media.dispatch import (_index_spectrum, _lift, bio_mode,
                              finalize_interaction, medium_is_bio,
                              medium_phase, sample_interaction,
                              sample_interaction_candidate,
                              transmittance_eval_pdf)
from ..phase.dispatch import phase_eval, phase_sample
from ..scene.ir import (BSDF_MASK, BSDF_NULL, F_DELTA, F_NULL, F_SMOOTH,
                        MEDIUM_GLISSON, MEDIUM_HOMOGENEOUS, MEDIUM_LIVER,
                        MEDIUM_PARENCHYMA, Scene)
from .path import lifts
from .shading import shading_frame_with_bump

Tensor = torch.Tensor

# sampler dimensions the attenuated shadow walk consumes, whatever number
# of steps it runs: a lane's later draws must not depend on how long the
# wavefront's slowest walk took
WALK_DIMS = 128
# step cap of the unbounded walk (each step costs one host sync)
WALK_MAX_STEPS = 4096


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
    channel: Tensor         # (N,) tracked channel: an RGB index, or the
    #                         packet entry in the spectral variant
    prev_p: Tensor
    prev_pdf: Tensor
    specular_chain: Tensor
    valid: Tensor
    env_weight: Tensor      # (N,C) deferred environment weight
    sampler: Sampler
    lam: Tensor | None = None   # (N,N_SPEC) hero wavelengths (spectral)


def _has_bio(scene: Scene) -> bool:
    """Bio transport applies only with a bio medium present AND a bio
    integrator (media/dispatch.bio_mode)."""
    return bio_mode(scene) and any(
        t in scene.media.types_present
        for t in (MEDIUM_GLISSON, MEDIUM_PARENCHYMA, MEDIUM_LIVER))


def init_state(ray: Ray, sampler: Sampler, scene: Scene) -> VolpathState:
    n = ray.o.shape[0]
    dev = ray.o.device
    # the channel draw stays although the stratified channel below does
    # not read it: the draw order keys the counter RNG
    u, sampler = sampler.next_1d()
    lam, n_ch = None, 3
    if scene.spectral:
        ul, sampler = sampler.next_1d()
        lam, n_ch = spec.sample_hero(ul), spec.N_SPEC
    # tracked channel stratified over the pixel's sample indices with a
    # per-pixel hash rotation (exactly floor/ceil(spp/n_ch) per channel)
    rot = (((sampler.pix * 2654435761) & 0xFFFFFFFF) >> 16) % n_ch
    channel = (sampler.samp + rot) % n_ch
    f32 = dict(device=dev, dtype=torch.float32)
    return VolpathState(
        active=torch.ones((n,), dtype=torch.bool, device=dev),
        depth=torch.zeros((n,), dtype=torch.int64, device=dev),
        ray_o=ray.o, ray_d=ray.d,
        L=torch.zeros((n, n_ch), **f32),
        throughput=torch.ones((n, n_ch), **f32),
        eta=torch.ones((n,), **f32),
        medium=torch.full((n,), scene.camera_medium, dtype=torch.int64,
                          device=dev),
        tissue_depth=torch.zeros((n,), **f32),
        channel=channel,
        prev_p=ray.o,
        prev_pdf=torch.ones((n,), **f32),
        specular_chain=torch.ones((n,), dtype=torch.bool, device=dev),
        valid=torch.zeros((n,), dtype=torch.bool, device=dev),
        env_weight=torch.zeros((n, n_ch), **f32),
        sampler=sampler,
        lam=lam,
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


def _nee_is_analytic(scene: Scene) -> bool:
    """Static: the shadow transmittance has a closed form when every medium
    is homogeneous and no BSDF lets shadow rays through (null, mask)."""
    media_ok = all(t == MEDIUM_HOMOGENEOUS
                   for t in scene.media.types_present)
    bsdf_ok = not any(t in scene.bsdfs.types_present
                      for t in (BSDF_NULL, BSDF_MASK))
    return media_ok and bsdf_ok


def sample_emitter_attenuated(scene: Scene, ref_p, medium, channel,
                              tissue_depth, sampler: Sampler, active,
                              max_steps: int, bounded: bool, packet=None):
    """NEE with the transmittance along the shadow path through media and
    null surfaces -> (DirectionSample, emitter weight * transmittance,
    sampler).

    Analytic scenes (_nee_is_analytic): Beer-Lambert in the lane's medium
    times one occlusion query (ray_test).  Otherwise a ratio-tracked walk
    through ray_intersect: `bounded` runs exactly max_steps steps (the
    replay and scan adjoints), else it steps until no lane is active (at
    most WALK_MAX_STEPS, one host sync each).  The walk's own draws come
    from a sampler that is then replaced by dim + WALK_DIMS.  packet: the
    lanes' spectrum.Packet in the spectral variant (the emitter weight,
    the media and the null surfaces' transmission lifted to it)."""
    u2, sampler = sampler.next_2d()
    u1, sampler = sampler.next_1d()
    ds, em_weight = sample_emitter_direction(scene, ref_p, u2, u1)
    n = ref_p.shape[0]
    active = active & (ds.pdf > 0)
    if packet is not None:
        em_weight = packet.illum(em_weight)
    eps = (1.0 + torch.amax(torch.abs(ref_p), -1)) * 1e-4
    o0 = ref_p + ds.d * eps[:, None]
    dist = ds.dist * (1.0 - 1e-3) - eps

    if _nee_is_analytic(scene):
        occ = ray_test(scene, Ray(o=o0, d=ds.d, maxt=dist))
        prm = m.table_lookup(scene.media.params, torch.clamp(medium, min=0))
        sig = _lift(prm[:, 0:3] * prm[:, 6:7], packet)
        # environment emitters have dist = inf: exp(-inf * sig) is 0 but
        # its sigma derivative is nan (0 * inf); the limit (0, gradient 0)
        # is taken explicitly
        finite = torch.isfinite(dist)
        dist_f = torch.where(finite, dist, 0.0)[:, None]
        beer = torch.where(finite[:, None], torch.exp(-dist_f * sig), 0.0)
        tr = torch.where((medium >= 0)[:, None], beer, 1.0)
        tr = torch.where((active & ~occ)[:, None], tr, 0.0)
        return ds, em_weight * tr, sampler

    w_o, w_active, w_medium = o0, active, medium
    remaining = dist
    tr = ref_p.new_ones(em_weight.shape)
    w_sampler = sampler

    def step():
        nonlocal w_o, w_active, w_medium, remaining, tr, w_sampler
        act = w_active & (remaining > 0)
        si = ray_intersect(scene, Ray(o=w_o, d=ds.d, maxt=remaining),
                           shadow=True)
        surf_t = torch.minimum(si.t, remaining)
        in_med = act & (w_medium >= 0)
        mei, w_sampler = sample_interaction(
            scene, w_medium, w_o, ds.d, surf_t, w_sampler, channel,
            tissue_depth, in_med, packet)
        tr_a, ffpdf = transmittance_eval_pdf(scene, w_medium, mei, surf_t)
        tr_pdf = _index_spectrum(ffpdf, channel)
        # sampling densities are detached (PRB rule); undetached, the
        # 1/max(x,1e-30)^2 backward overflows fp32 to inf, and masked lanes'
        # zero cotangents turn it into nan
        ratio = torch.where(
            (tr_pdf > 0)[:, None],
            tr_a / torch.clamp(tr_pdf, min=1e-30).detach()[:, None], 0.0)
        tr = torch.where(in_med[:, None], tr * ratio, tr)

        scattered = in_med & mei.valid
        is_bio = medium_is_bio(scene, w_medium)
        # stock media: ratio-track through the (null) collision
        maj_c = _index_spectrum(mei.combined_extinction, channel)
        sn_c = _index_spectrum(mei.sigma_n, channel)
        w_null = mei.sigma_n \
            * (maj_c / torch.clamp(sn_c, min=1e-30)).detach()[:, None]
        w_evt = torch.where(is_bio[:, None], mei.transmittance, w_null)
        tr = torch.where(scattered[:, None], tr * w_evt, tr)

        # lanes that reached a surface first pass through null surfaces
        hit_surface = act & ~scattered & si.valid & (si.t < remaining)
        null_tr = _lift(eval_null_transmission(
            scene, si, m.table_lookup(scene.shape_bsdf,
                                      torch.clamp(si.shape, min=0))), packet)
        tr = torch.where(hit_surface[:, None], tr * null_tr, tr)

        # only lanes that keep walking move: a lane that escaped toward an
        # environment emitter must not step by remaining = inf (nan
        # origins would poison the masked lanes' gradients)
        stp = torch.where(scattered, mei.t,
                          torch.where(hit_surface, si.t + 2e-4, 0.0))
        w_o = w_o + ds.d * stp[:, None]
        remaining = remaining - stp
        w_medium = torch.where(hit_surface & _is_transition(scene, si),
                               _target_medium(scene, si, ds.d), w_medium)
        # a walk whose transmittance fell below any visible contribution
        # ends: a grazing lane (steps of 2e-4 toward an environment emitter
        # at remaining = inf) would otherwise walk to the step cap
        w_active = (scattered | hit_surface) & (remaining > 0) \
            & (torch.amax(tr, -1) > 1e-6) & act

    if bounded:
        for _ in range(max_steps):
            step()
    else:
        for _ in range(WALK_MAX_STEPS):
            if not bool(w_active.any()):         # one host sync per step
                break
            step()
    tr = torch.where(active[:, None], tr, 0.0)
    sampler_out = dataclasses.replace(
        sampler, dim=(sampler.dim + WALK_DIMS) & M32)
    return ds, em_weight * tr, sampler_out


def bounce(scene: Scene, st: VolpathState,
           bounded_nee: bool = False) -> VolpathState:
    """One bounce of every lane.  bounded_nee: the NEE shadow walk runs a
    fixed max_depth steps (the gradients' walks) instead of until its
    lanes end (the primal and the stored forward)."""
    n = st.ray_o.shape[0]
    packet, refl, illum = lifts(scene, st.lam)
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
        tissue_depth, in_medium, packet)
    ray_maxt = torch.where(in_medium & torch.isfinite(cand["dist"]),
                           cand["dist"], INF)
    ray = Ray(o=st.ray_o, d=st.ray_d, maxt=ray_maxt)
    si = ray_intersect(scene, ray)
    si = shading_frame_with_bump(scene, si, ray)

    mei = finalize_interaction(cand, si.t, st.channel, in_medium)
    tr_a, ffpdf = transmittance_eval_pdf(scene, st.medium, mei, si.t)
    tr_pdf = _index_spectrum(ffpdf, st.channel)
    tr_pdf_det = torch.clamp(tr_pdf, min=1e-30).detach()
    ratio = torch.where((tr_pdf > 0)[:, None],
                        tr_a / tr_pdf_det[:, None], 0.0)
    throughput = torch.where(in_medium[:, None], throughput * ratio,
                             throughput)
    if _has_bio(scene):
        # bio media: score-function gradient of the free-flight event
        # (value 1; derivative d log_p, media/dispatch.py)
        score = torch.exp(mei.log_p - mei.log_p.detach())
        throughput = torch.where(in_medium[:, None],
                                 throughput * score[:, None], throughput)

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
    w_null = mei.sigma_n \
        * (maj_c / torch.clamp(sn_c, min=1e-30)).detach()[:, None]
    throughput = torch.where(act_null[:, None], throughput * w_null,
                             throughput)

    depth = torch.where(act_real, depth + 1, depth)
    reached_max = depth >= scene.max_depth
    act_real = act_real & ~reached_max

    is_bio = medium_is_bio(scene, st.medium) & in_medium
    w_real = mei.sigma_s \
        * (maj_c / torch.clamp(st_c, min=1e-30)).detach()[:, None]
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

    # ---- phase sampling, detached: the sampled direction and its pdf
    # carry no derivative; the phase parameter's gradient re-enters
    # through the value/pdf ratio
    ptype, g, pprm = medium_phase(scene, st.medium)
    nee_med = act_real & ~is_bio & (depth + 1 < scene.max_depth)
    if not scene.needs_medium_nee:
        nee_med = torch.zeros_like(nee_med)      # biovolpath / no stock media
    throughput_pre_phase = throughput
    u2p, sampler = sampler.next_2d()
    wo_med, _, ppdf = phase_sample(ptype, g, st.ray_d, u2p, pprm,
                                   scene.media.phase_types)
    wo_med = wo_med.detach()
    ppdf = ppdf.detach()
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
    needs_nee = scene.needs_surface_nee or scene.needs_medium_nee
    if needs_nee:
        # MIS against the density with which NEE would have sampled the
        # emitter this ray hit (or the environment it escaped to)
        eidx_mis = eidx
        if scene.emitters.env_index >= 0:
            eidx_mis = torch.where(esc_env, scene.emitters.env_index, eidx)
        em_pdf = pdf_emitter_direction(scene, st.prev_p, eidx_mis, si.p,
                                       si.ng, st.ray_d)
        count_direct = (st.depth == 0) | st.specular_chain
        em_pdf = torch.where(count_direct, 0.0, em_pdf)
    else:
        # no NEE anywhere: BSDF sampling owns MIS (emitter pdf 0)
        em_pdf = torch.zeros_like(st.prev_pdf)
    mis_b = m.mis_weight(st.prev_pdf, em_pdf)
    contrib = torch.where(((eidx >= 0) & si.valid)[:, None], illum(em_val),
                          0.0)
    hide = scene.hide_emitters & (st.depth == 0)
    gather = active_surface & ~hide & ~reached_max
    L = L + torch.where(gather[:, None],
                        throughput * contrib * mis_b[:, None], 0.0)
    env_weight = st.env_weight + torch.where(
        (gather & esc_env)[:, None], throughput * mis_b[:, None], 0.0)

    active_surface = active_surface & si.valid & ~reached_max
    valid = st.valid | active_surface | act_real

    # ---- NEE: one shared attenuated walk for medium-scatter and surface
    # lanes (mutually exclusive per lane)
    if needs_nee:
        flags = scene.bsdfs.flags[torch.clamp(bsdf_idx, min=0)]
        nee_s = active_surface & ((flags & F_SMOOTH) != 0) \
            & (depth + 1 < scene.max_depth)
        if not scene.needs_surface_nee:
            nee_s = torch.zeros_like(nee_s)
        nee_any = nee_s | nee_med
        ref_p = torch.where(nee_med[:, None], mei.p, si.p)
        ds, emw, sampler = sample_emitter_attenuated(
            scene, ref_p, st.medium, st.channel, tissue_depth, sampler,
            nee_any, scene.max_depth, bounded_nee, packet)
        bval, bpdf = bsdf_eval_pdf(scene, si, bsdf_idx, si.to_local(ds.d))
        ph_val = phase_eval(ptype, g, m.dot(st.ray_d, ds.d), pprm, st.ray_d,
                            ds.d, scene.media.phase_types)
        cpdf = torch.where(nee_med, ph_val, bpdf)
        cval = torch.where(nee_med[:, None], ph_val[:, None], refl(bval))
        mis_e = m.mis_weight(ds.pdf, torch.where(ds.delta, 0.0, cpdf))
        tp_nee = torch.where(nee_med[:, None], throughput_pre_phase,
                             throughput)
        L = L + torch.where(nee_any[:, None],
                            tp_nee * cval * emw * mis_e[:, None], 0.0)

    # ---- BSDF sampling
    ub1, sampler = sampler.next_1d()
    ub2, sampler = sampler.next_2d()
    bs = bsdf_sample(scene, si, bsdf_idx, ub1, ub2)
    wo_surf = si.to_world(bs.wo)
    surf_ok = active_surface & (bs.pdf > 0)
    non_null = surf_ok & ((bs.sampled_type & F_NULL) == 0)
    throughput = torch.where(surf_ok[:, None], throughput * refl(bs.weight),
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
        throughput / torch.clamp(q.detach(), min=1e-8)[:, None], throughput)
    alive = alive & rr_keep

    return dataclasses.replace(
        st, active=alive, depth=depth, ray_o=next_o, ray_d=next_d, L=L,
        throughput=throughput, eta=eta,
        medium=torch.where(act_real | act_null, st.medium, new_medium),
        tissue_depth=tissue_depth, prev_p=prev_p, prev_pdf=prev_pdf,
        specular_chain=specular_chain, valid=valid, env_weight=env_weight,
        sampler=sampler)


def sample(scene: Scene, sampler: Sampler, ray: Ray, mode: str = "primal"):
    """Fixed-wavefront walk -> (L, valid, sampler).

    primal: bounce every lane until all die or the iteration cap (null
    events do not count depth, so the cap is a multiple of max_depth).
    ad: exactly max_depth bounces, each under a non-reentrant activation
    checkpoint, so reverse mode keeps one lane state per bounce and
    recomputes the bounce in the backward pass."""
    st = init_state(ray, sampler, scene)
    if mode == "primal":
        for _ in range(scene.max_depth * 4):
            if not bool(st.active.any()):
                break
            st = bounce(scene, st, False)
    elif mode == "ad":
        for _ in range(scene.max_depth):
            st = torch.utils.checkpoint.checkpoint(
                bounce, scene, st, True, use_reentrant=False)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    env = eval_environment(scene, st.ray_d)
    if scene.spectral:
        env = spec.smits_upsample_illum(env, st.lam)
        return spec.spec_to_rgb_estimate(st.L + st.env_weight * env,
                                         st.lam), st.valid, st.sampler
    return st.L + st.env_weight * env, st.valid, st.sampler
