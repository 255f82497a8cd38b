"""Surface path tracer with next-event estimation and MIS, the `path`,
`direct`, `prb` and `prb_basic` integrators (counterpart of
liverrenderer_tpu/integrators/path.py).

Every bounce processes all lanes branchlessly:
  * emitter hits and the environment gathered along the BSDF-sampled ray,
    weighted by mis_weight(prev_bsdf_pdf, emitter_pdf), the emitter pdf
    zero for camera rays and after delta lobes;
  * NEE on smooth lobes: one emitter sample, one occlusion query
    (`ray_test`, the closest-hit kernel), mis_weight(ds.pdf, bsdf_pdf)
    with the BSDF pdf zeroed for delta emitters;
  * BSDF sampling, then Russian roulette from rr_depth on the
    eta^2-compressed throughput (survival capped at 0.95, detached).
  * the BSSRDF hook between BSDF sampling and roulette, on lanes that hit
    a subsurface shape from outside: a dipole shape adds its diffusion
    term to L; a vaescatter shape's transmitted lanes run the SSS event
    (ssub/event.py), which rewrites the ray, throughput, pdf and
    liveness to the VAE-sampled exit (every lane draws the event's
    dimensions whenever the scene has a VAE).
Unlike the volpath family, the environment is folded into L inside the
bounce (the state has no env_weight).  Every sampler draw of the JAX
bounce happens here in the same order, so both packages walk the same
paths.

The spectral variant (scene.spectral): each lane draws a hero-wavelength
packet after its camera sample, L and the throughput hold the packet's
N_SPEC entries, every RGB reflectance factor (BSDF values and weights) is
lifted to the packet by the Smits basis and every radiance (emitters, the
environment) D65-referenced; `sample` returns the CIE estimate in RGB.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.utils.checkpoint

from ..accel.intersect import ray_intersect, ray_test
from ..bsdf.dispatch import bsdf_eval_pdf, bsdf_sample
from ..core import math as m
from ..core import spectrum as spec
from ..core.rng import Sampler
from ..core.types import INF, Ray
from ..emitter.dispatch import (eval_emitter_hit, eval_environment,
                                pdf_emitter_direction,
                                sample_emitter_direction)
from ..scene.ir import F_DELTA, F_SMOOTH, SSUB_DIPOLE, SSUB_VAE, Scene
from ..ssub.dipole import dipole_lo
from ..ssub.event import subsurface_event
from .shading import shading_frame_with_bump

Tensor = torch.Tensor


@dataclass
class PathState:
    active: Tensor       # (N,) bool
    depth: Tensor        # (N,)
    ray_o: Tensor        # (N,3)
    ray_d: Tensor        # (N,3)
    L: Tensor            # (N,C) accumulated radiance (C = 3, or N_SPEC)
    throughput: Tensor   # (N,C)
    eta: Tensor          # (N,)
    prev_p: Tensor       # (N,3) last scatter position (the MIS reference)
    prev_pdf: Tensor     # (N,) last BSDF sample's pdf
    prev_smooth: Tensor  # (N,) bool: the last lobe was smooth (MIS-able)
    sampler: Sampler
    valid: Tensor        # (N,) bool: the ray hit something
    lam: Tensor | None = None   # (N,N_SPEC) hero wavelengths (spectral)


def _same(v):
    return v


def lifts(scene: Scene, lam):
    """(packet, refl, illum): the lanes' spectrum.Packet with its lifts of
    an RGB reflectance and an RGB radiance factor in the spectral variant;
    (None, identity, identity) in RGB."""
    if not scene.spectral:
        return None, _same, _same
    pk = spec.Packet(lam)
    return pk, pk.refl, pk.illum


def init_state(ray: Ray, sampler: Sampler, scene: Scene) -> PathState:
    n = ray.o.shape[0]
    dev = ray.o.device
    f32 = dict(device=dev, dtype=torch.float32)
    lam, C = None, 3
    if scene.spectral:
        u, sampler = sampler.next_1d()
        lam, C = spec.sample_hero(u), spec.N_SPEC
    return PathState(
        active=torch.ones((n,), dtype=torch.bool, device=dev),
        depth=torch.zeros((n,), dtype=torch.int64, device=dev),
        ray_o=ray.o, ray_d=ray.d,
        L=torch.zeros((n, C), **f32),
        throughput=torch.ones((n, C), **f32),
        eta=torch.ones((n,), **f32),
        prev_p=ray.o,
        prev_pdf=torch.ones((n,), **f32),
        prev_smooth=torch.zeros((n,), dtype=torch.bool, device=dev),
        sampler=sampler,
        valid=torch.zeros((n,), dtype=torch.bool, device=dev),
        lam=lam,
    )


def bounce(scene: Scene, st: PathState, ad: bool = False) -> PathState:
    """One bounce of every lane.  ad=True applies the detached-sampling
    rule: the continuation ray is detached and a smooth lobe's throughput
    factor is re-evaluated differentiably at the detached direction (an
    attached VNDF sample has unbounded Jacobians at grazing angles); a
    delta lobe keeps its sampled weight, detached."""
    n = st.ray_o.shape[0]
    active = st.active
    _, refl, illum = lifts(scene, st.lam)
    ray = Ray(o=st.ray_o, d=st.ray_d,
              maxt=st.ray_o.new_full((n,), INF))
    si = ray_intersect(scene, ray)
    si = shading_frame_with_bump(scene, si, ray)
    bsdf_idx = m.table_lookup(scene.shape_bsdf, torch.clamp(si.shape, min=0))

    # ---- emission gathered along the BSDF-sampled ray
    em_val, eidx = eval_emitter_hit(scene, si, ray.d)
    env_val = eval_environment(scene, ray.d)
    em_val, env_val = illum(em_val), illum(env_val)
    hit_emitter = (eidx >= 0) & si.valid
    escaped = ~si.valid
    eidx_mis = eidx
    if scene.emitters.env_index >= 0:
        eidx_mis = torch.where(escaped, scene.emitters.env_index, eidx)
    count_direct = (st.depth == 0) | ~st.prev_smooth
    em_pdf = pdf_emitter_direction(scene, st.prev_p, eidx_mis, si.p, si.ng,
                                   ray.d)
    em_pdf = torch.where(count_direct, 0.0, em_pdf)
    mis_bsdf = m.mis_weight(st.prev_pdf, em_pdf)
    contrib = torch.where(hit_emitter[:, None], em_val, 0.0) \
        + torch.where(escaped[:, None], env_val, 0.0)
    gather = active & ~(st.depth == 0) if scene.hide_emitters else active
    L = st.L + torch.where(gather[:, None],
                           st.throughput * contrib * mis_bsdf[:, None], 0.0)

    active_next = active & si.valid & (st.depth + 1 < scene.max_depth)
    valid = st.valid | (active & si.valid)

    # ---- emitter sampling (NEE)
    flags = m.table_lookup(scene.bsdfs.flags, torch.clamp(bsdf_idx, min=0))
    active_e = active_next & ((flags & F_SMOOTH) != 0)
    u2, sampler = st.sampler.next_2d()
    u1, sampler = sampler.next_1d()
    ds, em_weight = sample_emitter_direction(scene, si.p, u2, u1)
    nee_valid = active_e & (ds.pdf > 0)
    sray = si.spawn_ray_to(ds.p)
    nee_valid = nee_valid & ~ray_test(scene, sray)
    bval, bpdf = bsdf_eval_pdf(scene, si, bsdf_idx, si.to_local(ds.d))
    mis_em = m.mis_weight(ds.pdf, torch.where(ds.delta, 0.0, bpdf))
    L = L + torch.where(nee_valid[:, None],
                        st.throughput * refl(bval) * illum(em_weight)
                        * mis_em[:, None],
                        0.0)

    # ---- BSDF sampling
    ub1, sampler = sampler.next_1d()
    ub2, sampler = sampler.next_2d()
    bs = bsdf_sample(scene, si, bsdf_idx, ub1, ub2)
    wo_world = si.to_world(bs.wo)
    new_ray = si.spawn_ray(wo_world)
    weight = refl(bs.weight)
    smooth_lobe = (bs.sampled_type & F_DELTA) == 0
    if ad:
        new_ray = Ray(o=new_ray.o.detach(), d=new_ray.d.detach(),
                      maxt=new_ray.maxt)
        val2, _ = bsdf_eval_pdf(scene, si, bsdf_idx,
                                si.to_local(wo_world.detach()))
        w_re = refl(val2) / torch.clamp(bs.pdf.detach(), min=1e-12)[:, None]
        weight = torch.where(smooth_lobe[:, None], w_re, weight.detach())
    throughput = st.throughput * weight
    eta = st.eta * bs.eta
    pdf = bs.pdf
    alive = active_next & (pdf > 0) & torch.any(throughput != 0.0, -1)
    sampled_smooth = smooth_lobe

    # ---- the BSSRDF hook
    ss = scene.ssub
    if ss.enabled:
        ss_idx = m.table_lookup(scene.shape_subsurface,
                                torch.clamp(si.shape, min=0))
        ss_t = ss.ss_type[torch.clamp(ss_idx, min=0)]
        ss_any = active_next & si.valid & (ss_idx >= 0) & (si.wi[:, 2] > 0)
    if ss.enabled and ss.has_dipole:
        dip = ss_any & (ss_t == SSUB_DIPOLE)
        L = L + torch.where(dip[:, None], st.throughput
                            * dipole_lo(scene, si.p, si.wi[:, 2], dip), 0.0)
    if ss.enabled and ss.has_vae:
        ss_mask = ss_any & (ss_t == SSUB_VAE) \
            & (bs.wo[:, 2] * si.wi[:, 2] < 0) & (pdf > 0)
        ev, sampler = subsurface_event(scene, si, wo_world, sampler, ss_mask)
        sm = ss_mask[:, None]
        L = L + torch.where(sm, throughput * ev.L_nee, 0.0)
        epsq = (1.0 + torch.amax(torch.abs(ev.out_p), -1)) * 1e-4
        new_ray = Ray(
            o=torch.where(sm, ev.out_p + ev.out_d * epsq[:, None], new_ray.o),
            d=torch.where(sm, ev.out_d, new_ray.d), maxt=new_ray.maxt)
        throughput = torch.where(sm, throughput * ev.weight, throughput)
        alive = torch.where(ss_mask, ev.alive, alive)
        pdf = torch.where(ss_mask, ev.pdf, pdf)
        sampled_smooth = torch.where(ss_mask, ~ev.passthrough,
                                     sampled_smooth)

    # ---- Russian roulette
    urr, sampler = sampler.next_1d()
    q = torch.clamp(torch.amax(throughput, -1) * (eta * eta), max=0.95)
    perform_rr = st.depth + 1 >= scene.rr_depth
    rr_continue = (urr < q) | ~perform_rr
    throughput = torch.where(
        perform_rr[:, None],
        throughput / torch.clamp(q.detach(), min=1e-8)[:, None], throughput)
    alive = alive & rr_continue

    a3 = alive[:, None]
    return dataclasses.replace(
        st, active=alive, depth=st.depth + 1,
        ray_o=torch.where(a3, new_ray.o, st.ray_o),
        ray_d=torch.where(a3, new_ray.d, st.ray_d),
        L=L, throughput=torch.where(a3, throughput, st.throughput),
        eta=torch.where(alive, eta, st.eta),
        prev_p=torch.where(a3, si.p, st.prev_p),
        prev_pdf=torch.where(alive, pdf, st.prev_pdf),
        prev_smooth=torch.where(alive, sampled_smooth, st.prev_smooth),
        sampler=sampler, valid=valid)


def sample(scene: Scene, sampler: Sampler, ray: Ray, mode: str = "primal"):
    """Fixed-wavefront walk -> (L, valid, sampler).

    primal: bounce until every lane has died (at most max_depth bounces:
    every bounce advances every lane's depth).  ad: exactly max_depth
    bounces, each under a non-reentrant activation checkpoint, so reverse
    mode keeps one lane state per bounce and recomputes the bounce."""
    st = init_state(ray, sampler, scene)
    if mode == "primal":
        for _ in range(scene.max_depth):
            if not bool(st.active.any()):
                break
            st = bounce(scene, st)
    elif mode == "ad":
        for _ in range(scene.max_depth):
            st = torch.utils.checkpoint.checkpoint(
                bounce, scene, st, True, use_reentrant=False)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    L = st.L
    if scene.spectral:
        L = spec.spec_to_rgb_estimate(L, st.lam)
    return L, st.valid, st.sampler
