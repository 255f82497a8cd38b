"""Polarized transport, the `stokes` integrator (counterpart of
liverrenderer_tpu/integrators/stokes.py; reference stokes.cpp and the
polarized variants' Mueller-valued spectra).

A dedicated wavefront loop carries a per-lane Mueller throughput T
(N, C, 4, 4) beside the scalar path state.  Directions are sampled by the
scalar BSDF dispatch (the same pdf), and the sampled event's polarization
transfer is applied as a normalized Mueller matrix (M00 = 1) times the
scalar weight: S0 is the unpolarized render's estimate, S1..S3 carry the
polarization state.

Estimator: path tracing with NEE and MIS, as `path`: emitter hits are
weighted against the emitter-sampling pdf, and each smooth vertex adds a
light connection whose polarization transfer (the same `_event_mueller`,
along the connection) is applied to the unpolarized emitter's Stokes
vector.  Stokes vectors live in the canonical basis of each ray
(core/mueller.stokes_basis) with light travelling along -ray.d; the film
output is in the primary ray's basis.  No Russian roulette, as in the JAX
package.

Polarizing events: smooth and rough conductor and smooth dielectric
reflection (the s/p Fresnel matrix), and the linear polarizer, retarder
and circular elements (their axis the shading frame's s rotated by
theta).  Everything else depolarizes.

The spectral x polarized variant (scene.spectral): C = N_SPEC packet
entries instead of 3 RGB channels; every RGB factor is lifted to the
lane's packet and each Stokes component is CIE-converted at the end.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..accel.intersect import ray_intersect, ray_test
from ..bsdf.dispatch import bsdf_eval_pdf, bsdf_sample
from ..core import math as m
from ..core import mueller as mu
from ..core import spectrum as spec
from ..core.rng import Sampler, make_sampler
from ..core.types import INF, Ray
from ..emitter.dispatch import (eval_emitter_hit, eval_environment,
                                pdf_emitter_direction,
                                sample_emitter_direction)
from ..scene.ir import (BSDF_CIRCULAR, BSDF_CONDUCTOR, BSDF_DIELECTRIC,
                        BSDF_POLARIZER, BSDF_RETARDER, BSDF_ROUGHCONDUCTOR,
                        F_DELTA, F_DELTA_REFL, F_GLOSSY_REFL, F_SMOOTH, Scene)
from ..sensor.perspective import sample_ray
from .path import lifts
from .shading import shading_frame_with_bump

Tensor = torch.Tensor

_FRESNEL = (BSDF_CONDUCTOR, BSDF_ROUGHCONDUCTOR, BSDF_DIELECTRIC)
_ELEMENTS = (BSDF_POLARIZER, BSDF_RETARDER, BSDF_CIRCULAR)


@dataclass
class PolState:
    active: Tensor       # (N,) bool
    depth: Tensor        # (N,)
    ray_o: Tensor        # (N, 3)
    ray_d: Tensor        # (N, 3)
    S: Tensor            # (N, C, 4) accumulated camera Stokes per channel
    T: Tensor            # (N, C, 4, 4) Mueller path throughput
    prev_p: Tensor       # (N, 3) previous vertex (the emitter pdf's ref)
    prev_pdf: Tensor     # (N,) BSDF pdf of the ray that made this hit
    prev_smooth: Tensor  # (N,) bool: the last event was non-delta
    sampler: Sampler
    lam: Tensor | None = None   # (N, N_SPEC) hero wavelengths (spectral)


def _sel(btype, codes):
    out = torch.zeros_like(btype, dtype=torch.bool)
    for c in codes:
        out = out | (btype == c)
    return out


def _event_mueller(scene: Scene, si, refl, d_in_light, d_out_light,
                   basis_in, basis_out, lift=None):
    """Normalized (M00 = 1) Mueller matrix (N, C, 4, 4) of a scattering
    event, sampled or a NEE connection, from the canonical basis of the
    incoming light ray to that of the outgoing (camera-side) ray.  `refl`
    marks lanes whose event is a reflection (Fresnel polarization
    applies); every other event depolarizes.  lift: the spectral
    variant's reflectance lift (conductor and dielectric eta, k)."""
    n = d_in_light.shape[0]
    C = 3 if lift is None else spec.N_SPEC
    bidx = torch.clamp(m.table_lookup(scene.shape_bsdf,
                                      torch.clamp(si.shape, min=0)), min=0)
    btype = m.table_lookup(scene.bsdfs.btype, bidx)
    prm = m.table_lookup(scene.bsdfs.params, bidx)
    M = torch.broadcast_to(mu.depolarizer(1.0).to(d_in_light.device),
                           (n, C, 4, 4))
    types = set(scene.bsdfs.types_present)

    fresnel = tuple(t for t in _FRESNEL if t in types)
    if fresnel:
        # plane of incidence from the half vector (the microfacet normal)
        h = m.normalize(d_out_light - d_in_light)
        ci = torch.abs(torch.sum(d_in_light * h, -1))
        s_axis = m.cross(d_in_light, h)
        sl = m.norm(s_axis)
        # near-normal incidence: the plane is undefined, any axis serves
        s_axis = torch.where((sl > 1e-6)[:, None],
                             s_axis / torch.clamp(sl, min=1e-6)[:, None],
                             basis_in)
        is_cond = (btype == BSDF_CONDUCTOR) | (btype == BSDF_ROUGHCONDUCTOR)
        eta_re = torch.where(is_cond[:, None], prm[:, 0:3], prm[:, 0:1])
        eta_im = torch.where(is_cond[:, None], prm[:, 3:6], 0.0)
        if lift is not None:
            eta_re, eta_im = lift(eta_re), lift(eta_im)
        # per channel, normalized by the unpolarized reflectance
        M_sp = mu.specular_reflection_fresnel(ci[:, None], eta_re, eta_im)
        M_sp = M_sp / torch.clamp(M_sp[..., 0:1, 0:1], min=1e-12)
        R_in = mu.rotator(mu.rotation_angle(d_in_light, basis_in, s_axis))
        R_out = mu.rotator(mu.rotation_angle(d_out_light, s_axis, basis_out))
        M_f = R_out[:, None] @ M_sp @ R_in[:, None]
        # dielectric transmission keeps the scalar weight, depolarized
        sel = _sel(btype, fresnel) & refl
        M = torch.where(sel[:, None, None, None], M_f, M)

    elements = tuple(t for t in _ELEMENTS if t in types)
    if elements:
        theta = prm[:, 0]
        # transmission axis: the shading frame's s rotated by theta about
        # n, projected perpendicular to the (straight) ray
        ax = si.sh_frame.s * torch.cos(theta)[:, None] \
            + si.sh_frame.t * torch.sin(theta)[:, None]
        ax = ax - torch.sum(ax * d_in_light, -1, keepdim=True) * d_in_light
        axl = m.norm(ax)
        ax = torch.where((axl > 1e-6)[:, None],
                         ax / torch.clamp(axl, min=1e-6)[:, None], basis_in)
        dev = d_in_light.device
        M_el = torch.broadcast_to(torch.eye(4, device=dev), (n, 4, 4))
        if BSDF_POLARIZER in elements:
            M_pol = (mu.linear_polarizer(1.0) * 2.0).to(dev)     # M00 = 1
            M_el = torch.where((btype == BSDF_POLARIZER)[:, None, None],
                               M_pol, M_el)
        if BSDF_RETARDER in elements:
            M_el = torch.where((btype == BSDF_RETARDER)[:, None, None],
                               mu.linear_retarder(prm[:, 1]), M_el)
        if BSDF_CIRCULAR in elements:
            left = (prm[:, 2] > 0.5)[:, None, None]
            M_cir = torch.where(left, mu.circular_polarizer(True, dev) * 2.0,
                                mu.circular_polarizer(False, dev) * 2.0)
            M_el = torch.where((btype == BSDF_CIRCULAR)[:, None, None],
                               M_cir, M_el)
        M_el = mu.rotate_mueller_basis(M_el, d_in_light, basis_in, ax,
                                       d_out_light, basis_out, ax)
        sel = _sel(btype, elements)
        M = torch.where(sel[:, None, None, None], M_el[:, None], M)
    return M


def bounce(scene: Scene, st: PolState) -> PolState:
    """One bounce of every lane: the MIS'd emission gathered along the
    ray, the polarized NEE on smooth vertices, then BSDF sampling, with
    the JAX bounce's draws in its order (next_2d, next_1d, next_1d,
    next_2d)."""
    n = st.ray_o.shape[0]
    active = st.active
    pk, refl, illum = lifts(scene, st.lam)
    lift = None if pk is None else pk.refl
    ray = Ray(o=st.ray_o, d=st.ray_d, maxt=st.ray_o.new_full((n,), INF))
    si = ray_intersect(scene, ray)
    si = shading_frame_with_bump(scene, si, ray)
    bidx = m.table_lookup(scene.shape_bsdf, torch.clamp(si.shape, min=0))

    # ---- emission along the BSDF ray, MIS-weighted (unpolarized sources:
    # S += T[..., :, 0] Le mis)
    em_val, eidx = eval_emitter_hit(scene, si, ray.d)
    env_val = eval_environment(scene, ray.d)
    em_val, env_val = illum(em_val), illum(env_val)
    escaped = ~si.valid
    eidx_mis = eidx
    if scene.emitters.env_index >= 0:
        eidx_mis = torch.where(escaped, scene.emitters.env_index, eidx)
    count_direct = (st.depth == 0) | ~st.prev_smooth
    em_pdf = pdf_emitter_direction(scene, st.prev_p, eidx_mis, si.p, si.ng,
                                   ray.d)
    em_pdf = torch.where(count_direct, 0.0, em_pdf)
    mis_bsdf = m.mis_weight(st.prev_pdf, em_pdf)
    contrib = torch.where(((eidx >= 0) & si.valid)[:, None], em_val, 0.0) \
        + torch.where(escaped[:, None], env_val, 0.0)
    S = st.S + torch.where(active[:, None, None],
                           st.T[..., :, 0]
                           * (contrib * mis_bsdf[:, None])[:, :, None], 0.0)

    active_next = active & si.valid & (st.depth + 1 < scene.max_depth)
    d_out_light = -ray.d              # light leaves toward the camera
    basis_out = mu.stokes_basis(d_out_light)

    # ---- polarized NEE: the connection's transfer applied to the
    # unpolarized emitter Stokes vector
    flags = m.table_lookup(scene.bsdfs.flags, torch.clamp(bidx, min=0))
    active_e = active_next & ((flags & F_SMOOTH) != 0)
    u2, sampler = st.sampler.next_2d()
    u1, sampler = sampler.next_1d()
    ds, em_weight = sample_emitter_direction(scene, si.p, u2, u1)
    nee_valid = active_e & (ds.pdf > 0)
    nee_valid = nee_valid & ~ray_test(scene, si.spawn_ray_to(ds.p))
    wo_local = si.to_local(ds.d)
    bval, bpdf = bsdf_eval_pdf(scene, si, bidx, wo_local)
    mis_em = m.mis_weight(ds.pdf, torch.where(ds.delta, 0.0, bpdf))
    refl_nee = m.cos_theta(wo_local) * m.cos_theta(si.wi) > 0
    d_in_nee = -ds.d                  # light travels emitter -> surface
    M_nee = _event_mueller(scene, si, refl_nee, d_in_nee, d_out_light,
                           mu.stokes_basis(d_in_nee), basis_out, lift)
    T_nee = st.T @ M_nee
    c_nee = refl(bval) * illum(em_weight) * mis_em[:, None]
    S = S + torch.where(nee_valid[:, None, None],
                        T_nee[..., :, 0] * c_nee[:, :, None], 0.0)

    # ---- BSDF sampling
    ub1, sampler = sampler.next_1d()
    ub2, sampler = sampler.next_2d()
    bs = bsdf_sample(scene, si, bidx, ub1, ub2)
    wo_world = si.to_world(bs.wo)
    new_ray = si.spawn_ray(wo_world)
    alive = active_next & (bs.pdf > 0) & torch.any(bs.weight != 0.0, -1)
    d_in_light = -wo_world            # light arrives along the new ray
    refl_bs = (bs.sampled_type & (F_DELTA_REFL | F_GLOSSY_REFL)) != 0
    M = _event_mueller(scene, si, refl_bs, d_in_light, d_out_light,
                       mu.stokes_basis(d_in_light), basis_out, lift)
    T = (st.T @ M) * refl(bs.weight)[:, :, None, None]

    a = alive[:, None]
    return dataclasses.replace(
        st, active=alive, depth=st.depth + 1,
        ray_o=torch.where(a, new_ray.o, st.ray_o),
        ray_d=torch.where(a, new_ray.d, st.ray_d),
        S=S, T=torch.where(alive[:, None, None, None], T, st.T),
        prev_p=torch.where(a, si.p, st.prev_p),
        prev_pdf=torch.where(alive, bs.pdf, st.prev_pdf),
        prev_smooth=torch.where(alive, (bs.sampled_type & F_DELTA) == 0,
                                st.prev_smooth),
        sampler=sampler)


def sample_stokes(scene: Scene, sampler: Sampler, ray: Ray):
    """Per-lane Stokes estimate -> ((N, 3, 4), sampler).  The loop runs
    while a lane is active and every depth is below max_depth (each
    bounce advances every lane's depth).  The spectral variant draws the
    hero wavelengths first, carries (N, N_SPEC, 4) and CIE-converts each
    component at the end (linear, so S1..S3 keep their signs)."""
    n = ray.o.shape[0]
    dev = ray.o.device
    f32 = dict(device=dev, dtype=torch.float32)
    lam, C = None, 3
    if scene.spectral:
        u, sampler = sampler.next_1d()
        lam, C = spec.sample_hero(u), spec.N_SPEC
    st = PolState(
        active=torch.ones((n,), dtype=torch.bool, device=dev),
        depth=torch.zeros((n,), dtype=torch.int64, device=dev),
        ray_o=ray.o, ray_d=ray.d,
        S=torch.zeros((n, C, 4), **f32),
        T=torch.broadcast_to(torch.eye(4, **f32), (n, C, 4, 4)),
        prev_p=ray.o, prev_pdf=torch.ones((n,), **f32),
        prev_smooth=torch.zeros((n,), dtype=torch.bool, device=dev),
        sampler=sampler, lam=lam)
    for _ in range(scene.max_depth):
        if not bool(st.active.any()):
            break
        st = bounce(scene, st)
    S = st.S
    if scene.spectral:
        S = torch.stack([spec.spec_to_rgb_estimate(S[:, :, k], st.lam)
                         for k in range(4)], -1)
    return S, st.sampler


@torch.no_grad()
def render_stokes(scene: Scene, spp: int = 16, seed: int = 0):
    """The full Stokes vector per pixel: (h, w, 4, 3) on the scene's
    device (stokes.cpp's S0..S3 outputs per RGB channel).  Box-filtered
    means of w * h * spp lanes whose sampler stratifies `spp` (not the
    scene's sample count), as the JAX package's; non-finite estimates
    count as 0.  Films past common.MAX_WAVEFRONT lanes run in passes of
    whole spp chunks, whose sums differ from one pass's in fp32 summation
    order only."""
    from . import common       # here: common imports this module
    w, h = scene.film_w, scene.film_h
    n_pix = w * h
    chunk = max(1, min(spp, common.MAX_WAVEFRONT // max(n_pix, 1)))
    total = torch.zeros((n_pix, 3, 4), device=scene.device)
    for s0 in range(0, spp, chunk):
        k = min(chunk, spp - s0)
        lane = torch.arange(n_pix * k, device=scene.device)
        pix = lane // k
        sampler = make_sampler(pix, lane % k + s0, seed,
                               kind=scene.sampler_kind, spp=spp)
        px = (pix % w).to(torch.float32)
        py = (pix // w).to(torch.float32)
        uf, sampler = sampler.next_2d()
        pos = torch.stack([px, py], -1) + uf
        S, _ = sample_stokes(scene, sampler, sample_ray(scene, pos))
        S = torch.where(torch.isfinite(S), S, 0.0)
        total += S.view(n_pix, k, 3, 4).sum(1)
    return (total / spp).view(h, w, 3, 4).permute(0, 1, 3, 2)
