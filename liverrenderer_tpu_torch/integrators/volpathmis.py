"""Spectral-MIS volumetric path tracer, the reference's ``volpathmis``
(counterpart of liverrenderer_tpu/integrators/volpathmis.py; reference
src/integrators/volpathmis.cpp, SpectralMis variant).

Instead of a throughput and one sampled channel's pdf, every lane carries
two 3x3 weight matrices

    W[i, j] = prod over path events of ( p_j / f_i )

where row i is the channel a contribution is evaluated in and column j the
distance-sampling strategy that tracks channel j (`update_weights`).  The
balance heuristic over the three strategies gives channel i the weight
3 / sum_j W[i, j] (`mis_weight`); MIS between next-event estimation and
unidirectional sampling sums the two matrices before the row sum
(`mis_weight2`).  `p_over_f` weights the unidirectional estimator,
`p_over_f_nee` the same path as if its last real scatter vertex had been
reached by emitter sampling.  Every update is elementwise (N, 3, 3) math:
18 floats of lane state more than the single-channel scheme.

The integrator serves stock media with chromatic extinction; it reaches
bio media through the base majorant sampling, as stock volpath does
(media/dispatch.bio_mode).  It runs on the fixed wavefront only
(regen.regen_applicable): its primal walks every lane until all die or
4 * max_depth iterations, and its adjoint (`mode="ad"`) walks exactly
max_depth bounces, each under an activation checkpoint, with the NEE walk
bounded to max_depth steps.

Every sampler draw of the JAX bounce happens here too, in the same order.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.utils.checkpoint

from ..accel.intersect import ray_intersect
from ..bsdf.dispatch import (bsdf_eval_pdf, bsdf_sample,
                             eval_null_transmission)
from ..core import math as m
from ..core.rng import M32, Sampler
from ..core.types import INF, Ray
from ..emitter.dispatch import (eval_emitter_hit, eval_environment,
                                pdf_emitter_direction,
                                sample_emitter_direction)
from ..media.dispatch import (finalize_interaction, medium_phase,
                              sample_interaction,
                              sample_interaction_candidate,
                              transmittance_eval_pdf)
from ..phase.dispatch import phase_eval, phase_sample
from ..scene.ir import F_DELTA, F_NULL, F_SMOOTH, Scene
from .shading import shading_frame_with_bump
from .volpath import (WALK_DIMS, WALK_MAX_STEPS, _is_transition,
                      _target_medium)

Tensor = torch.Tensor
_N_CH = 3


def _spec(x, n: int, device) -> Tensor:
    """A scalar, (N,) or (N,3) quantity as (N,3)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if x.dim() == 0:
        return x.expand(n, _N_CH)
    if x.dim() == 1:
        return x[:, None].expand(n, _N_CH)
    return x


def _nan_to_zero(x):
    return torch.where(torch.isnan(x), 0.0, x)


class _WeightUpdate(torch.autograd.Function):
    """W[i, j] * p[j] / f[i] with the JAX package's masking (a zero f, a
    non-finite ratio or a nan product gives 0), and a reverse pass whose
    0 * inf terms are 0.

    The JAX package differentiates the plain expression, and its gradient
    is nan wherever a masked lane's zero cotangent meets 1 / f at f = 0
    (a homogeneous medium's sigma_n, at every null update), 1 / f^2 at an
    underflowing transmittance, or an entry that overflowed to inf (a long
    path through strongly chromatic extinction: p_j / f_i ~ exp((sigma_i -
    sigma_j) t); the row's MIS weight is then 0).  Such a term contributes
    nothing to the value, so its derivative is taken as 0 (ROADMAP Queue
    3)."""

    @staticmethod
    def forward(ctx, W, p, f):
        fz = (f == 0.0)[:, :, None]
        f_safe = torch.where(fz, 1.0, f[:, :, None])
        ratio = p[:, None, :] / f_safe                       # (N, i, j)
        ok = ~fz & torch.isfinite(ratio)
        ratio = torch.where(ok, ratio, 0.0)
        Wn = W * ratio
        keep = ~torch.isnan(Wn)
        ctx.save_for_backward(W, ratio, f_safe, ok & keep, keep)
        return torch.where(keep, Wn, 0.0)

    @staticmethod
    def backward(ctx, g):
        W, ratio, f_safe, ok, keep = ctx.saved_tensors
        gW = torch.where(keep, _nan_to_zero(g * ratio), 0.0)
        gWf = torch.where(ok, _nan_to_zero(g * W / f_safe), 0.0)
        gp = gWf.sum(1)
        gf = -_nan_to_zero(gWf * ratio).sum(2)
        return gW, gp, gf


def update_weights(W, p, f, active):
    """W[i, j] *= p[j] / f[i] where active: a zero f, a non-finite ratio
    or a nan product zeroes the entry (a strategy that cannot produce the
    event has probability 0 there).  Values as in the JAX package; its
    gradient stays finite where the JAX package's is nan
    (`_WeightUpdate`)."""
    n = W.shape[0]
    Wn = _WeightUpdate.apply(W, _spec(p, n, W.device), _spec(f, n, W.device))
    return torch.where(active[:, None, None], Wn, W)


def mis_weight(W):
    """The balance heuristic over the channel strategies, (N, 3)."""
    s = torch.sum(W, -1)
    return torch.where(s == 0.0, 0.0,
                       _N_CH / torch.where(s == 0.0, 1.0, s))


def mis_weight2(W1, W2):
    """The MIS'd weight of two strategy families, (N, 3)."""
    return mis_weight(W1 + W2)


@dataclass
class MisState:
    active: Tensor
    depth: Tensor
    ray_o: Tensor
    ray_d: Tensor
    L: Tensor
    p_over_f: Tensor        # (N,3,3) unidirectional weight matrix
    p_over_f_nee: Tensor    # (N,3,3) NEE-strategy weight matrix
    eta: Tensor
    medium: Tensor
    channel: Tensor         # distance-sampling channel (sampling only)
    prev_p: Tensor          # last real scatter vertex (the MIS reference)
    last_null: Tensor       # the last event was a null interaction
    specular_chain: Tensor
    valid: Tensor
    env_weight: Tensor      # (N,3) deferred environment weight
    sampler: Sampler


def init_state(ray: Ray, sampler: Sampler, scene: Scene) -> MisState:
    n = ray.o.shape[0]
    dev = ray.o.device
    u, sampler = sampler.next_1d()
    channel = torch.clamp((u * 3).to(torch.int64), max=2)
    f32 = dict(device=dev, dtype=torch.float32)
    ones = torch.ones((n, _N_CH, _N_CH), **f32)
    return MisState(
        active=torch.ones((n,), dtype=torch.bool, device=dev),
        depth=torch.zeros((n,), dtype=torch.int64, device=dev),
        ray_o=ray.o, ray_d=ray.d,
        L=torch.zeros((n, 3), **f32),
        p_over_f=ones, p_over_f_nee=ones,
        eta=torch.ones((n,), **f32),
        medium=torch.full((n,), scene.camera_medium, dtype=torch.int64,
                          device=dev),
        channel=channel,
        prev_p=ray.o,
        last_null=torch.zeros((n,), dtype=torch.bool, device=dev),
        specular_chain=torch.ones((n,), dtype=torch.bool, device=dev),
        valid=torch.zeros((n,), dtype=torch.bool, device=dev),
        env_weight=torch.zeros((n, 3), **f32),
        sampler=sampler,
    )


def sample_emitter_mis(scene: Scene, ref_p, medium, channel, W_in,
                       sampler: Sampler, active, max_steps: int,
                       bounded: bool):
    """NEE with per-channel ratio tracking along the shadow path (the
    reference's sample_emitter) -> (W_nee_end, W_uni_end, emitted, ds,
    sampler).

    W_nee_end continues W_in as if emitter sampling produced the
    connection, W_uni_end as if unidirectional sampling had walked the
    same shadow path; `emitted` is the emitter's radiance (the sample
    weight times its pdf).  Every medium collision on the shadow path is
    null.  `bounded` walks exactly max_steps steps (the adjoint), else
    until no lane walks (at most WALK_MAX_STEPS, one host sync each); the
    walk's draws come from a sampler then replaced by dim + WALK_DIMS."""
    n = ref_p.shape[0]
    u2, sampler = sampler.next_2d()
    u1, sampler = sampler.next_1d()
    ds, em_weight = sample_emitter_direction(scene, ref_p, u2, u1)
    emitted = em_weight * ds.pdf[:, None]
    active = active & (ds.pdf > 0)
    W_nee = update_weights(W_in, ds.pdf, 1.0, active)
    W_uni = W_in

    eps = (1.0 + torch.amax(torch.abs(ref_p), -1)) * 1e-4
    w_o = ref_p + ds.d * eps[:, None]
    remaining = ds.dist * (1.0 - 1e-3) - eps
    w_active, w_medium, w_sampler = active, medium, sampler
    zeros = ref_p.new_zeros((n,))

    def step():
        nonlocal w_o, w_active, w_medium, remaining, W_nee, W_uni, w_sampler
        act = w_active & (remaining > 0)
        si = ray_intersect(scene, Ray(o=w_o, d=ds.d, maxt=remaining),
                           shadow=True)
        surf_t = torch.minimum(si.t, remaining)
        in_med = act & (w_medium >= 0)
        mei, w_sampler = sample_interaction(
            scene, w_medium, w_o, ds.d, surf_t, w_sampler, channel, zeros,
            in_med)
        # the free-flight ratio per channel: the escape form of the pdf
        # where the surface (or the emitter) bounds the segment
        tr_a, ffpdf = transmittance_eval_pdf(scene, w_medium, mei, surf_t)
        W_nee = update_weights(W_nee, ffpdf, tr_a, in_med)
        W_uni = update_weights(W_uni, ffpdf, tr_a, in_med)
        scattered = in_med & mei.valid
        null_prob = torch.mean(
            mei.sigma_n / torch.clamp(mei.combined_extinction, min=1e-30),
            -1)
        W_nee = update_weights(W_nee, 1.0, mei.sigma_n, scattered)
        W_uni = update_weights(W_uni, null_prob, mei.sigma_n, scattered)

        hit_surface = act & ~scattered & si.valid & (si.t < remaining)
        null_tr = eval_null_transmission(
            scene, si, m.table_lookup(scene.shape_bsdf,
                                      torch.clamp(si.shape, min=0)))
        W_nee = update_weights(W_nee, 1.0, null_tr, hit_surface)
        W_uni = update_weights(W_uni, 1.0, null_tr, hit_surface)

        stp = torch.where(scattered, mei.t,
                          torch.where(hit_surface, si.t + 2e-4, 0.0))
        w_o = w_o + ds.d * stp[:, None]
        remaining = remaining - stp
        w_medium = torch.where(hit_surface & _is_transition(scene, si),
                               _target_medium(scene, si, ds.d), w_medium)
        w_active = (scattered | hit_surface) & (remaining > 0) & act \
            & (torch.amax(mis_weight(W_uni), -1) > 0)

    if bounded:
        for _ in range(max_steps):
            step()
    else:
        for _ in range(WALK_MAX_STEPS):
            if not bool(w_active.any()):         # one host sync per step
                break
            step()
    emitted = torch.where(active[:, None], emitted, 0.0)
    sampler_out = dataclasses.replace(
        sampler, dim=(sampler.dim + WALK_DIMS) & M32)
    return W_nee, W_uni, emitted, ds, sampler_out


def bounce(scene: Scene, st: MisState, bounded_nee: bool) -> MisState:
    """One bounce of every lane (volpathmis.cpp's loop body)."""
    n = st.ray_o.shape[0]
    sampler = st.sampler
    L = st.L
    depth = st.depth
    W = st.p_over_f
    W_nee = st.p_over_f_nee

    # ---- Russian roulette
    urr, sampler = sampler.next_1d()
    q = torch.clamp(torch.amax(mis_weight(W), -1) * st.eta * st.eta,
                    max=0.95)
    perform_rr = st.active & ~st.last_null & (depth > scene.rr_depth)
    active = st.active & ~((urr >= q) & perform_rr)
    W = update_weights(W, q.detach(), 1.0, perform_rr)
    active = active & (depth < scene.max_depth) \
        & torch.any(mis_weight(W) != 0.0, -1)
    in_medium = active & (st.medium >= 0)

    # ---- medium sampling first: the candidate bounds the surface query
    cand, sampler = sample_interaction_candidate(
        scene, st.medium, st.ray_o, st.ray_d, sampler, st.channel,
        st.ray_o.new_zeros((n,)), in_medium)
    ray_maxt = torch.where(in_medium & torch.isfinite(cand["dist"]),
                           cand["dist"], INF)
    ray = Ray(o=st.ray_o, d=st.ray_d, maxt=ray_maxt)
    si = ray_intersect(scene, ray)
    si = shading_frame_with_bump(scene, si, ray)

    mei = finalize_interaction(cand, si.t, st.channel, in_medium)
    tr_a, ffpdf = transmittance_eval_pdf(scene, st.medium, mei, si.t)
    W = update_weights(W, ffpdf, tr_a, in_medium)
    W_nee = update_weights(W_nee, ffpdf, tr_a, in_medium)
    escaped = in_medium & ~mei.valid
    act_medium = in_medium & mei.valid

    # null vs real split by the mean null probability
    null_prob = torch.mean(
        mei.sigma_n / torch.clamp(mei.combined_extinction, min=1e-30), -1)
    u_nr, sampler = sampler.next_1d()
    null_scatter = u_nr < null_prob
    act_null = act_medium & null_scatter
    act_real = act_medium & ~null_scatter
    last_null = act_null
    depth = torch.where(act_real, depth + 1, depth)
    reached_max = depth >= scene.max_depth
    act_real = act_real & ~reached_max
    W = update_weights(W, null_prob, mei.sigma_n, act_null)
    W_nee = update_weights(W_nee, 1.0, mei.sigma_n, act_null)
    W = update_weights(W, 1.0 - null_prob, mei.sigma_s, act_real)
    valid = st.valid | act_real
    specular_chain = st.specular_chain & ~act_real

    ptype, g, pprm = medium_phase(scene, st.medium)
    nee_med = act_real & (depth + 1 <= scene.max_depth)
    if not scene.needs_medium_nee:
        nee_med = torch.zeros_like(nee_med)

    # ---- surface emission and escape
    active_surface = (active & ~in_medium) | escaped
    em_val, eidx = eval_emitter_hit(scene, si, st.ray_d)
    esc_env = ~si.valid
    eidx_mis = eidx
    if scene.emitters.env_index >= 0:
        eidx_mis = torch.where(esc_env, scene.emitters.env_index, eidx)
    count_direct = (st.depth == 0) | st.specular_chain
    hit_any = active_surface & (((eidx >= 0) & si.valid) | esc_env)
    needs_nee = scene.needs_surface_nee or scene.needs_medium_nee
    if needs_nee:
        em_pdf = pdf_emitter_direction(scene, st.prev_p, eidx_mis, si.p,
                                       si.ng, st.ray_d)
        # the emitter-pdf factor stays in p_over_f_nee
        W_nee = update_weights(W_nee, em_pdf, 1.0, hit_any & ~count_direct)
    hide = scene.hide_emitters & (st.depth == 0)
    gather = hit_any & ~hide & ~reached_max
    w_hit = torch.where(count_direct[:, None], mis_weight(W),
                        mis_weight2(W, W_nee))
    L = L + torch.where((gather & (eidx >= 0) & si.valid)[:, None],
                        w_hit * em_val, 0.0)
    env_weight = st.env_weight + torch.where((gather & esc_env)[:, None],
                                             w_hit, 0.0)
    active_surface = active_surface & si.valid & ~reached_max
    bsdf_idx = m.table_lookup(scene.shape_bsdf, torch.clamp(si.shape, min=0))

    # ---- NEE: one shared walk for medium and surface lanes
    if needs_nee:
        flags = scene.bsdfs.flags[torch.clamp(bsdf_idx, min=0)]
        nee_s = active_surface & ((flags & F_SMOOTH) != 0) \
            & (depth + 1 < scene.max_depth)
        if not scene.needs_surface_nee:
            nee_s = torch.zeros_like(nee_s)
        nee_any = nee_s | nee_med
        ref_p = torch.where(nee_med[:, None], mei.p, si.p)
        W_nee_end, W_uni_end, emitted, ds, sampler = sample_emitter_mis(
            scene, ref_p, st.medium, st.channel, W, sampler, nee_any,
            scene.max_depth, bounded_nee)
        bval, bpdf = bsdf_eval_pdf(scene, si, bsdf_idx, si.to_local(ds.d))
        ph_val = phase_eval(ptype, g, m.dot(st.ray_d, ds.d), pprm, st.ray_d,
                            ds.d, scene.media.phase_types)
        cval = torch.where(nee_med[:, None], ph_val[:, None], bval)
        cpdf = torch.where(nee_med, ph_val, bpdf)
        W_nee_end = update_weights(W_nee_end, 1.0, cval, nee_any)
        W_uni_end = update_weights(
            W_uni_end, torch.where(ds.delta, 0.0, cpdf), cval, nee_any)
        L = L + torch.where(nee_any[:, None],
                            mis_weight2(W_nee_end, W_uni_end) * emitted, 0.0)

    # a real scatter resets the NEE matrix to the unidirectional one
    W_nee = torch.where(act_real[:, None, None], W, W_nee)

    # ---- phase sampling (detached direction and pdf)
    u2p, sampler = sampler.next_2d()
    wo_med, _, ppdf = phase_sample(ptype, g, st.ray_d, u2p, pprm,
                                   scene.media.phase_types)
    wo_med = wo_med.detach()
    ppdf = ppdf.detach()
    pval = phase_eval(ptype, g, m.dot(st.ray_d, wo_med), pprm, st.ray_d,
                      wo_med, scene.media.phase_types)
    act_real = act_real & (ppdf > 0)
    W = update_weights(W, ppdf, pval, act_real)
    W_nee = update_weights(W_nee, 1.0, pval, act_real)

    # ---- BSDF sampling; f = weight * pdf is the BSDF value
    ub1, sampler = sampler.next_1d()
    ub2, sampler = sampler.next_2d()
    bs = bsdf_sample(scene, si, bsdf_idx, ub1, ub2)
    wo_surf = si.to_world(bs.wo)
    surf_ok = active_surface & (bs.pdf > 0)
    non_null = surf_ok & ((bs.sampled_type & F_NULL) == 0)
    eta = torch.where(surf_ok, st.eta * bs.eta, st.eta)
    depth = torch.where(non_null, depth + 1, depth)
    valid = valid | non_null
    new_spec = (bs.sampled_type & F_DELTA) != 0
    specular_chain = (specular_chain | (non_null & new_spec)) \
        & ~(surf_ok & ~new_spec)
    bsdf_f = bs.weight * bs.pdf[:, None]
    W_nee = torch.where(non_null[:, None, None], W, W_nee)
    W = update_weights(W, bs.pdf, bsdf_f, surf_ok)
    W_nee = update_weights(W_nee, 1.0, bsdf_f, non_null)
    new_medium = torch.where(surf_ok & _is_transition(scene, si),
                             _target_medium(scene, si, wo_surf), st.medium)

    # ---- next ray
    sr = si.spawn_ray(wo_surf)
    med_move = act_real | act_null
    next_o = torch.where(med_move[:, None], mei.p,
                         torch.where(surf_ok[:, None], sr.o, st.ray_o))
    next_d = torch.where(act_real[:, None], wo_med,
                         torch.where(surf_ok[:, None], wo_surf, st.ray_d))
    prev_p = torch.where(act_real[:, None], mei.p,
                         torch.where(non_null[:, None], si.p, st.prev_p))
    alive = (act_real | act_null | surf_ok) & (depth < scene.max_depth) \
        & torch.any(mis_weight(W) != 0.0, -1)
    return dataclasses.replace(
        st, active=alive, depth=depth, ray_o=next_o, ray_d=next_d, L=L,
        p_over_f=W, p_over_f_nee=W_nee, eta=eta,
        medium=torch.where(med_move, st.medium, new_medium),
        prev_p=prev_p, last_null=last_null, specular_chain=specular_chain,
        valid=valid, env_weight=env_weight, sampler=sampler)


def sample(scene: Scene, sampler: Sampler, ray: Ray, mode: str = "primal"):
    """Fixed-wavefront walk -> (L, valid, sampler).  primal: bounce until
    every lane dies or 4 * max_depth iterations (null events do not count
    depth); ad: exactly max_depth bounces under activation checkpoints,
    with the NEE walk bounded."""
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
    L = st.L + st.env_weight * eval_environment(scene, st.ray_d)
    return L, st.valid, st.sampler
