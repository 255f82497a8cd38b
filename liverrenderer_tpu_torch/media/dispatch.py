"""Participating-media sampling over the wavefront (counterpart of
liverrenderer_tpu/media/dispatch.py), for the homogeneous medium, the
heterogeneous (grid) medium and the fork's bio media (glissonCapsule,
parenchyma, liver).

The heterogeneous medium samples its free flight against a global
majorant (the grid's maximum times its scale) and reads the trilinear
density at the candidate point; the integrator splits the collision into
real and null by sigma_t / majorant (null-collision tracking).

The sampled collision distance is detached (differentiable delta
tracking): parameter gradients flow through the coefficients, the
transmittance/pdf ratios and, for the bio media, the score-function
log-likelihood `log_p` of the sampled event, which the integrator folds in
as exp(log_p - log_p.detach()) (value 1, derivative d log_p).

The spectral variant passes the lanes' hero-wavelength packet
(core/spectrum.Packet; the JAX package's `lam`): every RGB coefficient
(sigma_t, the albedo, the bio elements' sigmas, the standard parenchyma's
hard-coded pair) is lifted to the packet by the Smits basis, and the
tracked channel indexes packet entries.
"""
from __future__ import annotations

import math

import torch

from ..core import math as m
from ..core.types import INF, MediumInteraction
from ..scene.ir import (MEDIUM_GLISSON, MEDIUM_HETEROGENEOUS, MEDIUM_LIVER,
                        MEDIUM_PARENCHYMA, Scene)

# EBioType codes (reference src/media/organic_material.h)
BIO_ATTENUATOR = 0
BIO_ABSORBER = 1
BIO_ABSORBER_AND_ATTENUATOR = 2
HEPATOCYTE_MEAN_DIAMETER = 0.0025

# parenchyma.cpp hard-codes the standard-path (sigma_t, sigma_s)
_PARENCHYMA_SIGMA_T = (77.2 / 255.0, 105.0 / 255.0, 149.0 / 255.0)
_PARENCHYMA_SIGMA_S = (74.0 / 255.0, 88.0 / 255.0, 101.0 / 255.0)

_BIO_TYPES = (MEDIUM_GLISSON, MEDIUM_PARENCHYMA, MEDIUM_LIVER)


def _index_spectrum(spec, channel):
    """spec (N,C), channel (N,) -> (N,): C = 3 (RGB) or N_SPEC (the
    tracked channel indexes the lane's wavelength packet)."""
    return torch.gather(spec, -1, channel[:, None])[:, 0]


def _lift(v3, packet):
    """RGB (N,...,3) -> the packet's (N,...,N_SPEC) by the Smits basis in
    the spectral variant (packet given), identity otherwise."""
    return v3 if packet is None else packet.refl(v3)


def _select_rows(idx, *rows):
    """Per-lane pick among a small static set of (N, C) rows by idx."""
    out = rows[0]
    for r in range(1, len(rows)):
        out = torch.where((idx == r)[:, None], rows[r], out)
    return out


class _GridGather(torch.autograd.Function):
    """flat[idx] whose backward index_adds into ONE grid-shaped buffer.

    A lookup reads 8 taps per lane; as eight separate gathers autograd
    would give each tap's backward its own grid-sized zero buffer (268 MB
    each for a 256^3 x 4 grid) and sum them.  One gather of the (N, 8)
    taps keeps it to one buffer per lookup."""

    @staticmethod
    def forward(ctx, flat, idx):
        ctx.save_for_backward(idx)
        ctx.numel = flat.numel()
        return flat[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        out = g.new_zeros(ctx.numel)
        out.index_add_(0, idx.reshape(-1), g.reshape(-1))
        return out, None


def _eval_grid(scene: Scene, gid, p):
    """Trilinear density lookup: world points p (N,3) in grids gid (N,)
    -> (N,).  Channel 0 of the grid, clamped at its edges (reference
    src/volumes/grid.cpp interpolation)."""
    med = scene.media
    g2l = med.grid_to_local[gid]
    pl = (g2l[:, :3, :3] @ p[:, :, None])[:, :, 0] + g2l[:, :3, 3]
    whd = med.grid_whd[gid]                       # (N, 3) = (D, H, W)
    dims = whd.to(torch.float32) - 1.0
    x = torch.clamp(pl[:, 0], 0.0, 1.0) * dims[:, 2]
    y = torch.clamp(pl[:, 1], 0.0, 1.0) * dims[:, 1]
    z = torch.clamp(pl[:, 2], 0.0, 1.0) * dims[:, 0]
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    fx, fy, fz = x - x0, y - y0, z - z0
    x0, y0, z0 = x0.to(torch.int64), y0.to(torch.int64), z0.to(torch.int64)
    _, D, H, W, C = med.grids.shape
    idx, wts = [], []
    for dz in (0, 1):
        wz = fz if dz else 1 - fz
        zi = torch.minimum(z0 + dz, whd[:, 0] - 1)
        for dy in (0, 1):
            wy = fy if dy else 1 - fy
            yi = torch.minimum(y0 + dy, whd[:, 1] - 1)
            for dx in (0, 1):
                wx = fx if dx else 1 - fx
                xi = torch.minimum(x0 + dx, whd[:, 2] - 1)
                idx.append((((gid * D + zi) * H + yi) * W + xi) * C)
                wts.append(wz * wy * wx)
    taps = _GridGather.apply(med.grids.reshape(-1), torch.stack(idx, -1))
    # taps summed in the JAX package's order
    c = wts[0] * taps[:, 0]
    for k in range(1, 8):
        c = c + wts[k] * taps[:, k]
    return c


def _bio_compute_distance(scene: Scene, mtype, prm, channel, sampler,
                          tissue_depth, packet=None):
    """Competing-exponential element sampling for the bio media (liver.cpp
    computeDistance / glissonCapsule.cpp computeDistance) ->
    (bio_type, distance, rate_total, rate_chosen, sampler).  The rates are
    the differentiable event rates of the score estimator: the joint
    density of (t, chosen element e) is rate_e * exp(-rate_total * t)."""
    n = channel.shape[0]
    # layer binning by tissue depth
    limits = prm[:, 36:40]
    layer = torch.sum(tissue_depth[:, None] > limits, dim=1)     # 0..4
    layer = torch.where(mtype == MEDIUM_PARENCHYMA, 4, layer)
    layer = torch.where(mtype == MEDIUM_GLISSON,
                        torch.clamp(layer, max=3), layer)
    in_glisson = layer < 4

    lay = torch.clamp(layer, max=3)
    coll = _select_rows(lay, prm[:, 12:15], prm[:, 15:18], prm[:, 18:21],
                        prm[:, 21:24])
    elas = _select_rows(lay, prm[:, 24:27], prm[:, 27:30], prm[:, 30:33],
                        prm[:, 33:36])

    # parenchyma coefficients: PARENCHYMA rows pack at 12.., LIVER at 40..
    is_liver = (mtype == MEDIUM_LIVER)[:, None]
    blood = torch.where(is_liver, prm[:, 40:43], prm[:, 12:15])
    bile = torch.where(is_liver, prm[:, 43:46], prm[:, 15:18])
    lipid = torch.where(is_liver, prm[:, 48:51], prm[:, 18:21])
    hep = torch.where(mtype == MEDIUM_LIVER, prm[:, 46], prm[:, 21])
    if packet is not None:
        # each element's RGB sigma lifted to the packet, the five in one
        # pass of the lift
        coll, elas, blood, bile, lipid = packet.refl(torch.stack(
            [coll, elas, blood, bile, lipid], 1)).unbind(1)

    # six uniforms (2 glisson + 4 parenchyma elements) in 2 hashes
    u6, sampler = sampler.next_nd(6)
    u6 = torch.clamp(u6, min=1e-7)           # guard r == 0 (liver.cpp)

    def exp_dist(sig_rgb, u):
        att = _index_spectrum(sig_rgb, channel)
        d = -torch.log(u) / torch.clamp(att, min=1e-20)
        return torch.where(att > 0, d, INF)

    # glisson branch: collagen vs elastin, both attenuators
    d_coll = exp_dist(coll, u6[:, 0])
    d_elas = exp_dist(elas, u6[:, 1])
    g_dist = torch.minimum(d_coll, d_elas)
    # parenchyma branch: blood/bile/lipid absorbers + hepatocyte, whose
    # distance is -log10(sigma+1) * log(r) (liver.cpp)
    log10_hep = torch.log(torch.clamp(hep + 1.0, min=1.0)) / math.log(10.0)
    d_hep = torch.where(hep > 0, -log10_hep * torch.log(u6[:, 5]), INF)
    dists = torch.stack([exp_dist(blood, u6[:, 2]), exp_dist(bile, u6[:, 3]),
                         exp_dist(lipid, u6[:, 4]), d_hep], -1)
    p_dist = dists.amin(-1)
    elem = torch.argmin(dists, dim=-1)      # first minimum, as jnp.argmin
    p_type = torch.where(elem == 3, BIO_ABSORBER_AND_ATTENUATOR,
                         BIO_ABSORBER)
    g_type = torch.full((n,), BIO_ATTENUATOR, dtype=torch.int64,
                        device=channel.device)
    bio_type = torch.where(in_glisson, g_type, p_type)
    distance = torch.where(in_glisson, g_dist, p_dist)

    # event rates; the hepatocyte's t = -log10(sigma+1) * log(u) is an
    # exponential with rate 1/log10(sigma+1)
    r_coll = _index_spectrum(coll, channel)
    r_elas = _index_spectrum(elas, channel)
    g_total = r_coll + r_elas
    g_chosen = torch.where(d_coll <= d_elas, r_coll, r_elas)
    rate_hep = torch.where(hep > 0,
                           1.0 / torch.clamp(log10_hep, min=1e-12), 0.0)
    r_blood = _index_spectrum(blood, channel)
    r_bile = _index_spectrum(bile, channel)
    r_lipid = _index_spectrum(lipid, channel)
    p_total = torch.stack([r_blood, r_bile, r_lipid, rate_hep], -1).sum(-1)
    p_chosen = torch.where(elem == 0, r_blood,
                           torch.where(elem == 1, r_bile,
                                       torch.where(elem == 2, r_lipid,
                                                   rate_hep)))
    rate_total = torch.where(in_glisson, g_total, p_total)
    rate_chosen = torch.where(in_glisson, g_chosen, p_chosen)
    return bio_type, distance, rate_total, rate_chosen, sampler


def sample_interaction_candidate(scene: Scene, medium_idx, ray_o, ray_d,
                                 sampler, channel, tissue_depth, active,
                                 packet=None):
    """Phase 1 of free-flight sampling: the tentative collision distance and
    the coefficients at the candidate point.  The distance law never
    depends on the surface distance, so the integrator samples the medium
    first and bounds its surface query by the candidate."""
    n = ray_o.shape[0]
    midx = torch.clamp(medium_idx, min=0)
    med = scene.media
    mtype = med.mtype[midx]
    prm = m.table_lookup(med.params, midx)
    scale = prm[:, 6]
    sigma_t_base = _lift(prm[:, 0:3] * scale[:, None], packet)
    albedo = _lift(prm[:, 3:6], packet)

    u, sampler = sampler.next_1d()
    u = torch.clamp(u, max=1.0 - 1e-7)

    tp = med.types_present
    majorant = sigma_t_base
    if MEDIUM_HETEROGENEOUS in tp:
        het = (mtype == MEDIUM_HETEROGENEOUS)[:, None]
        majorant = torch.where(het, (prm[:, 10] * scale)[:, None], majorant)
    maj_c = _index_spectrum(majorant, channel)
    dist = -torch.log(1.0 - u) / torch.clamp(maj_c, min=1e-20)
    bio_type = torch.full((n,), BIO_ATTENUATOR, dtype=torch.int64,
                          device=ray_o.device)
    bio_present = any(t in tp for t in _BIO_TYPES) and bio_mode(scene)
    if bio_present:
        btype, bdist, rate_total, rate_chosen, sampler = \
            _bio_compute_distance(scene, mtype, prm, channel, sampler,
                                  tissue_depth, packet)
        is_bio = mtype >= MEDIUM_GLISSON
        dist = torch.where(is_bio, bdist, dist)
        bio_type = torch.where(is_bio, btype, bio_type)
    else:
        is_bio = torch.zeros((n,), dtype=torch.bool, device=ray_o.device)
        rate_total = rate_chosen = ray_o.new_zeros((n,))

    # the sampled distance carries no derivative (detached sampling)
    dist = dist.detach()
    p = ray_o + ray_d * torch.where(torch.isfinite(dist), dist, 0.0)[:, None]

    sigma_t = sigma_t_base
    if MEDIUM_HETEROGENEOUS in tp:
        # a heterogeneous medium without a grid reads grid 0, as in the
        # JAX package (ROADMAP Queue 3)
        gid = torch.clamp(med.grid_id[midx], min=0)
        dens = _eval_grid(scene, gid, p) * scale
        sigma_t = torch.where(het, dens[:, None], sigma_t)
    sigma_s = sigma_t * albedo
    if MEDIUM_PARENCHYMA in tp and not bio_mode(scene):
        par = (mtype == MEDIUM_PARENCHYMA)[:, None]
        st_hc = ray_o.new_tensor(_PARENCHYMA_SIGMA_T)
        ss_hc = ray_o.new_tensor(_PARENCHYMA_SIGMA_S)
        if packet is not None:
            st_hc = packet.refl(st_hc.expand(n, 3))
            ss_hc = packet.refl(ss_hc.expand(n, 3))
        sigma_t = torch.where(par, st_hc, sigma_t)
        sigma_s = torch.where(par, ss_hc, sigma_s)
    # maximum, not clamp: at sigma_t = majorant (a heterogeneous medium at
    # its grid's maximum) its derivative is split evenly, as jnp.maximum's
    sigma_n = torch.maximum(majorant - sigma_t, torch.zeros_like(sigma_t))
    return dict(dist=dist, p=p, sigma_t=sigma_t, sigma_s=sigma_s,
                sigma_n=sigma_n, majorant=majorant, bio_type=bio_type,
                is_bio=is_bio, rate_total=rate_total,
                rate_chosen=rate_chosen, bio_present=bio_present), sampler


def finalize_interaction(cand, maxt, channel, active) -> MediumInteraction:
    """Phase 2: apply the true segment bound (the surface distance) to the
    candidate collision: validity, the bio transmittance semantics
    (liver.cpp: one-hot channel for attenuators, 0 for absorbers) and the
    score estimator's log-likelihood of the realized event."""
    dist = cand["dist"]
    n = dist.shape[0]
    C = cand["sigma_t"].shape[-1]
    valid = active & (dist <= maxt) & (dist > 0)
    t = torch.where(valid, dist, INF)
    transmittance = torch.ones((n, C), device=dist.device)
    log_p = torch.zeros((n,), device=dist.device)
    if cand["bio_present"]:
        bio_type = cand["bio_type"]
        absorbed = (bio_type == BIO_ABSORBER) \
            | ((bio_type == BIO_ABSORBER_AND_ATTENUATOR)
               & (dist < HEPATOCYTE_MEAN_DIAMETER))
        onehot = torch.nn.functional.one_hot(channel, C).to(torch.float32)
        tr_bio = torch.where(valid[:, None],
                             torch.where(absorbed[:, None], 0.0, onehot),
                             1.0)
        transmittance = torch.where(cand["is_bio"][:, None], tr_bio,
                                    transmittance)
        # score estimator: the sampled distance and element are detached;
        # the log-likelihood of the realized event (scatter at t_det, or
        # escape past it) carries the derivative
        t_det = torch.minimum(dist, maxt).detach()
        t_det = torch.where(torch.isfinite(t_det), t_det, 0.0)
        scattered_b = valid.detach()
        lp_scatter = torch.log(torch.clamp(cand["rate_chosen"], min=1e-20)) \
            - cand["rate_total"] * t_det
        lp_escape = -cand["rate_total"] * t_det
        lp = torch.where(scattered_b, lp_scatter, lp_escape)
        log_p = torch.where(cand["is_bio"] & active, lp, 0.0)
    return MediumInteraction(
        t=t, p=cand["p"], sigma_s=cand["sigma_s"], sigma_n=cand["sigma_n"],
        sigma_t=cand["sigma_t"], combined_extinction=cand["majorant"],
        transmittance=transmittance, log_p=log_p)


def sample_interaction(scene: Scene, medium_idx, ray_o, ray_d, maxt,
                       sampler, channel, tissue_depth, active, packet=None):
    """Free-flight sample in each lane's medium over [0, maxt] ->
    (MediumInteraction, sampler); mei.t = inf where the lane reached maxt
    first.  The NEE shadow walk calls it once per step."""
    cand, sampler = sample_interaction_candidate(
        scene, medium_idx, ray_o, ray_d, sampler, channel, tissue_depth,
        active, packet)
    return finalize_interaction(cand, maxt, channel, active), sampler


def transmittance_eval_pdf(scene: Scene, medium_idx, mei: MediumInteraction,
                           surf_t):
    """Analytic transmittance + free-flight pdf along
    [0, min(mei.t, surf_t)] with respect to the majorant."""
    t = torch.minimum(mei.t, surf_t)
    t = torch.where(torch.isfinite(t), t, 0.0)
    tr = torch.exp(-t[:, None] * mei.combined_extinction)
    pdf = torch.where((surf_t < mei.t)[:, None], tr,
                      tr * mei.combined_extinction)
    return tr, pdf


def medium_phase(scene: Scene, medium_idx):
    """(phase_type, g, param_row) lanes for the medium table."""
    prm = m.table_lookup(scene.media.params, torch.clamp(medium_idx, min=0))
    return prm[:, 8].to(torch.int64), prm[:, 7], prm


def bio_mode(scene: Scene) -> bool:
    """Whether the bio competing-exponential sampling applies: only the
    biovolpath family calls the tissue-depth sample_interaction overload;
    stock volpath reaches bio media through the base majorant sampling."""
    return scene.integrator in ("biovolpath", "biovolpath06")


def medium_is_bio(scene: Scene, medium_idx):
    is_bio_type = scene.media.mtype[torch.clamp(medium_idx, min=0)] \
        >= MEDIUM_GLISSON
    if not bio_mode(scene):
        return torch.zeros_like(is_bio_type)
    return is_bio_type
