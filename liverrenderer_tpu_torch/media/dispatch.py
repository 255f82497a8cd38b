"""Participating-media sampling over the wavefront (counterpart of
liverrenderer_tpu/media/dispatch.py), for the homogeneous medium and the
fork's bio media (glissonCapsule, parenchyma, liver).

Primal only: the score-function log-likelihood (`log_p`) that the JAX
package carries for gradients of the bio media comes with the gradient
slice (ROADMAP Queue 1 M7).  Its forward factor exp(log_p - log_p) is 1.
"""
from __future__ import annotations

import math

import torch

from ..core.types import INF, MediumInteraction
from ..errors import not_ported
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
    """spec (N,C), channel (N,) -> (N,)."""
    return torch.gather(spec, -1, channel[:, None])[:, 0]


def _select_rows(idx, *rows):
    """Per-lane pick among a small static set of (N, C) rows by idx."""
    out = rows[0]
    for r in range(1, len(rows)):
        out = torch.where((idx == r)[:, None], rows[r], out)
    return out


def _check_media(scene: Scene):
    if MEDIUM_HETEROGENEOUS in scene.media.types_present:
        raise not_ported("the heterogeneous (grid) medium", "Queue 1 M10")


def _bio_compute_distance(scene: Scene, mtype, prm, channel, sampler,
                          tissue_depth):
    """Competing-exponential element sampling for the bio media (liver.cpp
    computeDistance / glissonCapsule.cpp computeDistance) ->
    (bio_type, distance, sampler)."""
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

    # six uniforms (2 glisson + 4 parenchyma elements) in 2 hashes
    u6, sampler = sampler.next_nd(6)
    u6 = torch.clamp(u6, min=1e-7)           # guard r == 0 (liver.cpp)

    def exp_dist(sig_rgb, u):
        att = _index_spectrum(sig_rgb, channel)
        d = -torch.log(u) / torch.clamp(att, min=1e-20)
        return torch.where(att > 0, d, INF)

    # glisson branch: collagen vs elastin, both attenuators
    g_dist = torch.minimum(exp_dist(coll, u6[:, 0]), exp_dist(elas, u6[:, 1]))
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
    return bio_type, distance, sampler


def sample_interaction_candidate(scene: Scene, medium_idx, ray_o, ray_d,
                                 sampler, channel, tissue_depth, active):
    """Phase 1 of free-flight sampling: the tentative collision distance and
    the coefficients at the candidate point.  The distance law never
    depends on the surface distance, so the integrator samples the medium
    first and bounds its surface query by the candidate."""
    _check_media(scene)
    n = ray_o.shape[0]
    midx = torch.clamp(medium_idx, min=0)
    med = scene.media
    mtype = med.mtype[midx]
    prm = med.params[midx]
    scale = prm[:, 6]
    sigma_t_base = prm[:, 0:3] * scale[:, None]
    albedo = prm[:, 3:6]

    u, sampler = sampler.next_1d()
    u = torch.clamp(u, max=1.0 - 1e-7)

    tp = med.types_present
    majorant = sigma_t_base
    maj_c = _index_spectrum(majorant, channel)
    dist = -torch.log(1.0 - u) / torch.clamp(maj_c, min=1e-20)
    bio_type = torch.full((n,), BIO_ATTENUATOR, dtype=torch.int64,
                          device=ray_o.device)
    bio_present = any(t in tp for t in _BIO_TYPES) and bio_mode(scene)
    if bio_present:
        btype, bdist, sampler = _bio_compute_distance(
            scene, mtype, prm, channel, sampler, tissue_depth)
        is_bio = mtype >= MEDIUM_GLISSON
        dist = torch.where(is_bio, bdist, dist)
        bio_type = torch.where(is_bio, btype, bio_type)
    else:
        is_bio = torch.zeros((n,), dtype=torch.bool, device=ray_o.device)

    dist = dist.detach()
    p = ray_o + ray_d * torch.where(torch.isfinite(dist), dist, 0.0)[:, None]

    sigma_t = sigma_t_base
    sigma_s = sigma_t * albedo
    if MEDIUM_PARENCHYMA in tp and not bio_mode(scene):
        par = (mtype == MEDIUM_PARENCHYMA)[:, None]
        sigma_t = torch.where(par, ray_o.new_tensor(_PARENCHYMA_SIGMA_T),
                              sigma_t)
        sigma_s = torch.where(par, ray_o.new_tensor(_PARENCHYMA_SIGMA_S),
                              sigma_s)
    sigma_n = torch.clamp(majorant - sigma_t, min=0.0)
    return dict(dist=dist, p=p, sigma_t=sigma_t, sigma_s=sigma_s,
                sigma_n=sigma_n, majorant=majorant, bio_type=bio_type,
                is_bio=is_bio, bio_present=bio_present), sampler


def finalize_interaction(cand, maxt, channel, active) -> MediumInteraction:
    """Phase 2: apply the true segment bound (the surface distance) to the
    candidate collision: validity and the bio transmittance semantics
    (liver.cpp: one-hot channel for attenuators, 0 for absorbers)."""
    dist = cand["dist"]
    n = dist.shape[0]
    C = cand["sigma_t"].shape[-1]
    valid = active & (dist <= maxt) & (dist > 0)
    t = torch.where(valid, dist, INF)
    transmittance = torch.ones((n, C), device=dist.device)
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
    return MediumInteraction(
        t=t, p=cand["p"], sigma_s=cand["sigma_s"], sigma_n=cand["sigma_n"],
        sigma_t=cand["sigma_t"], combined_extinction=cand["majorant"],
        transmittance=transmittance)


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
    prm = scene.media.params[torch.clamp(medium_idx, min=0)]
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
