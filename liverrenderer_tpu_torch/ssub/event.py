"""The wavefront subsurface-scattering event of `vaescatter` (counterpart of
liverrenderer_tpu/ssub/event.py).

The reference recurses from the path integrator into VaeScatter::LoImpl:
(1) a zero-scattering test straight through the object, (2) one random
RGB channel (weight 3 * onehot), (3) an exit position sampled by the VAE
decoder, (4) its projection onto the real surface along the polynomial's
gradient, (5) a cosine-lobe exit with NEE and MIS at the exit point.  On
the wavefront the event takes one bounce and rewrites the lane's ray to
the exit ray; the exit NEE happens inline.  The JAX package's deviations
are kept: a zero-scatter pass-through continues the straight ray from its
exit point, and S_w is the normalised diffuse transmission
(1 - Fr(cos)) / (pi c), c = 1 - 2 C1(1/eta).

Every lane runs the event's six intersection queries (the zero-scatter
ray, two bounded and two unbounded projection rays, the exit shadow ray)
and draws its twelve sampler dimensions, in the JAX package's order:
next_1d x3, next_nd(4), next_2d, next_2d, next_1d.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..accel.intersect import ray_intersect, ray_test
from ..core import math as m
from ..core.fresnel import fresnel_dielectric
from ..core.types import INF, Ray
from ..core.warp import square_to_cosine_hemisphere
from ..emitter.dispatch import sample_emitter_direction
from ..media.dispatch import _index_spectrum
from .poly import (eval_poly_grad, fit_scale, kernel_eps, onb_duff,
                   poly_normal_and_adjusted_dir, rotate_poly)
from .vae import gaussian_from_uniform

Tensor = torch.Tensor


def fresnel_moment1(eta):
    """The first Fresnel moment C1 (FresnelMoment1)."""
    e2, e3 = eta * eta, eta ** 3
    e4, e5 = eta ** 4, eta ** 5
    lo = 0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3 \
        + 2.49277 * e4 - 0.68441 * e5
    hi = -4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3 \
        - 1.27198 * e4 + 0.12746 * e5
    return torch.where(eta < 1.0, lo, hi)


def sw_factor(cos_o, eta):
    """The normalised diffuse transmission factor S_w:
    (1 - Fr(cos)) / (c pi), c = 1 - 2 C1(1/eta)."""
    fr = fresnel_dielectric(cos_o, eta)[0]
    c = 1.0 - 2.0 * fresnel_moment1(1.0 / eta)
    return (1.0 - fr) / torch.clamp(c * math.pi, min=1e-6)


@dataclass
class SSEvent:
    """What the event did to each lane."""
    alive: Tensor        # (N,) the lane continues
    passthrough: Tensor  # (N,) zero-scatter straight continuation
    out_p: Tensor        # (N,3) continuation origin
    out_d: Tensor        # (N,3) continuation direction
    out_n: Tensor        # (N,3) exit normal
    weight: Tensor       # (N,3) throughput multiplier
    pdf: Tensor          # (N,) pdf of the continuation direction
    L_nee: Tensor        # (N,3) the exit point's NEE (times the weight)
    absorbed: Tensor     # (N,) killed by the VAE's absorption head
    absorb_p: Tensor     # (N,) the absorption probability


def _nearest_vertex_poly(scene, si):
    """(N, 3, 20) world-space coefficients of the hit triangle's corner
    nearest the hit point, and that vertex; ties take the first corner."""
    prim = torch.clamp(si.prim, 0, scene.faces.shape[0] - 1)
    f = scene.faces[prim]
    d = torch.stack([torch.sum((si.p - scene.vertices[f[:, k]]) ** 2, -1)
                     for k in range(3)], -1)
    vid = torch.gather(f, 1, torch.argmin(d, -1, keepdim=True))[:, 0]
    return scene.ssub.poly[vid], vid


def subsurface_event(scene, si, refr_d, sampler, active):
    """The VAE event for `active` lanes: si is the entry interaction (hit
    from outside), refr_d the world direction refracted into the object.
    Returns (SSEvent, sampler)."""
    n = refr_d.shape[0]
    ss_idx = m.table_lookup(scene.shape_subsurface,
                            torch.clamp(si.shape, min=0))
    prm = m.table_lookup(scene.ssub.params, torch.clamp(ss_idx, min=0))
    sigma_t, albedo = prm[:, 0:3], prm[:, 3:6]
    g, eta = prm[:, 6], prm[:, 7]
    vae = scene.ssub.weights

    # 1) zero-scatter test
    eps0 = (1.0 + torch.amax(torch.abs(si.p), -1)) * 1e-4
    zits = ray_intersect(scene, Ray(o=si.p + refr_d * eps0[:, None],
                                    d=refr_d, maxt=si.p.new_full((n,), INF)))
    dead = active & ~zits.valid                # no exit found: degenerate
    u_zs, sampler = sampler.next_1d()
    p_scatter = 1.0 - torch.exp(-torch.mean(sigma_t, -1) * zits.t)
    passthrough = active & zits.valid & (u_zs > p_scatter)
    do_vae = active & zits.valid & ~passthrough

    # 2) channel pick and the polynomial's features
    u_ch, sampler = sampler.next_1d()
    channel = torch.clamp((u_ch * 3).to(torch.int64), max=2)
    poly3, vid = _nearest_vertex_poly(scene, si)
    ch3 = channel[:, None]
    coeffs_ws = torch.where(ch3 == 0, poly3[:, 0],
                            torch.where(ch3 == 1, poly3[:, 1], poly3[:, 2]))
    sig_c = _index_spectrum(sigma_t, channel)
    alb_c = _index_spectrum(albedo, channel)
    k_eps = kernel_eps(sig_c, alb_c, g, scene.ssub.kernel_eps_scale)
    f_scale = fit_scale(k_eps)
    # the reference's inDir = -d, d refracted into the object
    in_dir = -refr_d
    _, in_dir_adj = poly_normal_and_adjusted_dir(coeffs_ws, in_dir,
                                                 si.sh_frame.n)
    # the light-space frame around the adjusted direction
    s_ax, t_ax = onb_duff(in_dir_adj)
    coeffs_ls = rotate_poly(coeffs_ws,
                            torch.stack([s_ax, t_ax, in_dir_adj], -1))

    # 3) the networks
    feat = vae.shared_features(vae.preprocess_features(coeffs_ls, alb_c, g,
                                                       eta, sig_c))
    absorb_p = vae.absorption_prob(feat)
    u_abs, sampler = sampler.next_1d()
    absorbed = do_vae & (u_abs < absorb_p)
    do_vae = do_vae & ~absorbed
    u4, sampler = sampler.next_nd(4)
    z0, z1 = gaussian_from_uniform(u4[:, 0], u4[:, 1])
    z2, z3 = gaussian_from_uniform(u4[:, 2], u4[:, 3])
    out_local = vae.decode_outpos(feat, torch.stack([z0, z1, z2, z3], -1))
    # the offset lives in the frame of in_dir_adj, in epsilon units
    offset = out_local[:, 0:1] * s_ax + out_local[:, 1:2] * t_ax \
        + out_local[:, 2:3] * in_dir_adj
    sampled_p = si.p + offset / f_scale[:, None]

    # 4) projection onto the surface along the polynomial's gradient: rays
    # bounded by 2 eps both ways, then unbounded ones where neither hit
    vtx = scene.vertices[vid]
    gdir = m.normalize(eval_poly_grad(coeffs_ws,
                                      (sampled_p - vtx) * f_scale[:, None]))
    maxd = 2.0 * k_eps

    def both_ways(maxt):
        i1 = ray_intersect(scene, Ray(o=sampled_p, d=gdir, maxt=maxt))
        i2 = ray_intersect(scene, Ray(o=sampled_p, d=-gdir,
                                      maxt=torch.where(i1.valid, i1.t, maxt)))
        use2 = (i2.valid & (~i1.valid | (i2.t < i1.t)))[:, None]
        return (i1.valid | i2.valid,
                torch.where(use2, i2.p, i1.p),
                torch.where(use2, i2.sh_frame.n, i1.sh_frame.n))

    proj_ok, exit_p, exit_n = both_ways(maxd)
    ok_b, exit_pb, exit_nb = both_ways(torch.full_like(maxd, INF))
    exit_p = torch.where(proj_ok[:, None], exit_p, exit_pb)
    exit_n = torch.where(proj_ok[:, None], exit_n, exit_nb)
    do_vae = do_vae & (proj_ok | ok_b)

    # 5) exit through a cosine lobe and S_w, NEE at the exit point
    onehot = torch.nn.functional.one_hot(channel, 3).to(torch.float32)
    weight = onehot * 3.0 * (eta * eta)[:, None]
    u2d, sampler = sampler.next_2d()
    wo_local = square_to_cosine_hemisphere(u2d)
    cos_o = wo_local[:, 2]
    fr_s, fr_t = onb_duff(exit_n)
    out_d = wo_local[:, 0:1] * fr_s + wo_local[:, 1:2] * fr_t \
        + wo_local[:, 2:3] * exit_n
    pdf_cos = torch.clamp(cos_o, min=1e-6) / math.pi
    # the continuing path's factor: weight * S_w * cos / pdf
    cont_w = weight * (sw_factor(cos_o, eta) * math.pi)[:, None]

    u2e, sampler = sampler.next_2d()
    u1e, sampler = sampler.next_1d()
    ds, em_w = sample_emitter_direction(scene, exit_p, u2e, u1e)
    cos_e = torch.sum(ds.d * exit_n, -1)
    nee_ok = do_vae & (ds.pdf > 0) & (cos_e > 0)
    epsn = (1.0 + torch.amax(torch.abs(exit_p), -1)) * 1e-4
    occ = ray_test(scene, Ray(o=exit_p + ds.d * epsn[:, None], d=ds.d,
                              maxt=ds.dist * (1 - 1e-3) - epsn))
    nee_ok = nee_ok & ~occ
    bsdf_val = cos_e / math.pi
    mis_e = m.mis_weight(ds.pdf, torch.where(ds.delta, 0.0, bsdf_val))
    L_nee = torch.where(
        nee_ok[:, None],
        weight * em_w * (bsdf_val * math.pi * sw_factor(cos_e, eta)
                         * mis_e)[:, None], 0.0)

    pt = passthrough[:, None]
    out_p = torch.where(pt, zits.p + refr_d * eps0[:, None], exit_p)
    out_d = torch.where(pt, refr_d, out_d)
    return SSEvent(
        alive=(passthrough | do_vae) & ~dead & ~absorbed,
        passthrough=passthrough, out_p=out_p, out_d=out_d, out_n=exit_n,
        weight=torch.where(pt, 1.0, cont_w),
        pdf=torch.where(passthrough, 1.0, pdf_cos),
        L_nee=torch.where(do_vae[:, None], L_nee, 0.0),
        absorbed=absorbed, absorb_p=absorb_p), sampler
