"""BSDF sampling and evaluation over the wavefront (counterpart of
liverrenderer_tpu/bsdf/dispatch.py) for the stock families: diffuse,
smooth, thin and rough dielectric, smooth and rough conductor, smooth,
rough and polarized plastic (its unpolarized projection), null, the
polarizer, retarder and circular elements (their unpolarized
projection: integrators/stokes.py applies their Mueller matrices), the
principled and principledthin models, the measured (RGL) material, and
the one-level blendbsdf and mask wrappers.  Every family present in the scene
is evaluated on all lanes and combined with masked selects.

Conventions: directions in the local shading frame, wi points away from
the surface, `eval` returns f(wi, wo) * |cos_theta_o| (zero for delta
lobes), `sample` returns weight = f * |cos| / pdf and the discrete lobe
probability as the pdf of a delta lobe; twosided flips the frame when
cos_theta(wi) < 0.  Per-lane rows (type, twosided, texture slots, nested
BSDFs, params) are read with core/math.table_lookup, as in the JAX
package, so that a parameter's gradient is one reduction per row.
Texture slots read the interaction's position and vertex attribute (the
volume and mesh-attribute textures), as the JAX package's do.
"""
from __future__ import annotations

import torch

from ..core import fresnel as fr
from ..core import math as m
from ..core import microfacet as mf
from ..core import warp
from ..core.types import BSDFSample
from ..scene.ir import (BSDF_BLEND, BSDF_CIRCULAR, BSDF_CONDUCTOR,
                        BSDF_DIELECTRIC, BSDF_DIFFUSE, BSDF_HAIR, BSDF_MASK,
                        BSDF_MEASURED, BSDF_NULL, BSDF_PLASTIC,
                        BSDF_POLARIZER, BSDF_PPLASTIC, BSDF_PRINCIPLED,
                        BSDF_PRINCIPLEDTHIN,
                        BSDF_RETARDER, BSDF_ROUGHCONDUCTOR,
                        BSDF_ROUGHDIELECTRIC, BSDF_ROUGHPLASTIC,
                        BSDF_THINDIELECTRIC, F_DELTA_REFL, F_DELTA_TRANS,
                        F_DIFFUSE_REFL, F_GLOSSY_REFL, F_GLOSSY_TRANS,
                        F_NULL, Scene)
from ..texture.eval import eval_texture
from .hair import hair_eval_pdf, hair_sample
from .measured import measured_eval_pdf, measured_sample


def _flip_z(v):
    return torch.stack([v[..., 0], v[..., 1], -v[..., 2]], -1)


def _sanitize_dir(v):
    """Replace non-finite / degenerate direction rows with +z: masked-off
    lanes carry garbage interactions, whose NaNs would poison reverse mode
    through the masked selects."""
    ok = torch.isfinite(v).all(-1) & (torch.sum(v * v, -1) > 0.25)
    return torch.where(ok[..., None],
                       torch.where(torch.isfinite(v), v, 0.0),
                       v.new_tensor([0.0, 0.0, 1.0]))


def _full(like, val):
    return torch.full(like.shape, val, dtype=torch.int64, device=like.device)


def _alphas(p):
    return torch.clamp(p[..., 6], min=1e-4), torch.clamp(p[..., 7], min=1e-4)


def _reflect_h(wi, h):
    return 2.0 * torch.sum(wi * h, -1)[..., None] * h - wi


# ---------------------------------------------------------------------------
# Per-family implementations: local wi in, lane-shaped results out; the
# caller masks by family membership.
# ---------------------------------------------------------------------------

def _diffuse_sample(wi, u1, u2, p, t0, t1):
    wo = warp.square_to_cosine_hemisphere(u2)
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    active = m.cos_theta(wi) > 0
    weight = torch.where(active[..., None], t0, 0.0)
    pdf = torch.where(active, pdf, 0.0)
    return wo, pdf, weight, wi.new_ones(pdf.shape), _full(pdf, F_DIFFUSE_REFL)


def _diffuse_eval(wi, wo, p, t0, t1):
    ci = m.cos_theta(wi)
    co = m.cos_theta(wo)
    act = (ci > 0) & (co > 0)
    val = t0 * (warp.INV_PI * co)[..., None]
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    return torch.where(act[..., None], val, 0.0), torch.where(act, pdf, 0.0)


def _dielectric_sample(wi, u1, u2, p, t0, t1):
    """Smooth dielectric (src/bsdfs/dielectric.cpp)."""
    eta = p[..., 0]
    ci = m.cos_theta(wi)
    F, ctt, eta_it, eta_ti = fr.fresnel_dielectric(ci, eta)
    refl = u1 <= F
    wo = torch.where(refl[..., None], m.reflect(wi),
                     m.refract_local(wi, ctt, eta_ti))
    pdf = torch.where(refl, F, 1.0 - F)
    # radiance scale on refraction (solid-angle compression)
    weight = torch.where(refl[..., None], t0,
                         t1 * (eta_ti * eta_ti)[..., None])
    eta_s = torch.where(refl, 1.0, eta_it)
    st = torch.where(refl, F_DELTA_REFL, F_DELTA_TRANS)
    return wo, pdf, weight, eta_s, st


def _thindielectric_sample(wi, u1, u2, p, t0, t1):
    eta = p[..., 0]
    ci = m.cos_theta(wi)
    F, _, _, _ = fr.fresnel_dielectric(torch.abs(ci), eta)
    # internal bounces: R' = F + (1 - F)^2 F / (1 - F^2)
    R = torch.where(F < 1.0, F + (1.0 - F) * (1.0 - F) * F
                    / torch.clamp(1.0 - F * F, min=1e-6), 1.0)
    refl = u1 <= R
    wo = torch.where(refl[..., None], m.reflect(wi), -wi)
    pdf = torch.where(refl, R, 1.0 - R)
    weight = torch.where(refl[..., None], t0, t1)
    st = torch.where(refl, F_DELTA_REFL, F_NULL)
    return wo, pdf, weight, wi.new_ones(pdf.shape), st


def _conductor_sample(wi, u1, u2, p, t0, t1):
    ci = m.cos_theta(wi)
    F = fr.fresnel_conductor(ci, p[..., 0:3], p[..., 3:6])
    wo = m.reflect(wi)
    act = ci > 0
    pdf = torch.where(act, 1.0, 0.0)
    weight = torch.where(act[..., None], t0 * F, 0.0)
    return wo, pdf, weight, wi.new_ones(pdf.shape), _full(pdf, F_DELTA_REFL)


def _roughconductor_sample(wi, u1, u2, p, t0, t1):
    ax, ay = _alphas(p)
    ci = m.cos_theta(wi)
    h = mf.ggx_sample_vndf(wi, u2, ax, ay)
    wo = _reflect_h(wi, h)
    co = m.cos_theta(wo)
    act = (ci > 0) & (co > 0)
    pdf_h = mf.ggx_pdf_visible(wi, h, ax, ay)
    pdf = pdf_h / torch.clamp(4.0 * torch.abs(torch.sum(wo * h, -1)),
                              min=1e-8)
    F = fr.fresnel_conductor(torch.sum(wi * h, -1), p[..., 0:3], p[..., 3:6])
    g2 = mf.ggx_smith_g1(wi, h, ax, ay) * mf.ggx_smith_g1(wo, h, ax, ay)
    g1 = mf.ggx_smith_g1(wi, h, ax, ay)
    weight = t0 * F * (g2 / torch.clamp(g1, min=1e-8))[..., None]
    pdf = torch.where(act, pdf, 0.0)
    weight = torch.where(act[..., None], weight, 0.0)
    return wo, pdf, weight, wi.new_ones(pdf.shape), _full(pdf, F_GLOSSY_REFL)


def _roughconductor_eval(wi, wo, p, t0, t1):
    ax, ay = _alphas(p)
    ci = m.cos_theta(wi)
    co = m.cos_theta(wo)
    act = (ci > 0) & (co > 0)
    # inactive lanes get +z so the normalize cannot emit a reverse-mode NaN
    # under the masked select
    h = m.normalize(torch.where(act[..., None], wi + wo,
                                wi.new_tensor([0.0, 0.0, 1.0])))
    d = mf.ggx_d(h, ax, ay)
    g = mf.ggx_smith_g1(wi, h, ax, ay) * mf.ggx_smith_g1(wo, h, ax, ay)
    F = fr.fresnel_conductor(torch.sum(wi * h, -1), p[..., 0:3], p[..., 3:6])
    f_cos = t0 * F * (d * g / torch.clamp(4.0 * ci, min=1e-8))[..., None]
    pdf = mf.ggx_pdf_visible(wi, h, ax, ay) \
        / torch.clamp(4.0 * torch.abs(torch.sum(wo * h, -1)), min=1e-8)
    return torch.where(act[..., None], f_cos, 0.0), torch.where(act, pdf, 0.0)


def _plastic_diffuse(p, t0):
    """The internally scattered diffuse albedo, (N, 3)."""
    nonlinear = p[..., 1] > 0.5
    fdr_int = p[..., 2]
    denom = torch.where(nonlinear[..., None], 1.0 - t0 * fdr_int[..., None],
                        1.0 - fdr_int[..., None])
    return t0 / torch.clamp(denom, min=1e-6)


def _plastic_sample(wi, u1, u2, p, t0, t1):
    """Smooth plastic (src/bsdfs/plastic.cpp): delta specular + internally
    scattered diffuse."""
    eta = p[..., 0]
    spec_weight = p[..., 4]
    ci = m.cos_theta(wi)
    Fi, _, _, _ = fr.fresnel_dielectric(ci, eta)
    prob_spec = Fi * spec_weight / torch.clamp(
        Fi * spec_weight + (1.0 - Fi) * (1.0 - spec_weight), min=1e-8)
    pick_spec = u1 < prob_spec
    wo = torch.where(pick_spec[..., None], m.reflect(wi),
                     warp.square_to_cosine_hemisphere(u2))
    Fo, _, _, _ = fr.fresnel_dielectric(m.cos_theta(wo), eta)
    inv_eta2 = 1.0 / torch.clamp(eta * eta, min=1e-8)
    diff_val = _plastic_diffuse(p, t0) \
        * ((1.0 - Fi) * (1.0 - Fo) * inv_eta2)[..., None]
    w_spec = torch.where(pick_spec, Fi / torch.clamp(prob_spec, min=1e-8),
                         0.0)
    pdf_diff = warp.square_to_cosine_hemisphere_pdf(wo) * (1.0 - prob_spec)
    w_diff = diff_val / torch.clamp(1.0 - prob_spec, min=1e-8)[..., None]
    act = ci > 0
    weight = torch.where(pick_spec[..., None], w_spec[..., None], w_diff)
    pdf = torch.where(pick_spec, prob_spec, pdf_diff)
    weight = torch.where(act[..., None], weight, 0.0)
    pdf = torch.where(act, pdf, 0.0)
    st = torch.where(pick_spec, F_DELTA_REFL, F_DIFFUSE_REFL)
    return wo, pdf, weight, wi.new_ones(pdf.shape), st


def _plastic_eval(wi, wo, p, t0, t1):
    eta = p[..., 0]
    spec_weight = p[..., 4]
    ci = m.cos_theta(wi)
    co = m.cos_theta(wo)
    act = (ci > 0) & (co > 0)
    Fi, _, _, _ = fr.fresnel_dielectric(ci, eta)
    Fo, _, _, _ = fr.fresnel_dielectric(co, eta)
    inv_eta2 = 1.0 / torch.clamp(eta * eta, min=1e-8)
    val = _plastic_diffuse(p, t0) \
        * ((1.0 - Fi) * (1.0 - Fo) * inv_eta2 * warp.INV_PI * co)[..., None]
    prob_spec = Fi * spec_weight / torch.clamp(
        Fi * spec_weight + (1.0 - Fi) * (1.0 - spec_weight), min=1e-8)
    pdf = warp.square_to_cosine_hemisphere_pdf(wo) * (1.0 - prob_spec)
    return torch.where(act[..., None], val, 0.0), torch.where(act, pdf, 0.0)


def _microfacet_spec(wi, wo, h, eta, ax, ay):
    """(F D G / (4 cos_i), the specular lobe's pdf of wo) on a dielectric
    interface."""
    d = mf.ggx_d(h, ax, ay)
    g = mf.ggx_smith_g1(wi, h, ax, ay) * mf.ggx_smith_g1(wo, h, ax, ay)
    F, _, _, _ = fr.fresnel_dielectric(torch.sum(wi * h, -1), eta)
    spec = F * d * g / torch.clamp(4.0 * m.cos_theta(wi), min=1e-8)
    pdf = mf.ggx_pdf_visible(wi, h, ax, ay) \
        / torch.clamp(4.0 * torch.abs(torch.sum(wo * h, -1)), min=1e-8)
    return spec, pdf


def _roughplastic_eval(wi, wo, p, t0, t1):
    """Rough plastic (src/bsdfs/roughplastic.cpp): GGX specular on the
    dielectric interface + internally scattered diffuse, with the smooth
    interface's transmittance in place of the reference's tables."""
    eta = p[..., 0]
    ssw = p[..., 4]
    ax, ay = _alphas(p)
    ci = m.cos_theta(wi)
    co = m.cos_theta(wo)
    Fi, _, _, _ = fr.fresnel_dielectric(ci, eta)
    t_i = 1.0 - Fi
    prob_spec = (1.0 - t_i) * ssw
    prob_diff = t_i * (1.0 - ssw)
    prob_spec = prob_spec / torch.clamp(prob_spec + prob_diff, min=1e-8)
    act = (ci > 0) & (co > 0)
    h = m.normalize(wi + wo)
    spec, pdf_spec = _microfacet_spec(wi, wo, h, eta, ax, ay)
    Fo, _, _, _ = fr.fresnel_dielectric(co, eta)
    t_o = 1.0 - Fo
    inv_eta2 = 1.0 / torch.clamp(eta * eta, min=1e-8)
    diff_v = _plastic_diffuse(p, t0) \
        * (warp.INV_PI * inv_eta2 * co * t_i * t_o)[..., None]
    val = torch.where(act[..., None], spec[..., None] + diff_v, 0.0)
    pdf = prob_spec * pdf_spec \
        + (1.0 - prob_spec) * warp.square_to_cosine_hemisphere_pdf(wo)
    return val, torch.where(act, pdf, 0.0)


def _pplastic_eval(wi, wo, p, t0, t1):
    """Polarized plastic, unpolarized projection (src/bsdfs/pplastic.cpp):
    GGX specular + Lambert diffuse attenuated by both Fresnel
    transmittances; the lobe is picked by the static sampling weight."""
    eta = p[..., 0]
    ssw = p[..., 4]
    ax, ay = _alphas(p)
    ci = m.cos_theta(wi)
    co = m.cos_theta(wo)
    act = (ci > 0) & (co > 0)
    h = m.normalize(wi + wo)
    spec, pdf_spec = _microfacet_spec(wi, wo, h, eta, ax, ay)
    Fi, _, _, _ = fr.fresnel_dielectric(ci, eta)
    Fo, _, _, _ = fr.fresnel_dielectric(co, eta)
    diff = t0 * ((1.0 - Fi) * (1.0 - Fo) * warp.INV_PI * co)[..., None]
    val = torch.where(act[..., None], spec[..., None] + diff, 0.0)
    pdf = ssw * pdf_spec \
        + (1.0 - ssw) * warp.square_to_cosine_hemisphere_pdf(wo)
    return val, torch.where(act, pdf, 0.0)


def _two_lobe_sample(evalf, prob_spec):
    """Sampler of a GGX-specular + cosine-diffuse BSDF whose specular lobe
    is picked with probability prob_spec(wi, p)."""
    def sample(wi, u1, u2, p, t0, t1):
        ax, ay = _alphas(p)
        ci = m.cos_theta(wi)
        take_spec = u1 < prob_spec(wi, p)
        h = mf.ggx_sample_vndf(wi, u2, ax, ay)
        wo = torch.where(take_spec[..., None], _reflect_h(wi, h),
                         warp.square_to_cosine_hemisphere(u2))
        val, pdf = evalf(wi, wo, p, t0, t1)
        act = (ci > 0) & (m.cos_theta(wo) > 0) & (pdf > 0)
        weight = torch.where(act[..., None],
                             val / torch.clamp(pdf, min=1e-12)[..., None],
                             0.0)
        st = torch.where(take_spec, F_GLOSSY_REFL, F_DIFFUSE_REFL)
        return wo, torch.where(act, pdf, 0.0), weight, \
            wi.new_ones(pdf.shape), st
    return sample


def _roughplastic_prob_spec(wi, p):
    Fi, _, _, _ = fr.fresnel_dielectric(m.cos_theta(wi), p[..., 0])
    t_i = 1.0 - Fi
    ps = (1.0 - t_i) * p[..., 4]
    pd = t_i * (1.0 - p[..., 4])
    return ps / torch.clamp(ps + pd, min=1e-8)


_roughplastic_sample = _two_lobe_sample(_roughplastic_eval,
                                        _roughplastic_prob_spec)
_pplastic_sample = _two_lobe_sample(_pplastic_eval, lambda wi, p: p[..., 4])


def _roughdielectric_eval(wi, wo, p, t0, t1):
    """Rough dielectric (src/bsdfs/roughdielectric.cpp, Walter et al.
    2007): reflection and transmission lobes both evaluate, so NEE and MIS
    through rough glass stay unbiased."""
    eta = p[..., 0]
    ax, ay = _alphas(p)
    ci = m.cos_theta(wi)
    co = m.cos_theta(wo)
    refl = ci * co > 0
    eta_rel = torch.where(ci > 0, eta, 1.0 / torch.clamp(eta, min=1e-8))
    h_r = m.normalize(wi + wo)
    h_t = m.normalize(wi + wo * eta_rel[..., None])
    h = torch.where(refl[..., None], h_r, h_t)
    h = h * torch.sign(m.cos_theta(h))[..., None]
    cos_ih = torch.sum(wi * h, -1)
    cos_oh = torch.sum(wo * h, -1)
    F, _, eta_it, eta_ti = fr.fresnel_dielectric(cos_ih, eta)
    # D and G in the upper-hemisphere frame of the incident side
    flip = ci < 0
    wi_f = torch.where(flip[..., None], _flip_z(wi), wi)
    wo_f = torch.where((co < 0)[..., None], _flip_z(wo), wo)
    h_f = torch.where(flip[..., None], _flip_z(h), h)
    d = mf.ggx_d(h_f, ax, ay)
    g = mf.ggx_smith_g1(wi_f, h_f, ax, ay) * mf.ggx_smith_g1(wo_f, h_f,
                                                             ax, ay)
    pdf_h = mf.ggx_pdf_visible(wi_f, h_f, ax, ay)

    # reflection: f cos = F D G / (4 |ci|)
    val_r = t0 * (F * d * g / torch.clamp(4.0 * torch.abs(ci),
                                          min=1e-8))[..., None]
    pdf_r = pdf_h * F / torch.clamp(4.0 * torch.abs(cos_oh), min=1e-8)
    ok_r = refl & (cos_ih * ci > 0) & (cos_oh * co > 0)

    # transmission (Walter eq. 21) times |co| and the eta_ti^2 radiance
    # compression of the smooth dielectric
    denom = cos_ih + eta_rel * cos_oh
    denom2 = torch.clamp(denom * denom, min=1e-12)
    jac_t = (eta_rel * eta_rel) * torch.abs(cos_oh) / denom2
    val_t_s = torch.abs(cos_ih * cos_oh) / torch.clamp(
        torch.abs(ci * co), min=1e-8) \
        * (eta_rel * eta_rel) * (1.0 - F) * d * g / denom2 \
        * torch.abs(co) * (eta_ti * eta_ti)
    val_t = t1 * val_t_s[..., None]
    pdf_t = pdf_h * (1.0 - F) * jac_t
    ok_t = (~refl) & (cos_ih * ci > 0) & (cos_oh * co > 0)

    val = torch.where(ok_r[..., None], val_r,
                      torch.where(ok_t[..., None], val_t, 0.0))
    pdf = torch.where(ok_r, pdf_r, torch.where(ok_t, pdf_t, 0.0))
    return val, pdf


def _roughdielectric_sample(wi, u1, u2, p, t0, t1):
    eta = p[..., 0]
    ax, ay = _alphas(p)
    ci = m.cos_theta(wi)
    flip = ci < 0
    wi_f = torch.where(flip[..., None], _flip_z(wi), wi)
    h = mf.ggx_sample_vndf(wi_f, u2, ax, ay)
    h = torch.where(flip[..., None], _flip_z(h), h)
    cos_ih = torch.sum(wi * h, -1)
    F, ctt, eta_it, eta_ti = fr.fresnel_dielectric(cos_ih, eta)
    refl = u1 <= F
    wo_r = 2.0 * cos_ih[..., None] * h - wi
    wo_t = m.normalize(
        -eta_ti[..., None] * (wi - cos_ih[..., None] * h)
        + ctt[..., None] * h * torch.sign(cos_ih)[..., None])
    wo = torch.where(refl[..., None], wo_r, wo_t)
    co = m.cos_theta(wo)
    act = torch.where(refl, ci * co > 0, ci * co < 0)
    h_f = torch.where(flip[..., None], _flip_z(h), h)
    pdf_h = mf.ggx_pdf_visible(torch.where(flip[..., None], _flip_z(wi), wi),
                               h_f, ax, ay)
    cos_oh = torch.sum(wo * h, -1)
    dwh_dwo_r = 1.0 / torch.clamp(4.0 * torch.abs(cos_oh), min=1e-8)
    # transmission Jacobian (Walter et al. eq. 17) with eta_it
    sqrt_denom = cos_ih + eta_it * cos_oh
    dwh_dwo_t = (eta_it * eta_it) * torch.abs(cos_oh) \
        / torch.clamp(sqrt_denom * sqrt_denom, min=1e-12)
    pdf = pdf_h * torch.where(refl, F * dwh_dwo_r, (1.0 - F) * dwh_dwo_t)
    g1 = mf.ggx_smith_g1(wi_f, h_f, ax, ay)
    g2 = g1 * mf.ggx_smith_g1(
        torch.where((co < 0)[..., None], _flip_z(wo), wo), h_f, ax, ay)
    wgt = g2 / torch.clamp(g1, min=1e-8)
    weight = torch.where(refl[..., None], t0 * wgt[..., None],
                         t1 * (wgt * eta_ti * eta_ti)[..., None])
    pdf = torch.where(act, pdf, 0.0)
    weight = torch.where(act[..., None], weight, 0.0)
    eta_s = torch.where(refl, 1.0, eta_it)
    st = torch.where(refl, F_GLOSSY_REFL, F_GLOSSY_TRANS)
    return wo, pdf, weight, eta_s, st


# ---------------------------------------------------------------------------
# principledthin (principledthin.cpp core lobes): GGX specular reflection
# and thin transmission plus diffuse reflection and translucency.  Row: p0
# eta, p1 roughness, p2 spec_trans, p3 diff_trans (halved at build); tex0
# base_color.
# ---------------------------------------------------------------------------

def _principledthin_probs(p):
    """Lobe selection probabilities (unit sampling rates)."""
    st_ = p[..., 2]
    dt = p[..., 3]
    p_sr = st_ * 0.5
    p_st = st_ * 0.5
    p_dr = (1.0 - st_) * (1.0 - dt)
    p_dt = (1.0 - st_) * dt
    tot = torch.clamp(p_sr + p_st + p_dr + p_dt, min=1e-8)
    return p_sr / tot, p_st / tot, p_dr / tot, p_dt / tot


def _principledthin_alphas(p):
    eta = torch.clamp(p[..., 0], min=1.01)
    rough = torch.clamp(p[..., 1], 0.03, 1.0)
    alpha = rough * rough
    # the Disney thin-surface transmission roughness remap
    rt = torch.clamp((0.65 * eta - 0.35) * rough, 0.03, 1.0)
    return eta, alpha, rt * rt


def _principledthin_eval(wi, wo, p, t0, t1):
    eta, alpha, alpha_t = _principledthin_alphas(p)
    st_ = p[..., 2]
    dt = p[..., 3]
    ci = m.cos_theta(wi)
    co = m.cos_theta(wo)
    p_sr, p_st, p_dr, p_dt = _principledthin_probs(p)
    up = co > 0
    act = ci > 0

    # reflection side: GGX specular + Lambert diffuse
    h = m.normalize(wi + wo)
    d_r = mf.ggx_d(h, alpha, alpha)
    g_r = mf.ggx_smith_g1(wi, h, alpha, alpha) \
        * mf.ggx_smith_g1(wo, h, alpha, alpha)
    F_r, _, _, _ = fr.fresnel_dielectric(torch.sum(wi * h, -1), eta)
    spec_r = st_ * F_r * d_r * g_r / torch.clamp(4.0 * ci, min=1e-8)
    diff_r = t0 * ((1.0 - st_) * (1.0 - dt) * warp.INV_PI
                   * torch.clamp(co, min=0.0))[..., None]
    pdf_h_r = mf.ggx_pdf_visible(wi, h, alpha, alpha)
    pdf_sr = pdf_h_r / torch.clamp(4.0 * torch.abs(torch.sum(wo * h, -1)),
                                   min=1e-8)
    pdf_refl = p_sr * pdf_sr \
        + p_dr * warp.square_to_cosine_hemisphere_pdf(wo)

    # transmission side: thin microfacet transmission (the reflection of
    # the flipped direction) + diffuse Lambert transmission
    wo_f = _flip_z(wo)
    h_t = m.normalize(wi + wo_f)
    d_t = mf.ggx_d(h_t, alpha_t, alpha_t)
    g_t = mf.ggx_smith_g1(wi, h_t, alpha_t, alpha_t) \
        * mf.ggx_smith_g1(wo_f, h_t, alpha_t, alpha_t)
    F_t, _, _, _ = fr.fresnel_dielectric(torch.sum(wi * h_t, -1), eta)
    spec_t = m.sqrt(torch.clamp(t0, min=0.0)) \
        * (st_ * (1.0 - F_t) * d_t * g_t
           / torch.clamp(4.0 * ci, min=1e-8))[..., None]
    diff_t = t0 * ((1.0 - st_) * dt * warp.INV_PI
                   * torch.clamp(-co, min=0.0))[..., None]
    pdf_h_t = mf.ggx_pdf_visible(wi, h_t, alpha_t, alpha_t)
    pdf_st = pdf_h_t / torch.clamp(
        4.0 * torch.abs(torch.sum(wo_f * h_t, -1)), min=1e-8)
    pdf_trans = p_st * pdf_st \
        + p_dt * warp.square_to_cosine_hemisphere_pdf(wo_f)

    val = torch.where(up[..., None], spec_r[..., None] + diff_r,
                      spec_t + diff_t)
    pdf = torch.where(up, pdf_refl, pdf_trans)
    return torch.where(act[..., None], val, 0.0), torch.where(act, pdf, 0.0)


def _principledthin_sample(wi, u1, u2, p, t0, t1):
    eta, alpha, alpha_t = _principledthin_alphas(p)
    ci = m.cos_theta(wi)
    p_sr, p_st, p_dr, p_dt = _principledthin_probs(p)
    c1 = p_sr
    c2 = c1 + p_st
    c3 = c2 + p_dr
    take_sr = u1 < c1
    take_st = (u1 >= c1) & (u1 < c2)
    take_dr = (u1 >= c2) & (u1 < c3)

    h_r = mf.ggx_sample_vndf(wi, u2, alpha, alpha)
    wo_sr = _reflect_h(wi, h_r)
    h_t = mf.ggx_sample_vndf(wi, u2, alpha_t, alpha_t)
    wo_st = _flip_z(_reflect_h(wi, h_t))
    wo_cos = warp.square_to_cosine_hemisphere(u2)
    wo = torch.where(take_sr[..., None], wo_sr,
                     torch.where(take_st[..., None], wo_st,
                                 torch.where(take_dr[..., None], wo_cos,
                                             _flip_z(wo_cos))))
    val, pdf = _principledthin_eval(wi, wo, p, t0, t1)
    # a sample that leaked to the other hemisphere than its lobe's has no
    # density in that side's eval pdf: reject it
    want_up = take_sr | take_dr
    act = (ci > 0) & (pdf > 0) & ((m.cos_theta(wo) > 0) == want_up)
    weight = torch.where(act[..., None],
                         val / torch.clamp(pdf, min=1e-12)[..., None], 0.0)
    st = torch.where(take_sr, F_GLOSSY_REFL,
                     torch.where(take_st, F_GLOSSY_TRANS,
                                 torch.where(take_dr, F_DIFFUSE_REFL,
                                             F_GLOSSY_TRANS)))
    return wo, torch.where(act, pdf, 0.0), weight, wi.new_ones(pdf.shape), \
        st


# ---------------------------------------------------------------------------
# principled (principled.cpp, the full Disney model): metallic blend,
# dielectric / Schlick fresnel with spec_tint, microfacet specular
# transmission, GTR1 clearcoat, sheen with sheen_tint, retro-reflection and
# the Hanrahan-Krueger fake subsurface (flatness).  Row: p0 metallic, p1
# roughness, p2 eta, p3 clearcoat, p4 clearcoat_gloss, p5 anisotropic, p6
# sheen, p7 sheen_tint, p8 spec_trans, p9 flatness, p10 spec_tint; tex0
# base_color.
# ---------------------------------------------------------------------------

def _schlick_w(cos_t):
    """(1 - cos)^5 (principledhelpers.h schlick_weight)."""
    w = torch.clamp(1.0 - cos_t, 0.0, 1.0)
    return (w * w) * (w * w) * w


def _calc_schlick(r0, cos_i, eta):
    """Schlick fresnel on the transmitted angle when the relative IOR
    along the ray is below 1 (principledhelpers.h calc_schlick)."""
    outside = cos_i >= 0.0
    eta_it = torch.where(outside, eta, 1.0 / eta)
    eta_ti = torch.where(outside, 1.0 / eta, eta)
    ctt = m.safe_sqrt(1.0 - (1.0 - cos_i * cos_i) * eta_ti * eta_ti)
    w = torch.where(eta_it > 1.0, _schlick_w(torch.abs(cos_i)),
                    _schlick_w(ctt))
    if r0.ndim == w.ndim:                       # a scalar R0
        return r0 + (1.0 - r0) * w
    return r0 + (1.0 - r0) * w[..., None]


def _gtr1_d(wh, a):
    """GTR1 NDF of the clearcoat (principledhelpers.h GTR1Isotropic)."""
    cz = m.cos_theta(wh)
    a2 = a * a
    d = (a2 - 1.0) / (torch.pi * torch.log(a2)
                      * (1.0 + (a2 - 1.0) * cz * cz))
    return torch.where(d * cz > 1e-20, d, 0.0)


def _gtr1_sample(u, a):
    a2 = a * a
    phi = 2.0 * torch.pi * u[..., 0]
    ct2 = (1.0 - torch.pow(a2, 1.0 - u[..., 1])) / (1.0 - a2)
    st = m.sqrt(torch.clamp(1.0 - ct2, min=0.0))
    ct = m.sqrt(torch.clamp(ct2, min=0.0))
    return torch.stack([torch.cos(phi) * st, torch.sin(phi) * st, ct], -1)


def _smith_ggx1(v, wh, alpha):
    """Separable Smith G1 at the clearcoat's fixed alpha
    (principledhelpers.h smith_ggx1)."""
    a2 = alpha * alpha
    cz = torch.abs(m.cos_theta(v))
    cz2 = torch.clamp(cz * cz, min=1e-12)
    tan2 = (1.0 - cz2) / cz2
    g = 2.0 / (1.0 + m.sqrt(1.0 + a2 * tan2))
    g = torch.where(m.cos_theta(v) == 1.0, 1.0, g)
    return torch.where(torch.sum(v * wh, -1) * m.cos_theta(v) <= 0.0, 0.0, g)


def _principled_fetch(p):
    metallic = p[..., 0]
    rough = torch.clamp(p[..., 1], 0.0, 1.0)
    eta = torch.clamp(p[..., 2], min=1.0009)
    r2 = rough * rough
    aspect = m.sqrt(1.0 - 0.9 * p[..., 5])
    ax = torch.clamp(r2 / aspect, min=1e-3)
    ay = torch.clamp(r2 * aspect, min=1e-3)
    return (metallic, rough, eta, p[..., 3], p[..., 4], ax, ay, p[..., 6],
            p[..., 7], p[..., 8], p[..., 9], p[..., 10])


def _principled_probs(front, bsdfw, brdf, cc, F_die):
    """Lobe selection probabilities (unit sampling rates)."""
    p_sr = torch.where(front, 1.0 - bsdfw * (1.0 - F_die), F_die)
    p_st = torch.where(front, bsdfw * (1.0 - F_die), 1.0 - F_die)
    p_cc = torch.where(front, 0.25 * cc, 0.0)
    p_di = torch.where(front, brdf, 0.0)
    tot = torch.clamp(p_sr + p_st + p_cc + p_di, min=1e-12)
    return p_sr / tot, p_st / tot, p_cc / tot, p_di / tot


def _principled_eval(wi, wo, p, t0, t1):
    (metallic, rough, eta, cc, ccg, ax, ay, sheen, sheen_tint, strans,
     flat, stint) = _principled_fetch(p)
    base = t0
    ci = m.cos_theta(wi)
    co = m.cos_theta(wo)
    brdf = (1.0 - metallic) * (1.0 - strans)
    bsdfw = (1.0 - metallic) * strans
    refl = ci * co > 0.0
    refr = ci * co < 0.0
    front = ci > 0.0
    eta_path = torch.where(front, eta, 1.0 / eta)

    wh = m.normalize(wi + wo * torch.where(refl, 1.0, eta_path)[..., None])
    wh = wh * torch.sign(m.cos_theta(wh))[..., None]       # point up
    cos_ih = torch.sum(wi * wh, -1)
    cos_oh = torch.sum(wo * wh, -1)
    F_die, _, _, _ = fr.fresnel_dielectric(cos_ih, eta)

    sgn = torch.sign(ci)
    mm_r = (cos_ih * sgn > 0.0) & (cos_oh * sgn > 0.0)
    mm_t = (cos_ih * sgn > 0.0) & (cos_oh * (-sgn) > 0.0)

    # ggx_smith_g1 and ggx_pdf_visible are even in v with an orientation
    # mask, so wi and wo pass unflipped
    D = mf.ggx_d(wh, ax, ay)
    G = mf.ggx_smith_g1(wi, wh, ax, ay) * mf.ggx_smith_g1(wo, wh, ax, ay)

    # main specular reflection (the blended principled fresnel)
    lum = 0.212671 * base[..., 0] + 0.715160 * base[..., 1] \
        + 0.072169 * base[..., 2]
    c_tint = torch.where(lum[..., None] > 0.0,
                         base / torch.clamp(lum, min=1e-12)[..., None], 1.0)
    eta_it_m = torch.where(cos_ih >= 0.0, eta, 1.0 / eta)
    f0_tint = c_tint * (((eta_it_m - 1.0) / (eta_it_m + 1.0)) ** 2)[..., None]
    F_schlick = metallic[..., None] * _calc_schlick(base, cos_ih, eta) \
        + ((1.0 - metallic) * stint)[..., None] \
        * _calc_schlick(f0_tint, cos_ih, eta)
    F_front = ((1.0 - metallic) * (1.0 - stint) * F_die)[..., None] \
        + F_schlick
    F_prin = torch.where(front[..., None], F_front,
                         (bsdfw * F_die)[..., None])
    sr_on = refl & mm_r & (F_die > 0.0)
    val = torch.where(sr_on[..., None],
                      F_prin * (D * G / torch.clamp(
                          4.0 * torch.abs(ci), min=1e-8))[..., None], 0.0)

    # specular microfacet transmission (radiance-mode eta scale)
    st_on = refr & mm_t & (bsdfw > 0.0) & (F_die < 1.0)
    denom = cos_ih + eta_path * cos_oh
    tr = bsdfw * torch.abs(
        ((1.0 / torch.clamp(eta_path * eta_path, min=1e-12))
         * (1.0 - F_die) * D * G * eta_path * eta_path * cos_ih * cos_oh)
        / (ci * torch.clamp(denom * denom, min=1e-12)))
    val = val + torch.where(st_on[..., None],
                            m.sqrt(torch.clamp(base, min=0.0))
                            * tr[..., None], 0.0)

    # clearcoat (GTR1, a fixed 0.04 Schlick, Smith G at alpha 0.25)
    cc_on = refl & mm_r & front & (cc > 0.0)
    a_cc = 0.1 + (0.001 - 0.1) * ccg
    Fcc = _calc_schlick(torch.full_like(ci, 0.04), cos_ih, eta)
    Dcc = _gtr1_d(wh, a_cc)
    Gcc = _smith_ggx1(wi, wh, 0.25) * _smith_ggx1(wo, wh, 0.25)
    val = val + torch.where(cc_on[..., None],
                            (0.25 * cc * Fcc * Dcc * Gcc
                             * torch.abs(co))[..., None], 0.0)

    # diffuse + retro-reflection + fake subsurface + sheen
    di_on = refl & front & (brdf > 0.0)
    Fo = _schlick_w(torch.abs(co))
    Fi = _schlick_w(torch.abs(ci))
    f_diff = (1.0 - 0.5 * Fi) * (1.0 - 0.5 * Fo)
    cos_d = cos_oh
    Rr = 2.0 * rough * cos_d * cos_d
    f_retro = Rr * (Fo + Fi + Fo * Fi * (Rr - 1.0))
    fss90 = 0.5 * Rr
    fss = (1.0 + (fss90 - 1.0) * Fo) * (1.0 + (fss90 - 1.0) * Fi)
    f_ss = 1.25 * (fss * (1.0 / torch.clamp(torch.abs(co) + torch.abs(ci),
                                            min=1e-8) - 0.5) + 0.5)
    f_d = (f_diff + f_retro) * (1.0 - flat) + f_ss * flat
    val = val + torch.where(di_on[..., None],
                            (brdf * torch.abs(co) / torch.pi
                             * f_d)[..., None] * base, 0.0)
    sh_on = refl & front & (sheen > 0.0) & (metallic < 1.0)
    Fd = _schlick_w(torch.abs(cos_d))
    c_sheen = 1.0 + (c_tint - 1.0) * sheen_tint[..., None]
    val = val + torch.where(sh_on[..., None],
                            (sheen * (1.0 - metallic) * Fd
                             * torch.abs(co))[..., None] * c_sheen, 0.0)

    # pdf over the four lobes
    p_sr, p_st, p_cc, p_di = _principled_probs(front, bsdfw, brdf, cc,
                                               F_die)
    pdf_h = mf.ggx_pdf_visible(wi, wh, ax, ay)
    dwh_r = 1.0 / torch.clamp(4.0 * torch.abs(cos_oh), min=1e-8)
    dwh_t = torch.abs((eta_path * eta_path) * cos_oh) \
        / torch.clamp(denom * denom, min=1e-12)
    pdf = torch.where(refl & mm_r, p_sr * pdf_h * dwh_r, 0.0)
    pdf = pdf + torch.where(refl, p_di * torch.clamp(co, min=0.0) / torch.pi,
                            0.0)
    pdf = pdf + torch.where(refr & mm_t, p_st * pdf_h * dwh_t, 0.0)
    pdf_cc_h = torch.clamp(m.cos_theta(wh), min=0.0) * _gtr1_d(wh, a_cc)
    pdf = pdf + torch.where(refl & mm_r, p_cc * pdf_cc_h * dwh_r, 0.0)

    act = (ci != 0.0) & (front | (bsdfw > 0.0))
    return torch.where(act[..., None], val, 0.0), torch.where(act, pdf, 0.0)


def _principled_sample(wi, u1, u2, p, t0, t1):
    (metallic, rough, eta, cc, ccg, ax, ay, sheen, sheen_tint, strans,
     flat, stint) = _principled_fetch(p)
    ci = m.cos_theta(wi)
    brdf = (1.0 - metallic) * (1.0 - strans)
    bsdfw = (1.0 - metallic) * strans
    front = ci > 0.0

    # the main specular micro normal first (upper hemisphere on both
    # sides), its fresnel driving the lobe probabilities; the eval's wh
    # reconstruction lands on exactly this normal
    wi_m = wi * torch.sign(ci)[..., None]
    h_spec = mf.ggx_sample_vndf(wi_m, u2, ax, ay)
    cos_ih = torch.sum(wi * h_spec, -1)
    F_die, ctt, eta_it, eta_ti = fr.fresnel_dielectric(cos_ih, eta)

    p_sr, p_st, p_cc, p_di = _principled_probs(front, bsdfw, brdf, cc,
                                               F_die)
    take_di = u1 < p_di
    take_cc = (~take_di) & (u1 < p_di + p_cc)
    take_st = (~take_di) & (~take_cc) & (u1 < p_di + p_cc + p_st)
    take_sr = (~take_di) & (~take_cc) & (~take_st)

    wo_sr = 2.0 * cos_ih[..., None] * h_spec - wi
    # refraction through the up-oriented micro normal: the fresnel
    # helper's cos_theta_t carries the sign of either side
    wo_st = m.normalize(h_spec * (eta_ti * cos_ih + ctt)[..., None]
                        - eta_ti[..., None] * wi)
    a_cc = 0.1 + (0.001 - 0.1) * ccg
    wo_cc = _reflect_h(wi, _gtr1_sample(u2, a_cc))
    wo_di = warp.square_to_cosine_hemisphere(u2)
    wo = torch.where(take_sr[..., None], wo_sr,
                     torch.where(take_st[..., None], wo_st,
                                 torch.where(take_cc[..., None], wo_cc,
                                             wo_di)))
    co = m.cos_theta(wo)

    val, pdf = _principled_eval(wi, wo, p, t0, t1)
    side_ok = torch.where(take_st, ci * co < 0.0, ci * co > 0.0)
    act = (ci != 0.0) & (front | (bsdfw > 0.0)) & side_ok & (pdf > 1e-12)
    weight = torch.where(act[..., None],
                         val / torch.clamp(pdf, min=1e-12)[..., None], 0.0)
    eta_s = torch.where(take_st & act, eta_it, 1.0)
    st = torch.where(take_di, F_DIFFUSE_REFL,
                     torch.where(take_st, F_GLOSSY_TRANS, F_GLOSSY_REFL))
    return wo, torch.where(act, pdf, 0.0), weight, eta_s, st


def _null_sample(wi, u1, u2, p, t0, t1):
    n = wi.shape[:-1]
    return -wi, wi.new_ones(n), wi.new_ones(n + (3,)), wi.new_ones(n), \
        torch.full(n, F_NULL, dtype=torch.int64, device=wi.device)


def _element(scale):
    """A transmissive polarization element (polarizer.cpp, retarder.cpp,
    circular.cpp): straight through with pdf 1; its unpolarized weight is
    scale * transmittance (the Mueller matrix's M00).  The stokes
    integrator applies the rest of the matrix."""
    def sample(wi, u1, u2, p, t0, t1):
        n = wi.shape[:-1]
        return -wi, wi.new_ones(n), scale * t0, wi.new_ones(n), \
            torch.full(n, F_NULL, dtype=torch.int64, device=wi.device)
    return sample


def _hair_sample(wi, u1, u2, p, t0, t1):
    return hair_sample(wi, u1, u2, p, t0)


def _hair_eval(wi, wo, p, t0, t1):
    return hair_eval_pdf(wi, wo, p, t0)


_SAMPLERS = {
    BSDF_DIFFUSE: _diffuse_sample,
    BSDF_DIELECTRIC: _dielectric_sample,
    BSDF_THINDIELECTRIC: _thindielectric_sample,
    BSDF_CONDUCTOR: _conductor_sample,
    BSDF_ROUGHCONDUCTOR: _roughconductor_sample,
    BSDF_PLASTIC: _plastic_sample,
    BSDF_ROUGHPLASTIC: _roughplastic_sample,
    BSDF_PPLASTIC: _pplastic_sample,
    BSDF_ROUGHDIELECTRIC: _roughdielectric_sample,
    BSDF_PRINCIPLED: _principled_sample,
    BSDF_PRINCIPLEDTHIN: _principledthin_sample,
    BSDF_HAIR: _hair_sample,
    BSDF_NULL: _null_sample,
    BSDF_POLARIZER: _element(0.5),
    BSDF_RETARDER: _element(1.0),
    BSDF_CIRCULAR: _element(0.5),
}

# families with a non-delta lobe; the others evaluate to zero
_EVALS = {
    BSDF_DIFFUSE: _diffuse_eval,
    BSDF_ROUGHCONDUCTOR: _roughconductor_eval,
    BSDF_PLASTIC: _plastic_eval,
    BSDF_ROUGHPLASTIC: _roughplastic_eval,
    BSDF_PPLASTIC: _pplastic_eval,
    BSDF_ROUGHDIELECTRIC: _roughdielectric_eval,
    BSDF_PRINCIPLED: _principled_eval,
    BSDF_PRINCIPLEDTHIN: _principledthin_eval,
    BSDF_HAIR: _hair_eval,
}

# wrappers resolved here before the family dispatch; the measured
# material reads the Scene's own table
_NESTED = (BSDF_BLEND, BSDF_MASK)


def _check_types(b):
    bad = [t for t in b.types_present if t not in _SAMPLERS
           and t not in _NESTED and t != BSDF_MEASURED]
    if bad:
        raise ValueError(f"unknown BSDF type codes {bad}")


def _attr(si):
    """The interpolated vertex attribute; without vertex attributes zeros
    (the JAX SurfaceInteraction's default), so a mesh-attribute texture
    reads black."""
    return si.attr if si.attr is not None else si.uv.new_zeros((1, 3))


def _tex(scene: Scene, si, slot, idx, types):
    """A texture slot's value at the interaction (uv, position and
    vertex attribute)."""
    return eval_texture(scene.textures, m.table_lookup(slot, idx), si.uv,
                        types, p=si.p, attr=_attr(si))


def _gather_ctx(scene: Scene, si, idx):
    """Per-lane (btype, params, tex0 value, tex1 value) rows."""
    b = scene.bsdfs
    t0 = _tex(scene, si, b.tex0, idx, b.tex0_types)
    t1 = _tex(scene, si, b.tex1, idx, b.tex1_types)
    return m.table_lookup(b.btype, idx), m.table_lookup(b.params, idx), t0, t1


def bsdf_albedo(scene: Scene, si, bsdf_idx):
    """Approximate surface albedo, the BSDF's primary reflectance texture
    (the AOV integrator's `albedo`)."""
    return _gather_ctx(scene, si, torch.clamp(bsdf_idx, min=0))[2]


def _family_sample(scene: Scene, wi_f, u1, u2, btype, p, t0, t1):
    """Masked-select sampling over the scene's family set."""
    n = wi_f.shape[:-1]
    wo = torch.broadcast_to(wi_f.new_tensor([0.0, 0.0, 1.0]), wi_f.shape)
    pdf = wi_f.new_zeros(n)
    weight = wi_f.new_zeros(n + (3,))
    eta = wi_f.new_ones(n)
    st = torch.zeros(n, dtype=torch.int64, device=wi_f.device)
    for ftype in scene.bsdfs.types_present:
        if ftype not in _SAMPLERS:
            continue
        fwo, fpdf, fw, feta, fst = _SAMPLERS[ftype](wi_f, u1, u2, p, t0, t1)
        sel = btype == ftype
        wo = torch.where(sel[..., None], fwo, wo)
        pdf = torch.where(sel, fpdf, pdf)
        weight = torch.where(sel[..., None], fw, weight)
        eta = torch.where(sel, feta, eta)
        st = torch.where(sel, fst, st)
    if BSDF_MEASURED in scene.bsdfs.types_present:
        mwo, mpdf, mw = measured_sample(scene.measured, wi_f, u1, u2)
        sel = btype == BSDF_MEASURED
        wo = torch.where(sel[..., None], mwo, wo)
        pdf = torch.where(sel, mpdf, pdf)
        weight = torch.where(sel[..., None], mw * t0, weight)
        st = torch.where(sel, F_GLOSSY_REFL, st)
    return wo, pdf, weight, eta, st


def _family_eval(scene: Scene, wi_f, wo_f, btype, p, t0, t1):
    n = wi_f.shape[:-1]
    val = wi_f.new_zeros(n + (3,))
    pdf = wi_f.new_zeros(n)
    for ftype in scene.bsdfs.types_present:
        if ftype not in _EVALS:
            continue
        fv, fp = _EVALS[ftype](wi_f, wo_f, p, t0, t1)
        sel = btype == ftype
        val = torch.where(sel[..., None], fv, val)
        pdf = torch.where(sel, fp, pdf)
    if BSDF_MEASURED in scene.bsdfs.types_present:
        mv, mp = measured_eval_pdf(scene.measured, wi_f, wo_f)
        sel = btype == BSDF_MEASURED
        val = torch.where(sel[..., None], mv * t0, val)
        pdf = torch.where(sel, mp, pdf)
    return val, pdf


def _scalar_weight(scene: Scene, si, idx):
    """Blend weight / mask opacity: the mean of the outer row's tex0."""
    t0 = _tex(scene, si, scene.bsdfs.tex0, idx, scene.bsdfs.tex0_types)
    return torch.clamp(torch.mean(t0, -1), 1e-4, 1.0 - 1e-4)


def _nested_masks(scene: Scene, btype):
    tp = scene.bsdfs.types_present
    zeros = torch.zeros(btype.shape, dtype=torch.bool, device=btype.device)
    is_blend = (btype == BSDF_BLEND) if BSDF_BLEND in tp else zeros
    is_mask = (btype == BSDF_MASK) if BSDF_MASK in tp else zeros
    return is_blend, is_mask


def _frame_in(scene: Scene, si, idx):
    """(btype, flip, sanitized wi in the flipped frame) of each lane."""
    b = scene.bsdfs
    btype = m.table_lookup(b.btype, idx)
    wi = _sanitize_dir(si.wi)
    flip = m.table_lookup(b.twosided, idx) & (m.cos_theta(wi) < 0)
    return btype, flip, torch.where(flip[..., None], _flip_z(wi), wi)


def bsdf_sample(scene: Scene, si, bsdf_idx, u1, u2) -> BSDFSample:
    """Sample the BSDF at each lane; returns a local-frame wo.

    blendbsdf and mask are resolved one level deep before the family
    dispatch (blendbsdf.cpp, mask.cpp): the lane picks a nested BSDF
    stochastically, rescaling u1 as the reference does, samples it and,
    for a blend, combines it with the other nested lobe's eval and pdf."""
    b = scene.bsdfs
    _check_types(b)
    idx = torch.clamp(bsdf_idx, min=0)
    btype, flip, wi_f = _frame_in(scene, si, idx)

    tp = b.types_present
    has_nest = (BSDF_BLEND in tp) or (BSDF_MASK in tp)
    idx_eff, u1_eff = idx, u1
    if has_nest:
        is_blend, is_mask = _nested_masks(scene, btype)
        wsel = _scalar_weight(scene, si, idx)
        inner = torch.clamp(m.table_lookup(b.inner, idx), min=0)
        inner2 = torch.clamp(m.table_lookup(b.inner2, idx), min=0)
        # blend: u1 <= w -> nested[1]; mask: u1 < opacity -> nested, else
        # null transmission
        pick2 = is_blend & (u1 <= wsel)
        pick1 = is_blend & ~pick2
        mask_nested = is_mask & (u1 < wsel)
        mask_trans = is_mask & ~mask_nested
        u1_eff = torch.where(pick2 | mask_nested, u1 / wsel, u1)
        u1_eff = torch.where(pick1, (u1 - wsel) / (1.0 - wsel), u1_eff)
        idx_eff = torch.where(pick2, inner2,
                              torch.where(pick1 | mask_nested, inner, idx))

    bt_e, p_e, t0_e, t1_e = _gather_ctx(scene, si, idx_eff)
    wo, pdf, weight, eta, st = _family_sample(scene, wi_f, u1_eff, u2,
                                              bt_e, p_e, t0_e, t1_e)

    if has_nest and BSDF_BLEND in tp:
        # the other lobe's eval for the blended pdf and value
        idx_oth = torch.where(pick2, inner, inner2)
        bt_o, p_o, t0_o, t1_o = _gather_ctx(scene, si, idx_oth)
        val_o, pdf_o = _family_eval(scene, wi_f, wo, bt_o, p_o, t0_o, t1_o)
        q_ch = torch.where(pick2, wsel, 1.0 - wsel)
        q_o = 1.0 - q_ch
        pdf_b = q_ch * pdf + q_o * pdf_o
        f_b = q_ch[..., None] * (weight * pdf[..., None]) \
            + q_o[..., None] * val_o
        res_b = torch.where((pdf_b > 0)[..., None],
                            f_b / torch.clamp(pdf_b, min=1e-12)[..., None],
                            0.0)
        pdf = torch.where(is_blend, pdf_b, pdf)
        weight = torch.where(is_blend[..., None], res_b, weight)

    if has_nest and BSDF_MASK in tp:
        det_w = wsel.detach()
        pdf = torch.where(mask_nested, pdf * det_w, pdf)
        weight = torch.where(mask_nested[..., None],
                             weight * (wsel / det_w)[..., None], weight)
        wo = torch.where(mask_trans[..., None], -wi_f, wo)
        pdf = torch.where(mask_trans, 1.0 - det_w, pdf)
        weight = torch.where(
            mask_trans[..., None],
            torch.broadcast_to(((1.0 - wsel) / (1.0 - det_w))[..., None],
                               weight.shape), weight)
        eta = torch.where(mask_trans, 1.0, eta)
        st = torch.where(mask_trans, F_NULL, st)

    wo = torch.where(flip[..., None], _flip_z(wo), wo)
    return BSDFSample(wo=wo, pdf=pdf, eta=eta, sampled_type=st,
                      weight=weight)


def bsdf_eval_pdf(scene: Scene, si, bsdf_idx, wo):
    """(f * |cos_theta_o|, pdf) of each lane's BSDF for a local-frame wo;
    delta lobes evaluate to zero.  blend = (1 - w) nested0 + w nested1,
    mask = opacity * nested."""
    b = scene.bsdfs
    _check_types(b)
    idx = torch.clamp(bsdf_idx, min=0)
    btype, flip, wi_f = _frame_in(scene, si, idx)
    wo = _sanitize_dir(wo)
    wo_f = torch.where(flip[..., None], _flip_z(wo), wo)

    tp = b.types_present
    has_nest = (BSDF_BLEND in tp) or (BSDF_MASK in tp)
    idx_a = idx
    if has_nest:
        is_blend, is_mask = _nested_masks(scene, btype)
        wsel = _scalar_weight(scene, si, idx)
        inner = torch.clamp(m.table_lookup(b.inner, idx), min=0)
        inner2 = torch.clamp(m.table_lookup(b.inner2, idx), min=0)
        idx_a = torch.where(is_blend | is_mask, inner, idx)

    bt_a, p_a, t0_a, t1_a = _gather_ctx(scene, si, idx_a)
    val, pdf = _family_eval(scene, wi_f, wo_f, bt_a, p_a, t0_a, t1_a)

    if has_nest and BSDF_BLEND in tp:
        idx_b2 = torch.where(is_blend, inner2, idx_a)
        bt_b, p_b, t0_b, t1_b = _gather_ctx(scene, si, idx_b2)
        val2, pdf2 = _family_eval(scene, wi_f, wo_f, bt_b, p_b, t0_b, t1_b)
        val = torch.where(is_blend[..., None],
                          (1.0 - wsel)[..., None] * val
                          + wsel[..., None] * val2, val)
        pdf = torch.where(is_blend, (1.0 - wsel) * pdf + wsel * pdf2, pdf)
    if has_nest and BSDF_MASK in tp:
        val = torch.where(is_mask[..., None], val * wsel[..., None], val)
        pdf = torch.where(is_mask, pdf * wsel.detach(), pdf)
    return val, pdf


def eval_null_transmission(scene: Scene, si, bsdf_idx):
    """Transmission of a straight shadow ray through the hit surface: 1 for
    the null BSDF, 1 - opacity for a mask, 0 for the others."""
    _check_types(scene.bsdfs)
    idx = torch.clamp(bsdf_idx, min=0)
    btype = m.table_lookup(scene.bsdfs.btype, idx)
    out = si.uv.new_zeros(si.uv.shape[:-1] + (3,))
    if BSDF_NULL in scene.bsdfs.types_present:
        out = torch.where((btype == BSDF_NULL)[..., None], 1.0, out)
    if BSDF_MASK in scene.bsdfs.types_present:
        op = eval_texture(scene.textures, scene.bsdfs.tex0[idx], si.uv)
        out = torch.where((btype == BSDF_MASK)[..., None], 1.0 - op, out)
    return out
