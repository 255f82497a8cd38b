"""Hair fiber BSDF, the Chiang et al. 2016 rough-dielectric fiber model
(reference src/bsdfs/hair.cpp; counterpart of liverrenderer_tpu/bsdf/hair.py,
the same float32 operations in the same order).

Local frame: +x is the fiber tangent (the curve tubes' shading frames take
s = the fiber direction, accel/intersect.compute_si), +z the outward
radial normal.  The azimuthal chord offset h of a ray hitting a circular
fiber comes from the view direction itself: sin(gamma_o) = wi_y / |wi_yz|.
The lobes R, TT, TRT and the residual are evaluated on every lane.

Row params: p[0] = eta, p[1] = beta_m, p[2] = beta_n, p[3] = alpha
(radians); sigma_a (rgb absorption per unit fiber diameter) comes from
tex0.  Integer powers multiply by squaring in the order the JAX
package's `x ** n` lowers to, so both packages round alike.
"""
from __future__ import annotations

import math

import torch

from ..core import fresnel as fr
from ..core import math as m
from ..scene.ir import F_GLOSSY_REFL, F_GLOSSY_TRANS

P_MAX = 3
_SQRT_PI_OVER_8 = 0.626657069


def _ipow(x, n: int):
    """x ** n for an integer n > 0, by squaring (lax.integer_pow's
    order of multiplications)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _safe_sqrt(x):
    return m.sqrt(torch.clamp(x, min=0.0))


def _i0(x):
    """Modified Bessel I0, 10-term series (accurate for the v >= 0.1
    branch)."""
    out = torch.ones_like(x)
    term = torch.ones_like(x)
    x2 = x * x
    for i in range(1, 10):
        term = term * x2 / (4.0 * i * i)
        out = out + term
    return out


def _log_i0(x):
    big = x > 12.0
    small = torch.log(_i0(torch.clamp(x, max=12.0)))
    xb = torch.clamp(x, min=12.0)
    large = xb + 0.5 * (-math.log(2.0 * math.pi) - torch.log(xb)
                        + 1.0 / (8.0 * xb))
    return torch.where(big, large, small)


def _mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """Longitudinal scattering lobe."""
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    small_v = v <= 0.1
    mp_small = torch.exp(_log_i0(a) - b - 1.0 / v + 0.6931
                         + torch.log(1.0 / (2.0 * v)))
    v_big = torch.clamp(v, min=0.1)
    mp_big = torch.exp(-b) * _i0(a) / (torch.sinh(1.0 / v_big) * 2.0 * v_big)
    return torch.where(small_v, mp_small, mp_big)


def _logistic(x, s):
    x = torch.abs(x)
    e = torch.exp(-x / s)
    return e / (s * _ipow(1.0 + e, 2))


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + torch.exp(-x / s))


def _trimmed_logistic(x, s, a, b):
    return _logistic(x, s) / (_logistic_cdf(b, s) - _logistic_cdf(a, s))


def _sample_trimmed_logistic(u, s, a, b):
    k = _logistic_cdf(b, s) - _logistic_cdf(a, s)
    x = -s * torch.log(1.0 / torch.clamp(u * k + _logistic_cdf(a, s),
                                         1e-9, 1.0 - 1e-9) - 1.0)
    return torch.clamp(x, a, b)


def _phi_fn(p, gamma_o, gamma_t):
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * math.pi


def _wrap_pi(x):
    """Wrap an angle to [-pi, pi]."""
    return torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi


def _derived(p_row):
    """Per-lane constants from (eta, beta_m, beta_n, alpha)."""
    eta = p_row[..., 0]
    beta_m = p_row[..., 1]
    beta_n = p_row[..., 2]
    alpha = p_row[..., 3]
    v0 = _ipow(0.726 * beta_m + 0.812 * _ipow(beta_m, 2)
               + 3.7 * _ipow(beta_m, 20), 2)
    v = [v0, 0.25 * v0, 4.0 * v0, 4.0 * v0]
    s = _SQRT_PI_OVER_8 * (0.265 * beta_n + 1.194 * _ipow(beta_n, 2)
                           + 5.372 * _ipow(beta_n, 22))
    sin2k = [torch.sin(alpha)]
    cos2k = [_safe_sqrt(1.0 - _ipow(sin2k[0], 2))]
    for i in range(1, 3):
        sin2k.append(2.0 * cos2k[i - 1] * sin2k[i - 1])
        cos2k.append(_ipow(cos2k[i - 1], 2) - _ipow(sin2k[i - 1], 2))
    return eta, v, s, sin2k, cos2k


def _angles(w):
    """(sin_theta, cos_theta, phi) of a local direction; theta from the
    normal plane toward the +x fiber tangent."""
    sin_t = torch.clamp(w[..., 0], -1.0, 1.0)
    cos_t = _safe_sqrt(1.0 - sin_t * sin_t)
    phi = torch.atan2(w[..., 2], w[..., 1])
    return sin_t, cos_t, phi


def _geometry(wi, p_row, sigma_a):
    """Everything that depends only on the camera-side direction wi."""
    eta, v, s, sin2k, cos2k = _derived(p_row)
    sin_to, cos_to, phi_o = _angles(wi)
    az = _safe_sqrt(_ipow(wi[..., 1], 2) + _ipow(wi[..., 2], 2))
    h = torch.where(az > 1e-7, wi[..., 1] / torch.clamp(az, min=1e-7), 0.0)
    h = torch.clamp(h, -1.0, 1.0)
    gamma_o = torch.asin(h)

    # the refracted cone
    sin_tt = sin_to / eta
    cos_tt = _safe_sqrt(1.0 - _ipow(sin_tt, 2))
    etap = _safe_sqrt(_ipow(eta, 2) - _ipow(sin_to, 2)) \
        / torch.clamp(cos_to, min=1e-7)
    sin_gt = torch.clamp(h / torch.clamp(etap, min=1e-7), -1.0, 1.0)
    cos_gt = _safe_sqrt(1.0 - _ipow(sin_gt, 2))
    gamma_t = torch.asin(sin_gt)

    # single-pass transmittance through the fiber interior
    tr = torch.exp(-sigma_a * (2.0 * cos_gt
                               / torch.clamp(cos_tt, min=1e-7))[..., None])

    # lobe attenuations ap[0..P_MAX]
    cos_go = _safe_sqrt(1.0 - h * h)
    f, _, _, _ = fr.fresnel_dielectric(cos_to * cos_go, eta)
    f3 = f[..., None]
    ap = [torch.broadcast_to(f3, tr.shape), _ipow(1.0 - f3, 2) * tr]
    for _ in range(2, P_MAX):
        ap.append(ap[-1] * tr * f3)
    ap.append(ap[P_MAX - 1] * f3 * tr
              / torch.clamp(1.0 - tr * f3, min=1e-6))
    return dict(eta=eta, v=v, s=s, sin2k=sin2k, cos2k=cos2k,
                sin_to=sin_to, cos_to=cos_to, phi_o=phi_o,
                gamma_o=gamma_o, gamma_t=gamma_t, ap=ap)


def _tilted(g, p):
    """Scale-tilt-adjusted (sin, |cos|) of theta_o for lobe p."""
    sin_to, cos_to = g["sin_to"], g["cos_to"]
    s2k, c2k = g["sin2k"], g["cos2k"]
    if p == 0:
        st = sin_to * c2k[1] - cos_to * s2k[1]
        ct = cos_to * c2k[1] + sin_to * s2k[1]
    elif p == 1:
        st = sin_to * c2k[0] + cos_to * s2k[0]
        ct = cos_to * c2k[0] - sin_to * s2k[0]
    elif p == 2:
        st = sin_to * c2k[2] + cos_to * s2k[2]
        ct = cos_to * c2k[2] - sin_to * s2k[2]
    else:
        st, ct = sin_to, cos_to
    return st, torch.abs(ct)


def _ap_pdf(g):
    lum = [0.212671 * a[..., 0] + 0.715160 * a[..., 1]
           + 0.072169 * a[..., 2] for a in g["ap"]]
    tot = lum[0] + lum[1] + lum[2] + lum[3]
    return [x / torch.clamp(tot, min=1e-9) for x in lum]


def hair_eval_pdf(wi, wo, p_row, sigma_a):
    """(value, solid-angle pdf).  The Chiang model is defined in the curve
    measure with the cosine folded in, so the value is used as it is."""
    g = _geometry(wi, p_row, sigma_a)
    sin_ti, cos_ti, phi_i = _angles(wo)
    phi = phi_i - g["phi_o"]
    ap_pdf = _ap_pdf(g)

    val = wi.new_zeros(wi.shape[:-1] + (3,))
    pdf = wi.new_zeros(wi.shape[:-1])
    for p in range(P_MAX):
        st, ct = _tilted(g, p)
        mp = _mp(cos_ti, ct, sin_ti, st, g["v"][p])
        np_ = _trimmed_logistic(
            _wrap_pi(phi - _phi_fn(p, g["gamma_o"], g["gamma_t"])),
            g["s"], -math.pi, math.pi)
        val = val + mp[..., None] * g["ap"][p] * np_[..., None]
        pdf = pdf + mp * ap_pdf[p] * np_
    mp = _mp(cos_ti, g["cos_to"], sin_ti, g["sin_to"], g["v"][P_MAX])
    inv2pi = 1.0 / (2.0 * math.pi)
    val = val + mp[..., None] * g["ap"][P_MAX] * inv2pi
    pdf = pdf + mp * ap_pdf[P_MAX] * inv2pi
    ok = torch.isfinite(pdf) & torch.isfinite(val).all(-1)
    return torch.where(ok[..., None], val, 0.0), torch.where(ok, pdf, 0.0)


def hair_sample(wi, u1, u2, p_row, sigma_a):
    """Importance-sample the fiber model: u1 picks the lobe (its remainder
    drives the longitudinal sample), u2 (cos_theta, phi).  Returns (wo,
    pdf, weight, eta = 1, sampled type)."""
    g = _geometry(wi, p_row, sigma_a)
    ap_pdf = _ap_pdf(g)

    # the lobe by attenuation luminance, and the remainder remapped
    cdf0 = ap_pdf[0]
    cdf1 = cdf0 + ap_pdf[1]
    cdf2 = cdf1 + ap_pdf[2]
    p_sel = (u1 >= cdf0).to(torch.int64) + (u1 >= cdf1) + (u1 >= cdf2)
    lo = torch.where(p_sel == 0, 0.0,
                     torch.where(p_sel == 1, cdf0,
                                 torch.where(p_sel == 2, cdf1, cdf2)))
    width = torch.where(p_sel == 0, ap_pdf[0],
                        torch.where(p_sel == 1, ap_pdf[1],
                                    torch.where(p_sel == 2, ap_pdf[2],
                                                ap_pdf[3])))
    u_rem = torch.clamp((u1 - lo) / torch.clamp(width, min=1e-9), 1e-5, 1.0)

    # the longitudinal sample in the selected lobe's tilted cone
    st_p = ct_p = v_p = None
    for p in range(P_MAX, -1, -1):
        st, ct = _tilted(g, p)
        sel = p_sel == p
        if st_p is None:
            # jnp.select's default (0) never shows: p_sel is in 0..3
            st_p, ct_p, v_p = st, ct, g["v"][p]
        else:
            st_p = torch.where(sel, st, st_p)
            ct_p = torch.where(sel, ct, ct_p)
            v_p = torch.where(sel, g["v"][p], v_p)

    cos_theta = 1.0 + v_p * torch.log(torch.clamp(
        u_rem + (1.0 - u_rem) * torch.exp(-2.0 / v_p), min=1e-20))
    sin_theta = _safe_sqrt(1.0 - _ipow(cos_theta, 2))
    cos_phi_l = torch.cos(2.0 * math.pi * u2[..., 0])
    sin_ti = -cos_theta * st_p + sin_theta * cos_phi_l * ct_p
    cos_ti = _safe_sqrt(1.0 - _ipow(sin_ti, 2))

    # the azimuthal sample
    dphi_lob = _phi_fn(p_sel.to(torch.float32), g["gamma_o"], g["gamma_t"]) \
        + _sample_trimmed_logistic(u2[..., 1], g["s"], -math.pi, math.pi)
    dphi_res = 2.0 * math.pi * u2[..., 1]
    dphi = torch.where(p_sel == P_MAX, dphi_res, dphi_lob)
    phi_i = g["phi_o"] + dphi

    wo = torch.stack([sin_ti, cos_ti * torch.cos(phi_i),
                      cos_ti * torch.sin(phi_i)], -1)
    val, pdf = hair_eval_pdf(wi, wo, p_row, sigma_a)
    weight = torch.where((pdf > 1e-12)[..., None],
                         val / torch.clamp(pdf, min=1e-12)[..., None], 0.0)
    flags = torch.full(pdf.shape, F_GLOSSY_REFL | F_GLOSSY_TRANS,
                       dtype=torch.int64, device=pdf.device)
    return wo, pdf, weight, torch.ones_like(pdf), flags
