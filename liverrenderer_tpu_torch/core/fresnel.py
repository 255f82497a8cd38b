"""Fresnel equations (counterpart of liverrenderer_tpu/core/fresnel.py)
for smooth dielectrics and conductors."""
from __future__ import annotations

import torch

from . import math as m


def fresnel_dielectric(cos_theta_i, eta):
    """Unpolarized Fresnel reflectance at a dielectric interface.

    Returns (F, cos_theta_t, eta_it, eta_ti); eta is interior/exterior and
    cos_theta_t carries the sign of the transmitted hemisphere."""
    eta = torch.broadcast_to(eta, cos_theta_i.shape)
    outside = cos_theta_i >= 0.0
    eta_it = torch.where(outside, eta, 1.0 / eta)
    eta_ti = torch.where(outside, 1.0 / eta, eta)

    cti = torch.abs(cos_theta_i)
    ctt2 = 1.0 - (1.0 - cti * cti) * eta_ti * eta_ti
    tir = ctt2 <= 0.0
    ctt = m.safe_sqrt(ctt2)

    rs = (cti - eta_it * ctt) / torch.clamp(cti + eta_it * ctt, min=1e-20)
    rp = (eta_it * cti - ctt) / torch.clamp(eta_it * cti + ctt, min=1e-20)
    F = 0.5 * (rs * rs + rp * rp)
    F = torch.where(tir, 1.0, F)
    F = torch.where(eta == 1.0, 0.0, F)

    cos_theta_t = torch.where(tir, 0.0, ctt) \
        * torch.where(cos_theta_i >= 0, -1.0, 1.0)
    return F, cos_theta_t, eta_it, eta_ti


def fresnel_conductor(cos_theta_i, eta_re, eta_im):
    """Fresnel reflectance of a conductor with complex IOR eta_re + i
    eta_im; per channel when eta is (..., 3)."""
    ct2 = cos_theta_i * cos_theta_i
    st2 = torch.clamp(1.0 - ct2, min=0.0)
    if eta_re.dim() > cos_theta_i.dim():
        ct2 = ct2[..., None]
        st2 = st2[..., None]
        cti = torch.abs(cos_theta_i)[..., None]
    else:
        cti = torch.abs(cos_theta_i)
    e2 = eta_re * eta_re - eta_im * eta_im - st2
    a2b2 = m.safe_sqrt(e2 * e2 + 4.0 * eta_re * eta_re * eta_im * eta_im)
    t1 = a2b2 + ct2
    a = m.safe_sqrt(0.5 * (a2b2 + e2))
    t2 = 2.0 * a * cti
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-20)
    t3 = ct2 * a2b2 + st2 * st2
    t4 = t2 * st2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-20)
    return 0.5 * (rp + rs)


def fresnel_diffuse_reflectance(eta):
    """Polynomial fit of the diffuse Fresnel reflectance F_dr(eta)."""
    eta = torch.as_tensor(eta, dtype=torch.float32)
    inv_eta = 1.0 / eta
    ie2 = inv_eta * inv_eta
    ie3 = ie2 * inv_eta
    approx_hi = (-1.4399 * ie2 + 0.7099 * inv_eta + 0.6681 + 0.0636 * eta)
    return torch.where(eta < 1.0,
                       -0.4399 + 0.7099 * inv_eta - 0.3319 * ie2
                       + 0.0636 * ie3,
                       approx_hi)
