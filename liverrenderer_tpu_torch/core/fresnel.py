"""Fresnel equations (counterpart of liverrenderer_tpu/core/fresnel.py),
cut to the smooth dielectric."""
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
