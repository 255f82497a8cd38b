"""Sampling warps (counterpart of liverrenderer_tpu/core/warp.py), cut to
the phase functions of the liver slice."""
from __future__ import annotations

import math

import torch

from . import math as m

PI = math.pi
INV_FOURPI = 1.0 / (4.0 * math.pi)


def square_to_uniform_sphere(u):
    z = 1.0 - 2.0 * u[..., 1]
    r = m.safe_sqrt(1.0 - z * z)
    phi = 2.0 * PI * u[..., 0]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def square_to_hg(u, g):
    """Henyey-Greenstein direction around +z (exact inverse CDF)."""
    g = torch.broadcast_to(g, u.shape[:-1])
    tiny = torch.abs(g) < 1e-3
    g_safe = torch.where(tiny, 0.5, g)
    sqr_term = (1.0 - g_safe * g_safe) \
        / (1.0 - g_safe + 2.0 * g_safe * u[..., 1])
    ct_hg = (1.0 + g_safe * g_safe - sqr_term * sqr_term) / (2.0 * g_safe)
    # isotropic limit with the first-order correction
    ct_iso = 1.0 - 2.0 * u[..., 1] + 2 * g * u[..., 1] * (1.0 - u[..., 1]) * 2
    cos_theta = torch.where(tiny, torch.clamp(ct_iso, -1.0, 1.0),
                            torch.clamp(ct_hg, -1.0, 1.0))
    st = m.safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = 2.0 * PI * u[..., 0]
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), cos_theta],
                       -1)


def hg_pdf(cos_theta, g):
    temp = 1.0 + g * g - 2.0 * g * cos_theta
    return INV_FOURPI * (1.0 - g * g) / torch.clamp(
        temp * m.safe_sqrt(temp), min=1e-20)
