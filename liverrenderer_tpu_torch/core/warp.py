"""Sampling warps (counterpart of liverrenderer_tpu/core/warp.py), cut to
the phase functions, the diffuse BSDF and the emitter sampling the port
carries."""
from __future__ import annotations

import math

import torch

from . import math as m

PI = math.pi
INV_PI = 1.0 / math.pi
INV_FOURPI = 1.0 / (4.0 * math.pi)


def square_to_uniform_disk_concentric(u):
    """Shirley-Chiu concentric disk mapping."""
    x = 2.0 * u[..., 0] - 1.0
    y = 2.0 * u[..., 1] - 1.0
    is_zero = (x == 0.0) & (y == 0.0)
    quad_x = torch.abs(x) > torch.abs(y)
    r = torch.where(quad_x, x, y)
    ratio = torch.where(quad_x,
                        y / torch.where(x == 0, 1.0, x),
                        x / torch.where(y == 0, 1.0, y))
    phi = torch.where(quad_x, ratio * (PI / 4.0),
                      (PI / 2.0) - ratio * (PI / 4.0))
    phi = torch.where(is_zero, 0.0, phi)
    r = torch.where(is_zero, 0.0, r)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], -1)


def square_to_cosine_hemisphere(u):
    p = square_to_uniform_disk_concentric(u)
    z = m.safe_sqrt(1.0 - p[..., 0] ** 2 - p[..., 1] ** 2)
    # z is kept above 0 so the pdf stays positive on the equator
    z = torch.clamp(z, min=1e-7)
    return torch.stack([p[..., 0], p[..., 1], z], -1)


def square_to_cosine_hemisphere_pdf(v):
    return torch.clamp(v[..., 2], min=0.0) * INV_PI


def square_to_uniform_triangle(u):
    """Barycentric warp -> (b1, b2)."""
    t = m.safe_sqrt(1.0 - u[..., 0])
    return torch.stack([1.0 - t, t * u[..., 1]], -1)


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
