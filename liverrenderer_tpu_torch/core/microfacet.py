"""GGX microfacet distribution: anisotropic NDF, Smith shadowing and
visible-normal sampling (counterpart of
liverrenderer_tpu/core/microfacet.py)."""
from __future__ import annotations

import math

import torch

from . import math as m


def ggx_d(h, ax, ay):
    """Anisotropic GGX NDF; h in the local frame."""
    hx, hy, hz = h[..., 0], h[..., 1], h[..., 2]
    val = hx * hx / (ax * ax) + hy * hy / (ay * ay) + hz * hz
    d = 1.0 / torch.clamp(math.pi * ax * ay * val * val, min=1e-20)
    return torch.where(hz > 0, d, 0.0)


def ggx_smith_g1(v, h, ax, ay):
    xy_alpha2 = (ax * v[..., 0]) ** 2 + (ay * v[..., 1]) ** 2
    tan2 = xy_alpha2 / torch.clamp(v[..., 2] ** 2, min=1e-20)
    g = 2.0 / (1.0 + m.sqrt(1.0 + tan2))
    # v and h must lie in the same hemisphere with respect to n
    same = (torch.sum(v * h, -1) * v[..., 2]) > 0
    return torch.where(same, g, 0.0)


def ggx_sample_vndf(wi, u, ax, ay):
    """Sample a visible normal around wi (wi.z > 0), Heitz 2018."""
    v = m.normalize(torch.stack([ax * wi[..., 0], ay * wi[..., 1],
                                 wi[..., 2]], -1))
    lensq = v[..., 0] ** 2 + v[..., 1] ** 2
    t1 = torch.where(
        (lensq > 1e-12)[..., None],
        torch.stack([-v[..., 1], v[..., 0], torch.zeros_like(lensq)], -1)
        / m.sqrt(torch.clamp(lensq, min=1e-12))[..., None],
        v.new_tensor([1.0, 0.0, 0.0]))
    t2 = m.cross(v, t1)
    r = m.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + v[..., 2])
    p2 = (1.0 - s) * m.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    p3 = m.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * v
    return m.normalize(torch.stack([ax * nh[..., 0], ay * nh[..., 1],
                                    torch.clamp(nh[..., 2], min=1e-6)], -1))


def ggx_pdf_visible(wi, h, ax, ay):
    """Density of ggx_sample_vndf over half-vectors."""
    g1 = ggx_smith_g1(wi, h, ax, ay)
    d = ggx_d(h, ax, ay)
    return g1 * torch.abs(torch.sum(wi * h, -1)) * d \
        / torch.clamp(torch.abs(wi[..., 2]), min=1e-8)
