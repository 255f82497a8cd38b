"""Batched vector math (counterpart of liverrenderer_tpu/core/math.py),
cut to what the primal liver slice calls.

The JAX package's `table_lookup` select chains exist because per-lane
gathers are slow on a TPU; on a GPU the port indexes tables directly
(identical values).
"""
from __future__ import annotations

import torch

from .types import Frame


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def normalize(v, eps=1e-20):
    n2 = torch.sum(v * v, dim=-1)
    return v / torch.sqrt(torch.clamp(n2, min=eps * eps))[..., None]


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def safe_acos(x):
    return torch.arccos(torch.clamp(x, -1.0, 1.0))


def mis_weight(pdf_a, pdf_b):
    """Power heuristic (beta=2)."""
    a2 = pdf_a * pdf_a
    w = a2 / torch.clamp(a2 + pdf_b * pdf_b, min=1e-38)
    return torch.where(torch.isfinite(w), w, 0.0)


def coordinate_system(n):
    """Duff et al. branchless orthonormal basis around n."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], -1)
    t = torch.stack([b, sign + ny * ny * a, -ny], -1)
    return s, t


def make_frame(n) -> Frame:
    s, t = coordinate_system(n)
    return Frame(s=s, t=t, n=n)


def cos_theta(v):
    return v[..., 2]


def reflect(wi):
    """Local-frame mirror reflection of wi (pointing away)."""
    return torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], -1)


def refract_local(wi, cos_theta_t, eta_ti):
    return torch.stack([
        -eta_ti * wi[..., 0],
        -eta_ti * wi[..., 1],
        cos_theta_t,
    ], -1)
