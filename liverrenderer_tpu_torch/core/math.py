"""Batched vector math (counterpart of liverrenderer_tpu/core/math.py),
cut to what the liver slice calls."""
from __future__ import annotations

import torch

from .ieee_sqrt import sqrt  # noqa: F401  (m.sqrt for the port's callers)
from .types import Frame


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def norm(v):
    return sqrt(torch.sum(v * v, dim=-1))


def normalize(v, eps=1e-20):
    n2 = torch.sum(v * v, dim=-1)
    return v / sqrt(torch.clamp(n2, min=eps * eps))[..., None]


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


class _SafeSqrt(torch.autograd.Function):
    """sqrt(max(x, 0)) whose derivative is clamped to 0 at x <= 1e-12, as
    the JAX package's custom JVP: the masked-select dispatch feeds exact
    zeros here for lanes of another BSDF family (fresnel_conductor with
    eta_im = 0), and the infinite derivative times a zero cotangent would
    NaN every reverse pass through the family."""

    @staticmethod
    def forward(x):
        return sqrt(torch.clamp(x, min=0.0))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)
        ctx.save_for_forward(inputs[0], output)

    @staticmethod
    def _dydx(x, y):
        return torch.where(x > 1e-12, 0.5 / torch.clamp(y, min=1e-12), 0.0)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * _SafeSqrt._dydx(x, y)

    @staticmethod
    def jvp(ctx, dx):
        x, y = ctx.saved_tensors
        return _SafeSqrt._dydx(x, y) * dx


def safe_sqrt(x):
    return _SafeSqrt.apply(x)


def safe_acos(x):
    return torch.arccos(torch.clamp(x, -1.0, 1.0))


def mis_weight(pdf_a, pdf_b):
    """Power heuristic (beta=2).  Detached: MIS weights are sampling-density
    ratios, excluded from differentiation."""
    a2 = pdf_a * pdf_a
    w = a2 / torch.clamp(a2 + pdf_b * pdf_b, min=1e-38)
    return torch.where(torch.isfinite(w), w, 0.0).detach()


def table_lookup(table, idx):
    """Per-lane row lookup from a small parameter table (media, BSDF rows)
    -> idx.shape + table.shape[1:].

    Tables of up to 8 rows become a broadcast or a select chain, as in the
    JAX package: the values are the gather's, but the backward is one
    reduction over the lanes per row.  The backward of a gather
    (index_put_ with accumulation) serialises the lanes that share a row,
    and every lane of a wavefront shares one of a few rows: on the card it
    took ~30 ms per lookup of 65,536 lanes (chip_smoke.py
    render_grad_trace; PERF.md)."""
    R = table.shape[0]
    out_shape = idx.shape + table.shape[1:]
    if R == 1:
        return torch.broadcast_to(table[0], out_shape)
    if R <= 8:
        sel = idx.view(idx.shape + (1,) * (table.dim() - 1))
        out = torch.broadcast_to(table[0], out_shape)
        for r in range(1, R):
            out = torch.where(sel == r, table[r], out)
        return out
    return table[idx]


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
