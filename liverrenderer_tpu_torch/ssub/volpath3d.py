"""The ground-truth subsurface random walk the VAE was trained against (the
reference's Volpath3D particle tracer; counterpart of
liverrenderer_tpu/ssub/volpath3d.py), kept as the validation oracle.

N walkers advance in lockstep: a free flight, a test against the implicit
degree-3 surface by fixed-count marching and one secant step, then an
internal Fresnel reflection or a refracted exit at the surface, or an HG
scatter or absorption inside.  The loop runs on the host until every
walker has ended or max_bounces.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import math as cm
from ..core.fresnel import fresnel_dielectric
from ..phase.dispatch import phase_sample
from ..scene.ir import PHASE_HG
from .poly import eval_poly, eval_poly_grad, onb_duff

Tensor = torch.Tensor

_MARCH_STEPS = 24


@dataclass
class WalkResult:
    out_p: Tensor       # (N, 3) exit position (on the polynomial surface)
    out_d: Tensor       # (N, 3) exit direction
    absorbed: Tensor    # (N,) bool
    exited: Tensor      # (N,) bool
    n_bounces: Tensor   # (N,) scatter events


def _poly_crossing(coeffs, p0, d, t_max):
    """First t in (0, t_max] with f(p0 + t d) >= 0 (inside is f < 0):
    fixed-count marching and one secant step."""
    n = p0.shape[0]
    dt = t_max / _MARCH_STEPS
    t_hit = p0.new_full((n,), float("inf"))
    found = torch.zeros((n,), dtype=torch.bool, device=p0.device)
    f_prev = eval_poly(coeffs, p0)
    for i in range(_MARCH_STEPS):
        t = float(i + 1) * dt
        f = eval_poly(coeffs, p0 + t[:, None] * d)
        cross = (f >= 0.0) & ~found
        denom = torch.where(torch.abs(f - f_prev) > 1e-12, f - f_prev, 1.0)
        t_ref = t - dt + dt * torch.clamp(-f_prev / denom, 0.0, 1.0)
        t_hit = torch.where(cross, t_ref, t_hit)
        f_prev, found = f, cross | found
    return t_hit, found


def sample_paths(coeffs, entry_p, entry_d, sigma_t, albedo, g, sampler,
                 max_bounces: int = 256, eta: float = 1.0):
    """Random-walk N packets through the homogeneous medium inside the
    implicit surface f(x) = 0 (inside f < 0).

    coeffs (20,) or (N, 20); entry_p / entry_d (N, 3), entry_d pointing
    inside; sigma_t, albedo, g, eta floats.  With eta != 1 a walker at the
    surface reflects back inside with probability F(cos, eta) and else
    exits refracted.  Walkers alive at the cap count as absorbed.
    Returns (WalkResult, sampler)."""
    n = entry_p.shape[0]
    dev = entry_p.device
    if coeffs.dim() == 1:
        coeffs = coeffs.expand(n, -1)
    # float32 scalars, as the JAX package computes them
    sigma_t = float(np.float32(sigma_t))
    march_span = float(np.float32(12.0) / np.float32(sigma_t))  # ~12 mfp
    p, d = entry_p, entry_d
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    absorbed = torch.zeros_like(alive)
    exited = torch.zeros_like(alive)
    out_p, out_d = entry_p, entry_d
    bounces = torch.zeros((n,), dtype=torch.int64, device=dev)
    ptype = torch.full((n,), PHASE_HG, dtype=torch.int64, device=dev)
    gl = entry_p.new_full((n,), float(g))
    for _ in range(max_bounces):
        if not bool(alive.any()):
            break
        u1, sampler = sampler.next_1d()
        u2, sampler = sampler.next_2d()
        ua, sampler = sampler.next_1d()
        uf, sampler = sampler.next_1d()
        # free flight, and a surface crossing before the collision
        t_free = -torch.log(torch.clamp(1.0 - u1, min=1e-9)) / sigma_t
        flight = torch.clamp(t_free, max=march_span)
        t_surf, found = _poly_crossing(coeffs, p, d, flight)
        reaches = alive & found & (t_surf <= t_free)
        p_hit = p + t_surf[:, None] * d
        # internal Fresnel at the boundary: outward normal grad f, local
        # frame (b1, b2, n_out), wi pointing back inside
        n_out = eval_poly_grad(coeffs, p_hit)
        n_out = n_out / torch.clamp(torch.linalg.norm(n_out, dim=-1,
                                                      keepdim=True),
                                    min=1e-12)
        b1, b2 = onb_duff(n_out)
        wi_l = torch.stack([torch.sum(-d * b1, -1), torch.sum(-d * b2, -1),
                            torch.sum(-d * n_out, -1)], -1)
        F, ctt, _, eta_ti = fresnel_dielectric(
            wi_l[..., 2], torch.tensor(eta, dtype=torch.float32, device=dev))
        re_enter = reaches & (uf < F)
        exits = reaches & ~re_enter

        def to_world(v):
            return v[..., 0:1] * b1 + v[..., 1:2] * b2 + v[..., 2:3] * n_out

        d_refl = to_world(cm.reflect(wi_l))
        d_refr = to_world(cm.refract_local(wi_l, ctt, eta_ti))
        out_p = torch.where(exits[:, None], p_hit, out_p)
        out_d = torch.where(exits[:, None], d_refr, out_d)
        # re-entering walkers restart just inside the boundary
        p_re = p_hit - n_out * (1e-3 / sigma_t)
        # a collision: absorb, or scatter by HG
        collides = alive & ~reaches
        absorb = collides & (ua >= albedo)
        p_new = p + flight[:, None] * d
        d_new = phase_sample(ptype, gl, d, u2)[0]
        alive = (collides & ~absorb) | re_enter
        p = torch.where(re_enter[:, None], p_re,
                        torch.where(collides[:, None], p_new, p))
        d = torch.where(re_enter[:, None], d_refl,
                        torch.where((collides & ~absorb)[:, None], d_new, d))
        absorbed = absorbed | absorb
        exited = exited | exits
        bounces = bounces + collides.to(torch.int64)
    return WalkResult(out_p=out_p, out_d=out_d, absorbed=absorbed | alive,
                      exited=exited, n_bounces=bounces), sampler


def flat_halfspace_coeffs():
    """f(x) = z: the z < 0 half space (the canonical training geometry)."""
    c = torch.zeros(20)
    c[3] = 1.0
    return c
