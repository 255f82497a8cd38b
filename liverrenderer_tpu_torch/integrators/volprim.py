"""Radiance field over volumetric ellipsoid primitives, the
`volprim_rf_basic` integrator (counterpart of
liverrenderer_tpu/integrators/volprim.py; reference
volprim_rf_basic.py).

Each ellipsoid is an instanced icosphere in the triangle buffer, so the
march is the closest-hit query, hit by hit.  A front-facing splat hit
evaluates the 3DGS transmittance (the Gaussian kernel at the ray-space
peak) and the SH directional emission, and the path composites front to
back,

    L += beta (1 - T) emission ;  beta *= T,

until the throughput drops to 0.01 or max_depth splats were crossed.  A
back-facing (exit) hit is a null event (ellipsoids.cpp's backface
culling).  The ray continues 1e-4 along its direction past each hit, not
through spawn_ray, as the reference does.  The parameters live in one
table (`Scene.volprims`) read by the hit's triangle.  mode="ad" runs all
2 max_depth + 2 iterations under activation checkpoints, the hit
sequence detached and transmittance and emission differentiable (the
volprims.opacity and volprims.sh keys).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.utils.checkpoint

from ..accel.intersect import ray_intersect
from ..core import math as m
from ..core.rng import Sampler
from ..core.types import INF, Ray
from ..scene.ir import Scene

Tensor = torch.Tensor


def sh_eval(d: Tensor, degree: int) -> Tensor:
    """Real spherical harmonics at directions d (N, 3) up to `degree` <= 3
    (the convention dr.sh_eval implements) -> (N, (degree + 1)^2)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 1:
        out += [-0.48860251190291987 * y,
                0.48860251190291987 * z,
                -0.48860251190291987 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        out += [1.0925484305920792 * x * y,
                -1.0925484305920792 * y * z,
                0.94617469575756 * zz - 0.31539156525252,
                -1.0925484305920792 * x * z,
                0.5462742152960396 * (xx - yy)]
    if degree >= 3:
        out += [-0.5900435899266435 * y * (3 * xx - yy),
                2.890611442640554 * x * y * z,
                -0.4570457994644658 * y * (5 * zz - 1.0),
                0.3731763325901154 * z * (5 * zz - 3.0),
                -0.4570457994644658 * x * (5 * zz - 1.0),
                1.445305721320277 * z * (xx - yy),
                -0.5900435899266435 * x * (xx - 3 * yy)]
    return torch.stack(out, -1)


def eval_transmission(scene: Scene, ell: Tensor, ray_o: Tensor,
                      ray_d: Tensor) -> Tensor:
    """3DGS transmittance of ellipsoid `ell` along the ray: the Gaussian
    at the ray-space peak, T = 1 - min(opacity exp(-|p|^2 / 2), 0.9999)."""
    vp = scene.volprims
    e = torch.clamp(ell, min=0)
    c = vp.center[e]
    s = torch.clamp(vp.scale[e], min=1e-12)
    R = vp.rot[e]                                    # (N, 3, 3)
    o = torch.einsum("nji,nj->ni", R, ray_o - c) / s  # R^T (o - c) / s
    d = torch.einsum("nji,nj->ni", R, ray_d) / s
    t_peak = -torch.sum(o * d, -1) \
        / torch.clamp(torch.sum(d * d, -1), min=1e-20)
    p = o + d * t_peak[:, None]
    density = torch.exp(-0.5 * torch.sum(p * p, -1))
    return 1.0 - torch.clamp(vp.opacity[e] * density, max=0.9999)


def eval_sh_emission(scene: Scene, ell: Tensor, ray_d: Tensor) -> Tensor:
    """SH directional emission max(sum_k Y_k(d) c_k + 1/2, 0)."""
    vp = scene.volprims
    Y = sh_eval(ray_d, vp.sh_degree)                 # (N, K)
    em = torch.einsum("nk,nkc->nc", Y, vp.sh[torch.clamp(ell, min=0)])
    return torch.clamp(em + 0.5, min=0.0)


def srgb_to_linear(c: Tensor) -> Tensor:
    return torch.where(c <= 0.04045, c / 12.92,
                       ((c + 0.055) / 1.055) ** 2.4)


@dataclass
class VPState:
    active: Tensor   # (N,) bool
    ray_o: Tensor    # (N, 3)
    L: Tensor        # (N, 3)
    beta: Tensor     # (N, 3)
    depth: Tensor    # (N,) splats crossed


def _bounce(scene: Scene, ray_d: Tensor, st: VPState) -> VPState:
    n = st.ray_o.shape[0]
    si = ray_intersect(scene, Ray(o=st.ray_o, d=ray_d,
                                  maxt=st.ray_o.new_full((n,), INF)))
    hit = si.valid & (si.prim >= 0)
    ell = torch.where(hit, scene.volprims.tri_ell[
        torch.clamp(si.prim, 0, scene.volprims.tri_ell.shape[0] - 1)], -1)
    active = st.active & si.valid
    # exit (back-facing) tessellation hits are null events
    entry = torch.sum(si.ng * ray_d, -1) < 0.0
    evals = active & (ell >= 0) & entry
    T = torch.where(evals, eval_transmission(scene, ell, st.ray_o, ray_d),
                    1.0)
    em = eval_sh_emission(scene, ell, ray_d)
    Le = st.beta * (1.0 - T)[:, None] * em
    Le = torch.where(torch.isfinite(Le), Le, 0.0)
    L = st.L + torch.where(evals[:, None], Le, 0.0)
    beta = st.beta * torch.where(evals, T, 1.0)[:, None]
    # past the hit along the ray (the reference avoids spawn_ray here)
    o = torch.where(active[:, None], si.p + ray_d * 1e-4, st.ray_o)
    depth = st.depth + evals.to(st.depth.dtype)
    alive = active & (torch.amax(beta, -1) > 0.01) \
        & (depth < scene.max_depth)
    return VPState(active=alive, ray_o=o, L=L, beta=beta, depth=depth)


def sample(scene: Scene, sampler: Sampler, ray: Ray, mode: str = "primal"):
    """The wavefront march -> (L, valid, sampler), as every integrator's
    sample.  Each splat costs two tessellation hits (entry and exit), so
    at most 2 max_depth + 2 iterations: the primal stops when every lane
    has died, mode="ad" runs them all."""
    n = ray.o.shape[0]
    dev = ray.o.device
    ray_d = m.normalize(ray.d)
    st = VPState(active=torch.ones((n,), dtype=torch.bool, device=dev),
                 ray_o=ray.o, L=ray.o.new_zeros((n, 3)),
                 beta=ray.o.new_ones((n, 3)),
                 depth=torch.zeros((n,), dtype=torch.int64, device=dev))
    max_iters = 2 * scene.max_depth + 2
    if mode == "primal":
        for _ in range(max_iters):
            if not bool(st.active.any()):
                break
            st = _bounce(scene, ray_d, st)
    elif mode == "ad":
        for _ in range(max_iters):
            st = torch.utils.checkpoint.checkpoint(
                _bounce, scene, ray_d, st, use_reentrant=False)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    L = st.L
    if scene.volprims.srgb:
        L = srgb_to_linear(torch.clamp(L, min=0.0))
    return L, torch.ones((n,), dtype=torch.bool, device=dev), sampler
