"""Device-side ray intersection (counterpart of
liverrenderer_tpu/accel/intersect.py).

Strategies for the triangle stream:
* the closest-hit sweep over the packed Baldwin-Weber buffer
  (accel/cuda_intersect.py): the hand-written CUDA kernel on a CUDA
  device, its plain PyTorch version on the CPU;
* ``brute``: a chunked Moeller-Trumbore sweep over faces/vertices, the
  JAX package's CPU default for small scenes.
Analytic spheres are tested brute force after the triangles.
`compute_si` turns the winner into a full SurfaceInteraction.
"""
from __future__ import annotations

import math

import torch

from ..core import math as m
from ..core.types import INF, Ray, SurfaceInteraction
from ..errors import not_ported
from ..scene.ir import Scene
from . import cuda_intersect

TRI_CHUNK = 128


def _moeller_trumbore(o, d, p0, e1, e2):
    """Batched Moeller-Trumbore -> (t, u, v, hit); shapes broadcast."""
    pvec = m.cross(d, e2)
    det = torch.sum(e1 * pvec, -1)
    safe = torch.abs(det) > 1e-12
    inv_det = torch.where(safe, 1.0 / torch.where(safe, det, 1.0), 0.0)
    tvec = o - p0
    u = torch.sum(tvec * pvec, -1) * inv_det
    qvec = m.cross(tvec, e1)
    v = torch.sum(d * qvec, -1) * inv_det
    t = torch.sum(e2 * qvec, -1) * inv_det
    hit = safe & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return t, u, v, hit


def _brute_tris(scene: Scene, ray: Ray, t_best, any_hit: bool,
                shadow: bool = False):
    """Chunked brute force over the global triangle stream."""
    T = scene.n_tris
    N = ray.o.shape[0]
    prim = torch.full((N,), -1, dtype=torch.int64, device=ray.o.device)
    uu = torch.zeros_like(t_best)
    vv = torch.zeros_like(t_best)
    if T == 0:
        return t_best, prim, uu, vv
    o = ray.o[:, None, :]
    d = ray.d[:, None, :]
    for base in range(0, T, TRI_CHUNK):
        f = scene.faces[base:base + TRI_CHUNK]
        p0 = scene.vertices[f[:, 0]]
        e1 = scene.vertices[f[:, 1]] - p0
        e2 = scene.vertices[f[:, 2]] - p0
        t, u, v, hit = _moeller_trumbore(o, d, p0[None], e1[None], e2[None])
        hit &= t < t_best[:, None]
        t_masked = torch.where(hit, t, INF)
        j = torch.argmin(t_masked, dim=1)
        tj = torch.gather(t_masked, 1, j[:, None])[:, 0]
        better = tj < t_best
        prim = torch.where(better, base + j, prim)
        uu = torch.where(better, torch.gather(u, 1, j[:, None])[:, 0], uu)
        vv = torch.where(better, torch.gather(v, 1, j[:, None])[:, 0], vv)
        t_best = torch.where(better, tj, t_best)
    return t_best, prim, uu, vv


def _kernel_tris(scene: Scene, ray: Ray, t_best, any_hit: bool,
                 shadow: bool = False):
    t, prim, uu, vv = cuda_intersect.intersect_tris(
        scene.tri_buf, scene.tri_boxes, scene.tri_kperm, ray.o, ray.d,
        ray.maxt, t_best, sort=scene.ray_sort and not any_hit,
        center=scene.tri_center, shadow=shadow)
    better = t < t_best
    return torch.where(better, t, t_best), torch.where(better, prim, -1), \
        torch.where(better, uu, 0.0), torch.where(better, vv, 0.0)


def _tri_strategy(scene: Scene):
    """The closest-hit sweep serves every 0 < T <= 2^21 query: the CUDA
    kernel for CUDA tensors (cuda_intersect.intersect_closest launches it
    or raises), its plain version for CPU tensors."""
    if scene.n_instances or scene.n_sdfs:
        raise not_ported("instanced and SDF geometry", "Queue 1 M10")
    if scene.intersector == "bvh":
        raise not_ported("the lockstep BVH traversal", "Queue 2 (_bvh_tris)")
    if scene.intersector == "brute" or scene.n_tris == 0:
        return _brute_tris
    if scene.n_tris > cuda_intersect.MAX_STREAM_TRIS:
        raise not_ported(f"a mesh of {scene.n_tris} > 2^21 triangles (BVH "
                         "traversal)", "Queue 2 (_bvh_tris)")
    return _kernel_tris


def _spheres(scene: Scene, ray: Ray, t_best):
    """Intersect all analytic spheres (few per scene -> brute force)."""
    N = ray.o.shape[0]
    sph = torch.full((N,), -1, dtype=torch.int64, device=ray.o.device)
    if scene.n_spheres == 0:
        return t_best, sph
    c = scene.sph_center[None]          # (1, Sp, 3)
    r = scene.sph_radius[None]          # (1, Sp)
    o = ray.o[:, None, :] - c
    d = ray.d[:, None, :]
    b = torch.sum(o * d, -1)
    cc = torch.sum(o * o, -1) - r * r
    disc = b * b - cc
    sq = m.safe_sqrt(disc)
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > 1e-5, t0, torch.where(t1 > 1e-5, t1, INF))
    t = torch.where(disc > 0, t, INF)
    j = torch.argmin(t, dim=1)
    tj = torch.gather(t, 1, j[:, None])[:, 0]
    better = tj < t_best
    sph = torch.where(better, j, sph)
    t_best = torch.where(better, tj, t_best)
    return t_best, sph


def ray_intersect_preliminary(scene: Scene, ray: Ray, any_hit: bool = False,
                              shadow: bool = False):
    """(t, prim, u, v, sph_idx); prim = -1 and sph = -1 => miss.
    any_hit: only occlusion is read (the ray sort is skipped); shadow: a
    next-event shadow query (counted apart by the kernel's wrapper)."""
    t_best = torch.where(torch.isfinite(ray.maxt), ray.maxt, INF)
    strat = _tri_strategy(scene)
    t_best, prim, uu, vv = strat(scene, ray, t_best, any_hit=any_hit,
                                 shadow=shadow)
    t_best, sph = _spheres(scene, ray, t_best)
    prim = torch.where(sph >= 0, -1, prim)
    return t_best, prim, uu, vv, sph


def ray_test(scene: Scene, ray: Ray):
    """Shadow-ray occlusion query."""
    _, prim, _, _, sph = ray_intersect_preliminary(scene, ray, any_hit=True,
                                                   shadow=True)
    return (prim >= 0) | (sph >= 0)


def compute_si(scene: Scene, ray: Ray, t, prim, u, v, sph
               ) -> SurfaceInteraction:
    """Full SurfaceInteraction from a preliminary hit (triangles and
    analytic spheres)."""
    if scene.has_vertex_attr or scene.has_tangents:
        raise not_ported("vertex attributes and curve tangents",
                         "Queue 1 M10")
    hit_tri = prim >= 0
    hit_sph = sph >= 0
    hit = hit_tri | hit_sph
    # miss lanes carry garbage preliminaries: sanitize before use
    u = torch.where(hit_tri & torch.isfinite(u), u, 0.0)
    v = torch.where(hit_tri & torch.isfinite(v), v, 0.0)
    t = torch.where(hit & torch.isfinite(t), t, 1.0)

    prim_s = torch.clamp(prim, 0, max(scene.n_tris - 1, 0))
    row = scene.tri_si[prim_s]
    p0 = row[:, 0:3]
    e1 = row[:, 3:6]
    e2 = row[:, 6:9]
    # the sweep carries only (t, prim): re-derive the winner's (t, u, v)
    tt, uu2, vv2, hh = _moeller_trumbore(ray.o, ray.d, p0, e1, e2)
    ok = hit_tri & hh
    u = torch.where(ok, uu2, u)
    v = torch.where(ok, vv2, v)
    t = torch.where(ok, tt, t)
    w = 1.0 - u - v
    p_tri = p0 + e1 * u[:, None] + e2 * v[:, None]
    ng_tri = m.normalize(m.cross(e1, e2))
    ns_tri = row[:, 9:12] * w[:, None] + row[:, 12:15] * u[:, None] \
        + row[:, 15:18] * v[:, None]
    ns_len = m.norm(ns_tri)
    ns_tri = torch.where((ns_len > 1e-6)[:, None],
                         ns_tri / torch.clamp(ns_len, min=1e-6)[:, None],
                         ng_tri)
    uv_tri = row[:, 18:20] * w[:, None] + row[:, 20:22] * u[:, None] \
        + row[:, 22:24] * v[:, None]
    shape_tri = row[:, 24].to(torch.int64)

    sph_s = torch.clamp(sph, min=0)
    c = scene.sph_center[sph_s]
    r = scene.sph_radius[sph_s]
    t_sph = torch.where(hit_sph, t, 1.0)
    ns_sph = m.normalize(ray.at(t_sph) - c)
    p_sph = c + ns_sph * r[:, None]          # re-project for robustness
    theta = m.safe_acos(ns_sph[..., 2])
    phi = torch.atan2(ns_sph[..., 1], ns_sph[..., 0])
    uv_sph = torch.stack([(phi + math.pi) / (2 * math.pi), theta / math.pi],
                         -1)
    shape_sph = scene.sph_shape[sph_s]

    hs = hit_sph[:, None]
    p = torch.where(hs, p_sph, p_tri)
    ng = torch.where(hs, ns_sph, ng_tri)
    ns = torch.where(hs, ns_sph, ns_tri)
    uv = torch.where(hs, uv_sph, uv_tri)
    shape = torch.where(hit_sph, shape_sph,
                        torch.where(hit_tri, shape_tri, -1))
    frame = m.make_frame(ns)
    return SurfaceInteraction(
        t=torch.where(hit, t, INF), p=p, ng=ng, sh_frame=frame, uv=uv,
        wi=frame.to_local(-ray.d),
        prim=torch.where(hit_sph, sph, prim), shape=shape)


def ray_intersect(scene: Scene, ray: Ray,
                  shadow: bool = False) -> SurfaceInteraction:
    # the search is never differentiated; compute_si re-derives the
    # winner's (t, u, v) from tri_si
    t, prim, u, v, sph = (x.detach() for x in ray_intersect_preliminary(
        scene, ray, shadow=shadow))
    return compute_si(scene, ray, t, prim, u, v, sph)
