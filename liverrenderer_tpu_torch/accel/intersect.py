"""Device-side ray intersection (counterpart of
liverrenderer_tpu/accel/intersect.py).

Strategies for the triangle stream:
* the closest-hit sweep over the packed Baldwin-Weber buffer
  (accel/cuda_intersect.py): the hand-written CUDA kernel on a CUDA
  device, its plain PyTorch version on the CPU, for 0 < T <= 2^21;
* ``bvh``: the lockstep stack traversal of the flattened 2-wide BVH
  (`_bvh_tris`), for meshes past 2^21 triangles and intersector="bvh";
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
from .bvh import MAX_LEAF

TRI_CHUNK = 128
# the fat-leaf bound of the BVH build: a leaf holds at most 8 * MAX_LEAF
# triangles
MAX_LEAF_PRIMS = 8 * MAX_LEAF
# leaf lanes tested at once by _bvh_tris (bounds its (lanes, 32, 3) temps)
LEAF_BLOCK = 1 << 17


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


def _ray_aabb(o, inv_d, maxt, bmin, bmax):
    """Slab test -> (entry t clamped at 0, hit)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    near = torch.amax(torch.minimum(t0, t1), -1)
    far = torch.amin(torch.maximum(t0, t1), -1)
    hit = (near <= far) & (far > 0.0) & (near < maxt)
    return torch.clamp(near, min=0.0), hit


def _stack_push(stack, sp, val, mask):
    """stack[lane, sp] = val where mask (the slot clamped to the depth)."""
    slot = torch.clamp(sp, max=stack.shape[1] - 1)[:, None]
    cur = torch.gather(stack, 1, slot)[:, 0]
    stack.scatter_(1, slot, torch.where(mask, val, cur)[:, None])


def _leaf_hits(scene: Scene, ray: Ray, lanes, first, cnt, t_best):
    """Closest hit among each leaf lane's <= MAX_LEAF_PRIMS triangles ->
    (t, tri, u, v), t = inf where none beats t_best.  All of a leaf's
    triangles are tested at once; argmin takes the first of equal t, as
    the JAX package's in-order loop with its strict t < t_best does."""
    k = torch.arange(MAX_LEAF_PRIMS, device=lanes.device)
    li = torch.clamp(first[:, None] + k, 0, scene.bvh.perm.shape[0] - 1)
    tri = scene.bvh.perm[li]                          # (L, K)
    row = scene.tri_si[:, :9][tri]                    # p0, e1, e2
    o = ray.o[lanes][:, None, :]
    d = ray.d[lanes][:, None, :]
    t, u, v, h = _moeller_trumbore(o, d, row[..., 0:3], row[..., 3:6],
                                   row[..., 6:9])
    h = h & (k < cnt[:, None]) & (t < t_best[:, None]) \
        & (t < ray.maxt[lanes][:, None])
    t = torch.where(h, t, INF)
    j = torch.argmin(t, dim=1, keepdim=True)
    return tuple(torch.gather(x, 1, j)[:, 0] for x in (t, tri, u, v))


def _bvh_tris(scene: Scene, ray: Ray, t_best, any_hit: bool,
              shadow: bool = False):
    """Lockstep stack traversal of the flattened 2-wide BVH (accel/bvh.py
    layout), every lane in one loop (counterpart of the JAX package's
    `_bvh_tris`): each step pops one node per lane, tests its box against
    the closest hit so far, tests a leaf's triangles or pushes an inner
    node's children (right, then left, so the left pops first; no
    near-first ordering).  Each step costs two host syncs: the loop test
    (the JAX while_loop's any(sp > 0)) and the list of lanes at a leaf,
    whose triangles are tested only for those lanes."""
    bvh = scene.bvh
    ray = Ray(o=ray.o.detach(), d=ray.d.detach(), maxt=ray.maxt.detach())
    t_best = t_best.detach().clone()          # updated in place below
    N = ray.o.shape[0]
    dev = ray.o.device
    d_safe = torch.where(torch.abs(ray.d) < 1e-12,
                         torch.where(ray.d >= 0, 1e-12, -1e-12), ray.d)
    inv_d = 1.0 / d_safe
    stack = torch.zeros((N, bvh.depth + 2), dtype=torch.int64, device=dev)
    sp = torch.ones((N,), dtype=torch.int64, device=dev)   # root at slot 0
    prim = torch.full((N,), -1, dtype=torch.int64, device=dev)
    uu = torch.zeros_like(t_best)
    vv = torch.zeros_like(t_best)
    while True:
        active = sp > 0
        if not bool(active.any()):
            break
        top = torch.clamp(sp - 1, min=0)
        node = torch.where(active, torch.gather(stack, 1, top[:, None])[:, 0],
                           0)
        sp = torch.where(active, sp - 1, sp)
        _, hit_box = _ray_aabb(ray.o, inv_d, torch.minimum(ray.maxt, t_best),
                               bvh.node_min[node], bvh.node_max[node])
        hit_box = hit_box & active
        right = bvh.right[node]
        is_leaf = right < 0
        leaf = torch.nonzero(hit_box & is_leaf)[:, 0]
        for b in range(0, leaf.shape[0], LEAF_BLOCK):
            lanes = leaf[b:b + LEAF_BLOCK]
            nd = node[lanes]
            t, tri, u, v = _leaf_hits(scene, ray, lanes, bvh.first[nd],
                                      bvh.count[nd], t_best[lanes])
            better = t < t_best[lanes]
            t_best[lanes] = torch.where(better, t, t_best[lanes])
            prim[lanes] = torch.where(better, tri, prim[lanes])
            uu[lanes] = torch.where(better, u, uu[lanes])
            vv[lanes] = torch.where(better, v, vv[lanes])
        push = hit_box & ~is_leaf
        _stack_push(stack, sp, right, push)
        sp = torch.where(push, sp + 1, sp)
        _stack_push(stack, sp, node + 1, push)
        sp = torch.where(push, sp + 1, sp)
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
    or raises), its plain version for CPU tensors.  Larger meshes and
    intersector="bvh" take the BVH traversal."""
    if scene.n_instances or scene.n_sdfs:
        raise not_ported("instanced and SDF geometry", "Queue 1 M10")
    if scene.intersector == "brute" or scene.n_tris == 0:
        return _brute_tris
    if scene.intersector == "bvh" \
            or scene.n_tris > cuda_intersect.MAX_STREAM_TRIS:
        return _bvh_tris
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
