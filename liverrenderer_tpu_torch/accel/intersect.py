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
Then the instance pass (`_instances`: each instanced shapegroup's shared
group-local triangles moved to world space per (lane, instance) pair whose
world box the lane's ray enters), the analytic spheres (brute force) and
the SDF grids (`_sdfs`, a fixed-count masked sphere trace).
`compute_si` turns the winner into a full SurfaceInteraction.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core import math as m
from ..core.types import INF, Ray, SurfaceInteraction
from ..scene.ir import INST_CHUNK, Scene
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


def _inv_dir(d):
    """1 / d with components below 1e-12 in magnitude pushed to +-1e-12."""
    d_safe = torch.where(torch.abs(d) < 1e-12,
                         torch.where(d >= 0, 1e-12, -1e-12), d)
    return 1.0 / d_safe


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
    inv_d = _inv_dir(ray.d)
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
    if scene.intersector == "brute" or scene.n_tris == 0:
        return _brute_tris
    if scene.intersector == "bvh" \
            or scene.n_tris > cuda_intersect.MAX_STREAM_TRIS:
        return _bvh_tris
    return _kernel_tris


# the instance pass's working set: (lane, instance) entries per box-test
# block, and pair x triangle-row entries per Moeller-Trumbore block (its
# (pairs, rows, 3, 3) world triangles are 36 B an entry), on the CPU and
# on a CUDA device
INST_BOX_BLOCK = 1 << 22
INST_PAIR_BLOCK = {"cpu": 1 << 21, "cuda": 1 << 23}
# counters of the instance pass (chip_smoke.py reads them): its host
# syncs (one per lane block: the list of box-hit pairs) and the pairs
INST_SYNCS = 0
INST_PAIRS = 0


def _instance_pairs(scene: Scene, ray: Ray, inv_d, t_best, lo, hi):
    """(lane, instance) pairs of lanes lo..hi whose ray enters the
    instance's world box before min(maxt, t_best), lane-major: one host
    sync."""
    global INST_SYNCS
    o = ray.o[lo:hi, None, :]
    _, box = _ray_aabb(o, inv_d[lo:hi, None, :],
                       torch.minimum(ray.maxt[lo:hi], t_best[lo:hi])[:, None],
                       scene.inst_bmin[None], scene.inst_bmax[None])
    pairs = torch.nonzero(box)
    INST_SYNCS += 1
    return pairs[:, 0] + lo, pairs[:, 1]


def _pair_hits(scene: Scene, ray: Ray, t_best, lane, inst):
    """Closest hit of each (lane, instance) pair among the instance's
    group triangles -> (t, code, u, v), t = inf where none beats t_best.
    The group-local triangles go to world space with the instance's 3x4
    (vertices, then edges: the flattening builder's operations, so
    instanced and flattened geometry agree to fp32 rounding); ties keep
    the first row, as the JAX package's chunk loop with its strict
    t < t_best."""
    P = lane.shape[0]
    dev = lane.device
    rows = scene.inst_max_chunks * INST_CHUNK
    rb = min(rows, max(INST_CHUNK, INST_PAIR_BLOCK[dev.type] // max(P, 1)
                       // INST_CHUNK * INST_CHUNK))
    xf = scene.inst_xf[inst]
    M = xf[:, :12].reshape(-1, 3, 4)
    start = scene.inst_face_start[inst]
    n_rows = scene.inst_n_chunks[inst] * INST_CHUNK
    o = ray.o[lane][:, None, :]
    d = ray.d[lane][:, None, :]
    tb = torch.minimum(t_best[lane], ray.maxt[lane])
    best_t = torch.full((P,), INF, device=dev)
    best_r = torch.zeros((P,), dtype=torch.int64, device=dev)
    best_u = torch.zeros((P,), device=dev)
    best_v = torch.zeros((P,), device=dev)
    last = scene.inst_tris.shape[0] - 1
    for r0 in range(0, rows, rb):
        r = torch.arange(r0, min(r0 + rb, rows), device=dev)
        valid = r[None] < n_rows[:, None]
        blk = scene.inst_tris[torch.clamp(start[:, None] + r[None], max=last)]
        pw = torch.einsum("pij,prkj->prki", M[:, :, :3], blk) \
            + M[:, None, None, :, 3]                  # (P, R, 3, 3)
        p0 = pw[:, :, 0]
        t, u, v, hit = _moeller_trumbore(o, d, p0, pw[:, :, 1] - p0,
                                         pw[:, :, 2] - p0)
        hit &= valid & (t < tb[:, None])
        t = torch.where(hit, t, INF)
        j = torch.argmin(t, dim=1)
        tj = torch.gather(t, 1, j[:, None])[:, 0]
        better = tj < best_t
        best_t = torch.where(better, tj, best_t)
        best_r = torch.where(better, r0 + j, best_r)
        best_u = torch.where(better, torch.gather(u, 1, j[:, None])[:, 0],
                             best_u)
        best_v = torch.where(better, torch.gather(v, 1, j[:, None])[:, 0],
                             best_v)
    code = scene.n_tris + inst * scene.n_inst_tris + start + best_r
    return best_t, code, best_u, best_v


def _instances(scene: Scene, ray: Ray, t_best, prim, uu, vv):
    """The instanced-geometry pass (counterpart of the JAX package's
    `_instances`): the pairs of lanes and instances whose boxes they
    enter, each pair's closest group triangle, and per lane the closest
    pair (the lowest code among equal t: the JAX scan's instance order).
    Hits are encoded prim = n_tris + instance * n_inst_tris + group row.
    Never differentiated (ray_intersect detaches the search)."""
    global INST_PAIRS
    N = ray.o.shape[0]
    dev = ray.o.device
    ray = Ray(o=ray.o.detach(), d=ray.d.detach(), maxt=ray.maxt.detach())
    t_best = t_best.detach()
    inv_d = _inv_dir(ray.d)
    lane_blk = max(1, INST_BOX_BLOCK // max(scene.n_instances, 1))
    for lo in range(0, N, lane_blk):
        # lane blocks are disjoint: a block reads only its own lanes of
        # t_best
        lane, inst = _instance_pairs(scene, ray, inv_d, t_best, lo,
                                     min(lo + lane_blk, N))
        INST_PAIRS += lane.shape[0]
        if lane.shape[0] == 0:
            continue
        pb = max(1, INST_PAIR_BLOCK[dev.type] // INST_CHUNK)
        lt = torch.full((N,), INF, device=dev)
        out = []
        for b in range(0, lane.shape[0], pb):
            res = _pair_hits(scene, ray, t_best, lane[b:b + pb],
                             inst[b:b + pb])
            out.append(res)
            lt = lt.scatter_reduce(0, lane[b:b + pb], res[0], "amin")
        t_p, code_p, u_p, v_p = (torch.cat(x) for x in zip(*out))
        cand = torch.isfinite(t_p) & (t_p == lt[lane])
        big = torch.iinfo(torch.int64).max
        lc = torch.full((N,), big, dtype=torch.int64, device=dev)
        lc = lc.scatter_reduce(0, lane, torch.where(cand, code_p, big),
                               "amin")
        win = cand & (code_p == lc[lane])
        wu = torch.zeros((N,), device=dev).index_add_(
            0, lane, torch.where(win, u_p, 0.0))
        wv = torch.zeros((N,), device=dev).index_add_(
            0, lane, torch.where(win, v_p, 0.0))
        better = lt < t_best
        t_best = torch.where(better, lt, t_best)
        prim = torch.where(better, lc, prim)
        uu = torch.where(better, wu, uu)
        vv = torch.where(better, wv, vv)
    return t_best, prim, uu, vv


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


_SDF_STEPS = 96
# the march stops early once every lane is dead (a dead lane's step
# changes nothing, so the result is the full count's); tested every
# this many steps, one host sync each
SDF_CHECK_EVERY = 16
SDF_STEPS_RUN = 0       # march steps run (chip_smoke.py reads it)


def _trilinear(grid, whd, k, p):
    """Trilinear sample of SDF grid k (per lane or one) at local p (N, 3)
    in [0,1]^3; whd (.., 3) the true (W, H, D)."""
    W = (whd[..., 0] - 1).to(torch.float32)
    H = (whd[..., 1] - 1).to(torch.float32)
    D = (whd[..., 2] - 1).to(torch.float32)
    fx = torch.clamp(p[:, 0], 0.0, 1.0) * W
    fy = torch.clamp(p[:, 1], 0.0, 1.0) * H
    fz = torch.clamp(p[:, 2], 0.0, 1.0) * D
    x0 = torch.minimum(torch.clamp(fx.to(torch.int64), min=0),
                       whd[..., 0] - 2)
    y0 = torch.minimum(torch.clamp(fy.to(torch.int64), min=0),
                       whd[..., 1] - 2)
    z0 = torch.minimum(torch.clamp(fz.to(torch.int64), min=0),
                       whd[..., 2] - 2)
    tx = fx - x0
    ty = fy - y0
    tz = fz - z0
    _, Dm, Hm, Wm = grid.shape
    flat = grid.reshape(-1)
    base = ((k * Dm + z0) * Hm + y0) * Wm + x0

    def g(dz, dy, dx):
        return flat[base + (dz * Hm + dy) * Wm + dx]

    c00 = g(0, 0, 0) * (1 - tx) + g(0, 0, 1) * tx
    c01 = g(0, 1, 0) * (1 - tx) + g(0, 1, 1) * tx
    c10 = g(1, 0, 0) * (1 - tx) + g(1, 0, 1) * tx
    c11 = g(1, 1, 0) * (1 - tx) + g(1, 1, 1) * tx
    c0 = c00 * (1 - ty) + c01 * ty
    c1 = c10 * (1 - ty) + c11 * ty
    return c0 * (1 - tz) + c1 * tz


def _sdfs(scene: Scene, ray: Ray, t_best):
    """Sphere-trace the SDF grid shapes (sdfgrid.cpp; counterpart of the
    JAX package's `_sdfs`): per SDF a masked march of _SDF_STEPS steps
    from the ray's entry into the local unit cube, converged where the
    distance falls below 1e-3 -> (t_best, sdf index or -1)."""
    global SDF_STEPS_RUN
    N = ray.o.shape[0]
    dev = ray.o.device
    ray = Ray(o=ray.o.detach(), d=ray.d.detach(), maxt=ray.maxt.detach())
    sdf_idx = torch.full((N,), -1, dtype=torch.int64, device=dev)
    eps = 1e-3
    for k in range(scene.n_sdfs):
        A = scene.sdf_to_local[k]
        o_l = ray.o @ A[:3, :3].T + A[:3, 3]
        d_l = ray.d @ A[:3, :3].T
        dl_len = torch.clamp(m.norm(d_l), min=1e-12)
        inv = 1.0 / torch.where(torch.abs(d_l) > 1e-12, d_l, 1e-12)
        t0 = (0.0 - o_l) * inv
        t1 = (1.0 - o_l) * inv
        near = torch.amax(torch.minimum(t0, t1), -1)
        far = torch.amin(torch.maximum(t0, t1), -1)
        box = (near <= far) & (far > 0.0) & (near < t_best)
        t = torch.clamp(near, min=0.0) + 1e-5
        whd = scene.sdf_whd[k]
        hit = torch.zeros((N,), dtype=torch.bool, device=dev)
        dead = ~box
        stop = torch.minimum(far, t_best)
        for i in range(_SDF_STEPS):
            if i % SDF_CHECK_EVERY == 0 and bool(dead.all()):
                break
            SDF_STEPS_RUN += 1
            val = _trilinear(scene.sdf_grids, whd, k, o_l + t[:, None] * d_l)
            conv = (val < eps) & ~dead
            step = torch.clamp(val, min=0.25 * eps) / dl_len
            t_next = t + step
            dead2 = dead | conv | (t_next > stop)
            t = torch.where(dead, t, t_next)
            # keep t at the converged point, not the advanced one
            t = torch.where(conv, t - step, t)
            hit = hit | conv
            dead = dead2
        take = hit & (t < t_best) & (t > 1e-5)
        t_best = torch.where(take, t, t_best)
        sdf_idx = torch.where(take, k, sdf_idx)
    return t_best, sdf_idx


def ray_intersect_preliminary(scene: Scene, ray: Ray, any_hit: bool = False,
                              shadow: bool = False):
    """(t, prim, u, v, sph_idx); prim = -1 and sph = -1 => miss.  An
    instanced hit is prim = n_tris + instance * n_inst_tris + group row,
    an SDF hit sph = n_spheres + its index.  any_hit: only occlusion is
    read (the ray sort is skipped); shadow: a next-event shadow query
    (counted apart by the kernel's wrapper)."""
    t_best = torch.where(torch.isfinite(ray.maxt), ray.maxt, INF)
    strat = _tri_strategy(scene)
    t_best, prim, uu, vv = strat(scene, ray, t_best, any_hit=any_hit,
                                 shadow=shadow)
    if scene.n_instances:
        t_best, prim, uu, vv = _instances(scene, ray, t_best, prim, uu, vv)
    t_best, sph = _spheres(scene, ray, t_best)
    if scene.n_sdfs:
        t_best, sdf = _sdfs(scene, ray, t_best)
        sph = torch.where(sdf >= 0, scene.n_spheres + sdf, sph)
    prim = torch.where(sph >= 0, -1, prim)
    return t_best, prim, uu, vv, sph


def ray_test(scene: Scene, ray: Ray):
    """Shadow-ray occlusion query."""
    _, prim, _, _, sph = ray_intersect_preliminary(scene, ray, any_hit=True,
                                                   shadow=True)
    return (prim >= 0) | (sph >= 0)


def compute_si(scene: Scene, ray: Ray, t, prim, u, v, sph
               ) -> SurfaceInteraction:
    """Full SurfaceInteraction from a preliminary hit (triangles, instanced
    triangles, analytic spheres and SDF grids), with the interpolated
    vertex attribute and, on curve tubes, the fiber tangent as the
    frame's s axis."""
    hit_tri = prim >= 0
    hit_sph = sph >= 0
    hit = hit_tri | hit_sph
    # miss lanes carry garbage preliminaries: sanitize before use
    u = torch.where(hit_tri & torch.isfinite(u), u, 0.0)
    v = torch.where(hit_tri & torch.isfinite(v), v, 0.0)
    t = torch.where(hit & torch.isfinite(t), t, 1.0)

    is_inst = hit_tri & (prim >= scene.n_tris) if scene.n_instances \
        else torch.zeros_like(hit_tri)
    prim_s = torch.clamp(prim, 0, max(scene.n_tris - 1, 0))
    row = scene.tri_si[prim_s]
    p0 = row[:, 0:3]
    e1 = row[:, 3:6]
    e2 = row[:, 6:9]
    # the sweep carries only (t, prim): re-derive the winner's (t, u, v)
    tt, uu2, vv2, hh = _moeller_trumbore(ray.o, ray.d, p0, e1, e2)
    ok = hit_tri & ~is_inst & hh
    u = torch.where(ok, uu2, u)
    v = torch.where(ok, vv2, v)
    t = torch.where(ok, tt, t)
    if scene.n_instances:
        row, p0, e1, e2, u, v, t = _instance_rows(scene, ray, prim, is_inst,
                                                  row, p0, e1, e2, u, v, t)
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

    # an SDF hit's sph (n_spheres + k) lies past the sphere table
    sph_s = torch.clamp(sph, 0, scene.sph_radius.shape[0] - 1)
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
    if scene.n_sdfs:
        p, ng, ns, uv, shape = _sdf_si(scene, ray, t, sph, hit_sph,
                                       p, ng, ns, uv, shape)

    attr = None
    if scene.has_vertex_attr:
        fa = scene.faces[prim_s]
        va = scene.vertex_attrs
        attr = va[fa[:, 0]] * w[:, None] + va[fa[:, 1]] * u[:, None] \
            + va[fa[:, 2]] * v[:, None]
    frame = m.make_frame(ns)
    if scene.has_tangents:
        # curve tubes: the frame's s axis along the interpolated fiber
        # tangent (the hair BSDF's +x convention, scene/curves.py)
        f = scene.faces[prim_s]
        tv = scene.tangents
        tg = tv[f[:, 0]] * w[:, None] + tv[f[:, 1]] * u[:, None] \
            + tv[f[:, 2]] * v[:, None]
        tg = tg - torch.sum(tg * ns, -1, keepdim=True) * ns
        tl = m.norm(tg)
        use = ((tl > 1e-6) & hit_tri)[:, None]
        s_ax = torch.where(use, tg / torch.clamp(tl, min=1e-6)[:, None],
                           frame.s)
        frame = dataclasses.replace(
            frame, s=s_ax, t=torch.where(use, m.cross(ns, s_ax), frame.t))
    return SurfaceInteraction(
        t=torch.where(hit, t, INF), p=p, ng=ng, sh_frame=frame, uv=uv,
        wi=frame.to_local(-ray.d),
        prim=torch.where(hit_sph, sph, prim), shape=shape, attr=attr)


def _instance_rows(scene: Scene, ray: Ray, prim, is_inst, row, p0, e1, e2,
                   u, v, t):
    """An instanced lane's group-local row moved to world space by its
    instance (two gathers): the world triangle, its re-derived (t, u, v),
    and the row with the world vertices, edges and normals spliced in."""
    code = torch.clamp(prim - scene.n_tris, min=0)
    iid = torch.div(code, scene.n_inst_tris, rounding_mode="floor")
    gtri = code % scene.n_inst_tris
    irow = scene.inst_si[gtri]
    xf = scene.inst_xf[iid]
    M = xf[:, :12].reshape(-1, 3, 4)
    Nm = xf[:, 12:21].reshape(-1, 3, 3)

    def xform_p(pl):
        return torch.einsum("nij,nj->ni", M[:, :, :3], pl) + M[:, :, 3]

    def xform_n(nl):
        out = torch.einsum("nij,nj->ni", Nm, nl)
        return out / torch.clamp(m.norm(out), min=1e-20)[:, None]

    ip0 = xform_p(irow[:, 0:3])
    ie1 = xform_p(irow[:, 3:6]) - ip0
    ie2 = xform_p(irow[:, 6:9]) - ip0
    itt, iu, iv, ihh = _moeller_trumbore(ray.o, ray.d, ip0, ie1, ie2)
    iok = is_inst & ihh
    u = torch.where(iok, iu, u)
    v = torch.where(iok, iv, v)
    t = torch.where(iok, itt, t)
    ii = is_inst[:, None]
    p0 = torch.where(ii, ip0, p0)
    e1 = torch.where(ii, ie1, e1)
    e2 = torch.where(ii, ie2, e2)
    row = torch.where(ii, torch.cat(
        [ip0, ie1, ie2, xform_n(irow[:, 9:12]), xform_n(irow[:, 12:15]),
         xform_n(irow[:, 15:18]), irow[:, 18:25]], -1), row)
    return row, p0, e1, e2, u, v, t


def _sdf_si(scene: Scene, ray: Ray, t, sph, hit_sph, p, ng, ns, uv, shape):
    """SDF lanes (sph = n_spheres + k): the hit point, the normal from the
    grid's central differences in local space mapped by A^T, uv from the
    local point."""
    is_sdf = hit_sph & (sph >= scene.n_spheres)
    k = torch.clamp(sph - scene.n_spheres, 0, scene.n_sdfs - 1)
    A = scene.sdf_to_local[k]                      # (N, 4, 4)
    whd = scene.sdf_whd[k]
    p_w = ray.at(torch.where(is_sdf, t, 1.0))
    p_l = torch.einsum("nij,nj->ni", A[:, :3, :3], p_w) + A[:, :3, 3]
    h = 0.5 / torch.amax(whd, -1).to(torch.float32)
    grad = []
    for ax in range(3):
        off = p_l.new_zeros((1, 3))
        off[0, ax] = 1.0
        vp = _trilinear(scene.sdf_grids, whd, k, p_l + off * h[:, None])
        vm = _trilinear(scene.sdf_grids, whd, k, p_l - off * h[:, None])
        grad.append(vp - vm)
    n_w = m.normalize(torch.einsum("nij,ni->nj", A[:, :3, :3],
                                   torch.stack(grad, -1)))
    sd = is_sdf[:, None]
    return (torch.where(sd, p_w, p), torch.where(sd, n_w, ng),
            torch.where(sd, n_w, ns), torch.where(sd, p_l[:, :2], uv),
            torch.where(is_sdf, scene.sdf_shape[k], shape))


def ray_intersect(scene: Scene, ray: Ray,
                  shadow: bool = False) -> SurfaceInteraction:
    # the search is never differentiated; compute_si re-derives the
    # winner's (t, u, v) from tri_si
    t, prim, u, v, sph = (x.detach() for x in ray_intersect_preliminary(
        scene, ray, shadow=shadow))
    return compute_si(scene, ray, t, prim, u, v, sph)
