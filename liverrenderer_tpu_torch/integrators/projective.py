"""Projective (visibility) gradients of the vertex positions (counterpart
of liverrenderer_tpu/integrators/projective.py; the reference's
python/ad/projective.py with direct_projective and prb_projective).

Interior derivatives flow through the differentiable hit recompute
(compute_si reads tri_si, which util.refresh_vertex_geometry rebuilds from
the vertices); what it misses is the boundary term, a line integral over
the silhouette edges,

    dI_pix / dtheta = oint_silhouette dL * (dx / dtheta . n_hat) dl

with dL the radiance difference across the edge and n_hat the edge normal
pointing into the background.  Two estimators:

* the primary term (`boundary_gradient`): silhouettes seen from the
  camera, a line integral on the film; a pilot round builds guided edge
  weights (guiding.edge_guided_weights) for the main round;
* the indirect term (`indirect_boundary_gradient`): silhouettes seen from
  an interior path vertex z_d after a BSDF-sampled prefix of depth
  d ~ U{1..depth_max}, a line integral over directions at z_d; a pilot
  round builds an octree (guiding.octree_from_samples) over the (pixel.x,
  pixel.y, edge pick) primary sample space for the main round.

Each estimator assembles the scalar S(V) = sum coeff * (x(V) . n_bg) with
every factor but the edge point x(V) detached, and differentiates it on a
fresh leaf V.  Only triangle meshes have silhouettes, as in the JAX
package.  Visibility tests, side probes and radiance estimates go through
accel/intersect, so on the card they launch the sweep and merge kernels.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.intersect import (ray_intersect, ray_intersect_preliminary,
                               ray_test)
from ..bsdf.dispatch import bsdf_eval_pdf, bsdf_sample
from ..core import math as m
from ..core.rng import hash_u32, make_sampler
from ..core.types import Ray
from ..scene.ir import SENSOR_ORTHOGRAPHIC, Scene
from ..sensor.perspective import sample_ray
from ..util import apply_params
from .common import _integrator_sample
from .guiding import edge_guided_weights, octree_from_samples
from .shading import shading_frame_with_bump

Tensor = torch.Tensor

_EDGE_CACHE: dict = {}


def edge_table(faces, n_tris: int):
    """Unique-edge adjacency of the first n_tris faces: (edge_v (E, 2),
    edge_f (E, 2)) int64 on the faces' device, edge_f[:, 1] = -1 for a
    boundary edge.  Built in numpy, cached per faces buffer."""
    device = faces.device if isinstance(faces, Tensor) else "cpu"
    if isinstance(faces, Tensor):
        faces = faces.cpu().numpy()
    key = (faces.shape[0], n_tris, int(faces[:1].sum()) if n_tris else 0,
           int(faces[n_tris - 1:n_tris].sum()) if n_tris else 0, str(device))
    hit = _EDGE_CACHE.get(key)
    if hit is not None and np.array_equal(hit[2], faces[:n_tris]):
        return hit[0], hit[1]
    F = np.asarray(faces[:n_tris], np.int64)
    e = np.concatenate([F[:, [0, 1]], F[:, [1, 2]], F[:, [2, 0]]])
    fid = np.tile(np.arange(len(F)), 3)
    key_e = np.minimum(e[:, 0], e[:, 1]) << 32 \
        | np.maximum(e[:, 0], e[:, 1])
    order = np.argsort(key_e, kind="stable")
    key_s, e_s, f_s = key_e[order], e[order], fid[order]
    first = np.ones(len(key_s), bool)
    first[1:] = key_s[1:] != key_s[:-1]
    idx_first = np.nonzero(first)[0]
    ev = e_s[idx_first].astype(np.int32)
    ef = np.full((len(idx_first), 2), -1, np.int32)
    ef[:, 0] = f_s[idx_first]
    nxt = idx_first + 1
    has2 = nxt < len(key_s)
    has2[has2] &= key_s[nxt[has2]] == key_s[idx_first[has2]]
    ef[has2, 1] = f_s[nxt[has2]]
    out = (torch.from_numpy(ev.astype(np.int64)).to(device),
           torch.from_numpy(ef.astype(np.int64)).to(device))
    _EDGE_CACHE.clear()
    _EDGE_CACHE[key] = (out[0], out[1], F.astype(np.int32).copy())
    return out


def project_to_film(scene: Scene, p: Tensor) -> Tensor:
    """World point -> continuous pixel coordinates (the inverse of
    sensor/perspective.sample_ray's film -> direction map)."""
    sensor = scene.sensor
    w, h = scene.film_w, scene.film_h
    aspect = w / h
    R = sensor.to_world[:3, :3]
    t = sensor.to_world[:3, 3]
    p_cam = (p - t) @ R            # R^T (p - t)
    if sensor.stype == SENSOR_ORTHOGRAPHIC:
        nx = (1.0 - p_cam[..., 0]) * 0.5
        ny = (1.0 - p_cam[..., 1] * aspect) * 0.5
    else:
        tan_half = torch.tan(torch.deg2rad(sensor.fov_x) * 0.5)
        z = torch.clamp(p_cam[..., 2], min=1e-6)
        nx = (1.0 - p_cam[..., 0] / (z * tan_half)) * 0.5
        ny = (1.0 - p_cam[..., 1] * aspect / (z * tan_half)) * 0.5
    return torch.stack([nx * w, ny * h], -1)


def _face_front(scene: Scene, Vd, fi, view):
    """Whether face fi faces the viewer at view - its points: (n . (q -
    view) < 0) with q the point the caller passes."""
    f = scene.faces[torch.clamp(fi, min=0)]
    a, b, c = Vd[f[:, 0]], Vd[f[:, 1]], Vd[f[:, 2]]
    n = torch.linalg.cross(b - a, c - a)
    return torch.sum(n * view, -1) < 0.0


def silhouette_weights(scene: Scene, Vd: Tensor, edge_v: Tensor,
                       edge_f: Tensor):
    """(weights, lengths) over the edges: the length on a silhouette edge
    seen from the camera (a boundary edge, or one between a front and a
    back face), 0 elsewhere."""
    cam = scene.sensor.to_world[:3, 3]
    p0, p1 = Vd[edge_v[:, 0]], Vd[edge_v[:, 1]]
    mid = 0.5 * (p0 + p1)
    front0 = _face_front(scene, Vd, edge_f[:, 0], mid - cam)
    front1 = _face_front(scene, Vd, edge_f[:, 1], mid - cam)
    sil = torch.where(edge_f[:, 1] < 0, True, front0 != front1)
    length = torch.linalg.norm(p1 - p0, dim=-1)
    return torch.where(sil, length, 0.0), length


def _edge_grad(V: Tensor, i0, i1, tpar, S_of_x) -> Tensor:
    """d S / d V, where S depends on V only through the edge points
    x = (1 - t) V[i0] + t V[i1]."""
    Vl = V.detach().requires_grad_()
    with torch.enable_grad():
        x = (1.0 - tpar[:, None]) * Vl[i0] + tpar[:, None] * Vl[i1]
        (g,) = torch.autograd.grad(S_of_x(x), Vl)
    return g


def _probe(scene: Scene, ray: Ray, own_shape, dist):
    """Whether the ray hits the edge's own shape at about the edge's
    distance (the foreground side)."""
    t, prim, _, _, _ = ray_intersect_preliminary(scene, ray)
    # an instanced hit's code lies past the table: the JAX gather clamps
    # it to the last triangle
    last = scene.tri_shape.shape[0] - 1
    shp = torch.where(prim >= 0, scene.tri_shape[torch.clamp(prim, 0, last)],
                      -1)
    near = torch.abs(t - dist) < 0.05 * dist + 1e-3
    return (shp == own_shape) & near


def _side_radiance(scene: Scene, seed, salt: int, n: int, ray_p, ray_m,
                   sil_depth: int):
    """Radiance along the two side rays (the + side first), non-finite
    values zeroed, with transport capped at sil_depth bounces."""
    lanes = torch.arange(n, device=scene.device)
    smp = make_sampler(hash_u32(lanes, torch.full_like(lanes, salt)), 0,
                       seed)
    sc_sil = scene.replace(max_depth=min(scene.max_depth, sil_depth))
    L_p, _, smp = _integrator_sample(sc_sil, smp, ray_p, mode="primal")
    L_m, _, smp = _integrator_sample(sc_sil, smp, ray_m, mode="primal")
    return (torch.where(torch.isfinite(L_p), L_p, 0.0),
            torch.where(torch.isfinite(L_m), L_m, 0.0))


@torch.no_grad()
def _boundary_grad(scene: Scene, V: Tensor, edge_v: Tensor, edge_f: Tensor,
                   delta: Tensor, wgt: Tensor, seed, n_samples: int,
                   sil_depth: int, lanes: dict | None = None):
    """Vertex cotangent of the primary-visibility boundary term.

    delta: (h, w, 3) d loss / d image; wgt: (E,) categorical edge weights
    supported on the silhouette set (the uniform length measure or a
    pilot's guided one).  Returns (d loss / d V, per-sample
    |contribution| (P,), sampled edges (P,)); `lanes`, when given, gets
    each sample's `visible`, `fg_p` and `fg_m` masks."""
    w, h = scene.film_w, scene.film_h
    dev = scene.device
    Vd = V.detach()
    cam = scene.sensor.to_world[:3, 3]
    _, length = silhouette_weights(scene, Vd, edge_v, edge_f)
    total_w = torch.sum(wgt)

    # ---- n_samples points on the silhouette set ----
    u = make_sampler(torch.arange(n_samples, device=dev), 0, seed)
    u_pick, u = u.next_1d()
    u_t, u = u.next_1d()
    cdf = torch.cumsum(wgt, 0)
    e_idx = torch.searchsorted(cdf, (u_pick * total_w).contiguous(),
                               right=True)
    e_idx = torch.clamp(e_idx, 0, edge_v.shape[0] - 1)
    i0 = edge_v[e_idx, 0]
    i1 = edge_v[e_idx, 1]
    tpar = u_t
    x = (1.0 - tpar[:, None]) * Vd[i0] + tpar[:, None] * Vd[i1]
    len_e = length[e_idx]
    # the shape of the edge's first face: the foreground to look for
    own_shape = scene.tri_shape[torch.clamp(edge_f[e_idx, 0], min=0)]

    # ---- visibility from the camera ----
    to_x = x - cam
    dist = torch.linalg.norm(to_x, dim=-1)
    d_cam = to_x / torch.clamp(dist, min=1e-9)[:, None]
    occ = ray_test(scene, Ray(o=torch.broadcast_to(cam, x.shape), d=d_cam,
                              maxt=dist * (1.0 - 1e-3)))
    visible = ~occ & (total_w > 0.0)

    # ---- film position and film velocity along the edge ----
    e_unit = (Vd[i1] - Vd[i0]) / torch.clamp(len_e, min=1e-9)[:, None]
    xf, dxf = torch.func.jvp(lambda q: project_to_film(scene, q), (x,),
                             (e_unit,))
    speed = torch.linalg.norm(dxf, dim=-1)          # px per scene unit
    ef_unit = dxf / torch.clamp(speed, min=1e-9)[:, None]
    n_hat = torch.stack([-ef_unit[:, 1], ef_unit[:, 0]], -1)
    in_film = (xf[:, 0] >= 0.5) & (xf[:, 0] < w - 0.5) \
        & (xf[:, 1] >= 0.5) & (xf[:, 1] < h - 0.5)
    visible &= in_film & (speed > 1e-6)

    # ---- the two sides: which one hits the owning shape at about the
    # silhouette's depth, and the radiance difference across ----
    eps_px = 0.1
    ray_p = sample_ray(scene, xf + eps_px * n_hat)
    ray_m = sample_ray(scene, xf - eps_px * n_hat)
    fg_p = _probe(scene, ray_p, own_shape, dist)
    fg_m = _probe(scene, ray_m, own_shape, dist)
    visible &= fg_p ^ fg_m
    if lanes is not None:
        lanes.update(visible=visible, fg_p=fg_p, fg_m=fg_m)

    L_p, L_m = _side_radiance(scene, seed, 0x9D7F3A21, n_samples, ray_p,
                              ray_m, sil_depth)
    # dL = L_foreground - L_background; n_bg points into the background
    dL = torch.where(fg_p[:, None], L_p - L_m, L_m - L_p)
    n_bg = torch.where(fg_p[:, None], -n_hat, n_hat)

    # ---- the boundary VJP: the sampler's film-space line density with
    # categorical weights w_e is (w_e / total_w) / (len_e * speed) ----
    inv_p = total_w * speed * len_e / torch.clamp(wgt[e_idx], min=1e-30)
    pix = torch.clamp(xf[:, 1].to(torch.int64), 0, h - 1) * w \
        + torch.clamp(xf[:, 0].to(torch.int64), 0, w - 1)
    d_pix = delta.reshape(-1, 3)[pix]
    coeff = torch.sum(d_pix * dL, -1) * inv_p / n_samples
    coeff = torch.where(visible, coeff, 0.0)

    def S(xv):
        xfv = project_to_film(scene, xv)
        return torch.sum(coeff * torch.sum(xfv * n_bg, -1))

    return _edge_grad(V, i0, i1, tpar, S), torch.abs(coeff) * n_samples, \
        e_idx


def _merge(mask: Tensor, a, b):
    """Per-lane select between two records (dataclasses of (N, ...)
    tensors): a where mask, else b."""
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: _merge(mask, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)})
    if a is None:
        return None
    return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a, b)


def _prefix_walk(scene: Scene, si, smp, depth_max: int, n: int):
    """Extend each camera hit by a BSDF-sampled walk of d - 1 bounces,
    d ~ U{1..depth_max}: (z_d's interaction, the prefix throughput times
    depth_max, whether the walk stayed on surfaces, sampler)."""
    prefix_ok = si.valid
    beta = si.p.new_ones((n, 3))
    if depth_max <= 1:
        return si, beta, prefix_ok, smp
    u_d, smp = smp.next_1d()
    depth_t = torch.clamp(1 + torch.floor(u_d * depth_max).to(torch.int64),
                          1, depth_max)
    for k in range(depth_max - 1):
        u1, smp = smp.next_1d()
        # a 1-D draw, as in the JAX package: the BSDF's 2-D sample reads
        # its u2[..., 0] and u2[..., 1], lanes 0 and 1, on every lane
        u2, smp = smp.next_1d()
        extend = prefix_ok & (k < depth_t - 1)
        bidx = m.table_lookup(scene.shape_bsdf, torch.clamp(si.shape, min=0))
        bs = bsdf_sample(scene, si, bidx, u1, u2)
        d_w = si.to_world(bs.wo)
        d_w = d_w / torch.clamp(torch.linalg.norm(d_w, dim=-1,
                                                  keepdim=True), min=1e-12)
        r2 = si.spawn_ray(d_w)
        si_n = shading_frame_with_bump(scene, ray_intersect(scene, r2), r2)
        wgt = torch.where(torch.isfinite(bs.weight), bs.weight, 0.0)
        good = si_n.valid & (bs.pdf > 0) & (torch.amax(wgt, -1) > 0)
        beta = torch.where(extend[:, None], beta * wgt, beta)
        si = _merge(extend, si_n, si)
        prefix_ok = torch.where(extend, good, prefix_ok)
    return si, beta * depth_max, prefix_ok, smp


@torch.no_grad()
def _indirect_boundary_grad(scene: Scene, V: Tensor, edge_v: Tensor,
                            edge_f: Tensor, delta: Tensor, seed,
                            n_samples: int, sil_depth: int,
                            eps_ang: float = 1e-3, ocs=None,
                            depth_max: int = 1):
    """Vertex cotangent of the indirect visibility boundary term:
    silhouettes seen from an interior path vertex z_d.  Each lane jointly
    samples a pixel, a prefix depth and an edge point (the reference's
    (pixel^2, depth) boundary sample space); with `ocs` the (pixel.x,
    pixel.y, edge pick) draw is warped through the pilot octree.  A delta
    BSDF at z_d evaluates to zero.  Returns (d loss / d V, the primary
    sample points (P, 3), per-sample |contribution| (P,))."""
    w, h = scene.film_w, scene.film_h
    dev = scene.device
    Vd = V.detach()

    # ---- prefix: one camera ray per lane -> z1 ----
    smp = make_sampler(torch.arange(n_samples, device=dev), 0, seed)
    u_pix, smp = smp.next_2d()
    u_pick, smp = smp.next_1d()
    u_t, smp = smp.next_1d()
    if ocs is not None:
        u_sel, smp = smp.next_1d()
        prim, dens = ocs.sample(
            u_sel, torch.stack([u_pix[:, 0], u_pix[:, 1], u_pick], -1))
        u_pix = prim[:, 0:2]
        u_pick = prim[:, 2]
        inv_dens = 1.0 / torch.clamp(dens, min=1e-12)
    else:
        inv_dens = u_pick.new_ones((n_samples,))
    prim_pts = torch.stack([u_pix[:, 0], u_pix[:, 1], u_pick], -1)
    pos = u_pix * u_pix.new_tensor([w, h])
    ray = sample_ray(scene, pos)
    si = shading_frame_with_bump(scene, ray_intersect(scene, ray), ray)
    si, beta, prefix_ok, smp = _prefix_walk(scene, si, smp, depth_max,
                                            n_samples)
    bsdf_idx = m.table_lookup(scene.shape_bsdf, torch.clamp(si.shape, min=0))

    # ---- edge point, uniform by length over all edges (the silhouette
    # set depends on z_d, so the test is per lane) ----
    p0, p1 = Vd[edge_v[:, 0]], Vd[edge_v[:, 1]]
    length = torch.linalg.norm(p1 - p0, dim=-1)
    total_len = torch.sum(length)
    cdf = torch.cumsum(length, 0)
    e_idx = torch.clamp(torch.searchsorted(
        cdf, (u_pick * total_len).contiguous(), right=True),
        0, edge_v.shape[0] - 1)
    i0, i1 = edge_v[e_idx, 0], edge_v[e_idx, 1]
    x = (1.0 - u_t[:, None]) * Vd[i0] + u_t[:, None] * Vd[i1]
    len_e = length[e_idx]
    own_shape = scene.tri_shape[torch.clamp(edge_f[e_idx, 0], min=0)]

    front0 = _face_front(scene, Vd, edge_f[e_idx, 0], x - si.p)
    front1 = _face_front(scene, Vd, edge_f[e_idx, 1], x - si.p)
    sil = torch.where(edge_f[e_idx, 1] < 0, True, front0 != front1)

    to_x = x - si.p
    r = torch.linalg.norm(to_x, dim=-1)
    wdir = to_x / torch.clamp(r, min=1e-9)[:, None]
    valid = prefix_ok & sil & (r > 1e-4)

    # visibility z_d -> x
    sray = si.spawn_ray(wdir)
    valid &= ~ray_test(scene, Ray(o=sray.o, d=wdir, maxt=r * (1.0 - 1e-3)))

    # the BSDF at z_d toward the edge (delta lobes -> 0)
    bval, _ = bsdf_eval_pdf(scene, si, bsdf_idx, si.to_local(wdir))

    # angular velocity of the silhouette point along the edge
    e_unit = (Vd[i1] - Vd[i0]) / torch.clamp(len_e, min=1e-9)[:, None]
    dw = (e_unit - wdir * torch.sum(wdir * e_unit, -1, keepdim=True)) \
        / torch.clamp(r, min=1e-9)[:, None]
    speed = torch.linalg.norm(dw, dim=-1)        # rad per unit edge length
    dw_unit = dw / torch.clamp(speed, min=1e-12)[:, None]
    n3 = torch.linalg.cross(wdir, dw_unit)       # tangent-plane normal
    valid &= speed > 1e-9

    # ---- radiance difference across the edge, probed from z_d ----
    def side_ray(sgn):
        d = wdir + sgn * eps_ang * n3
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        sr = si.spawn_ray(d)
        return Ray(o=sr.o, d=d, maxt=torch.full((n_samples,), float("inf"),
                                                device=dev))

    ray_p, ray_m = side_ray(+1.0), side_ray(-1.0)
    fg_p = _probe(scene, ray_p, own_shape, r)
    fg_m = _probe(scene, ray_m, own_shape, r)
    valid &= fg_p ^ fg_m

    L_p, L_m = _side_radiance(scene, seed, 0x51C3B7A9, n_samples, ray_p,
                              ray_m, sil_depth)
    dL = torch.where(fg_p[:, None], L_p - L_m, L_m - L_p)
    n_bg = torch.where(fg_p[:, None], -n3, n3)

    # ---- assemble: pixel pdf 1 / (w h); edge-length pdf 1 / total_len,
    # in the angular domain total_len * speed ----
    pix = torch.clamp(pos[:, 1].to(torch.int64), 0, h - 1) * w \
        + torch.clamp(pos[:, 0].to(torch.int64), 0, w - 1)
    d_pix = delta.reshape(-1, 3)[pix]
    coeff = torch.sum(d_pix * beta * bval * dL, -1) * total_len * speed \
        * (w * h) / n_samples * inv_dens
    coeff = torch.where(torch.isfinite(coeff), coeff, 0.0)
    coeff = torch.where(valid, coeff, 0.0)
    n_bg = torch.where(valid[:, None], n_bg, 0.0)
    # invalid lanes carry non-finite z (a missed prefix): zero them so a
    # zero coefficient cannot meet a NaN
    z1 = torch.where(valid[:, None] & torch.isfinite(si.p), si.p, 0.0)

    def S(xv):
        tv = xv - z1
        nrm = torch.clamp(torch.linalg.norm(tv, dim=-1, keepdim=True),
                          min=1e-9)
        return torch.sum(coeff * torch.sum(tv / nrm * n_bg, -1))

    return _edge_grad(V, i0, i1, u_t, S), prim_pts, \
        torch.abs(coeff) * n_samples


def _prepare(scene: Scene, params, delta_image):
    """The scene with the parameters applied (detached), its edge table
    and d loss / d image on its device."""
    sc = apply_params(scene, {k: torch.as_tensor(v).detach()
                              for k, v in params.items()})
    ev, ef = edge_table(sc.faces, sc.n_tris)
    delta = torch.as_tensor(delta_image, dtype=torch.float32,
                            device=sc.device)
    return sc, ev, ef, delta


def _rounds(n_samples: int, pilot_frac: float):
    n_pilot = max(256, int(n_samples * pilot_frac))
    return n_pilot, max(256, n_samples - n_pilot)


def indirect_boundary_gradient(scene: Scene, params, delta_image,
                               seed: int = 0, n_samples: int = 1 << 16,
                               sil_depth: int = 6, guiding: str = "octree",
                               pilot_frac: float = 0.25,
                               depth_max: int = 1):
    """d loss / d vertices, the indirect visibility boundary term
    (occluders seen through rough reflections or refractions at interior
    path vertices, after a prefix of up to depth_max bounces).

    guiding="octree": a uniform pilot round builds an OcSpaceDistr from
    its per-sample |contribution| and the main round samples it; the two
    unbiased rounds are weighted by their counts.  "none": one uniform
    round."""
    if scene.n_tris == 0 or "vertices" not in params:
        return torch.zeros_like(scene.vertices)
    sc, ev, ef, delta = _prepare(scene, params, delta_image)
    V = sc.vertices
    if guiding == "none":
        return _indirect_boundary_grad(sc, V, ev, ef, delta, seed,
                                       n_samples, sil_depth,
                                       depth_max=depth_max)[0]
    n_pilot, n_main = _rounds(n_samples, pilot_frac)
    g1, pts, mass = _indirect_boundary_grad(sc, V, ev, ef, delta, seed,
                                            n_pilot, sil_depth,
                                            depth_max=depth_max)
    ocs = octree_from_samples(pts, mass)
    g2, _, _ = _indirect_boundary_grad(sc, V, ev, ef, delta, seed + 1,
                                       n_main, sil_depth, ocs=ocs,
                                       depth_max=depth_max)
    return (n_pilot * g1 + n_main * g2) / (n_pilot + n_main)


def boundary_gradient(scene: Scene, params, delta_image, seed: int = 0,
                      n_samples: int = 1 << 16, sil_depth: int = 6,
                      guiding: str = "edges", pilot_frac: float = 0.25):
    """d loss / d vertices, the primary-visibility boundary term;
    delta_image: (h, w, 3) d loss / d image.

    guiding="edges": a pilot round samples the silhouette uniformly by
    length, its per-sample |contribution| builds guided edge weights
    (guiding.edge_guided_weights), the main round samples them, and the
    two unbiased rounds are weighted by their counts.  "none": one
    uniform round.  Only triangle meshes contribute silhouettes."""
    if scene.n_tris == 0 or "vertices" not in params:
        return torch.zeros_like(scene.vertices)
    sc, ev, ef, delta = _prepare(scene, params, delta_image)
    V = sc.vertices
    wgt0 = silhouette_weights(sc, V, ev, ef)[0]
    if guiding == "none":
        return _boundary_grad(sc, V, ev, ef, delta, wgt0, seed, n_samples,
                              sil_depth)[0]
    n_pilot, n_main = _rounds(n_samples, pilot_frac)
    g1, mass, e_idx = _boundary_grad(sc, V, ev, ef, delta, wgt0, seed,
                                     n_pilot, sil_depth)
    wgt1 = edge_guided_weights(mass, e_idx, wgt0)
    g2, _, _ = _boundary_grad(sc, V, ev, ef, delta, wgt1, seed + 1, n_main,
                              sil_depth)
    return (n_pilot * g1 + n_main * g2) / (n_pilot + n_main)
