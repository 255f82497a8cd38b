"""Adjoint particle (light) tracer (counterpart of
liverrenderer_tpu/integrators/ptracer.py; reference ptracer.cpp).

Paths start at the emitters carrying radiant intensity, and every vertex
is connected to the camera with a visibility ray (`ray_test`, the
closest-hit kernel); the connections are splatted unfiltered into the
pixel they project to.  One wavefront of light paths walks a fixed
max_depth steps with no early exit, each step one intersection and one
camera connection, with Russian roulette from rr_depth.

Path emission: area emitters (uniform on a triangle of the shape, cosine
direction), point lights, and the infinite family (constant, envmap,
directional) through the bounding-sphere disk: an incoming direction
(uniform sphere, the envmap's 2-D importance map or the delta direction),
then an origin on the scene's bounding-sphere disk perpendicular to it,
weight L pi R^2 / pdf_dir.  The sampler draws select, position,
direction, triangle, and then the disk only when an infinite emitter is
present, as the JAX package does.

The JAX package's behaviour, reproduced: the emitting triangle is drawn
uniformly by index while the weight uses the whole shape's area (exact
only for triangles of equal area), and the emitter vertex itself is
never connected (the camera sees emitters through the forward
integrators).  `render` of a ptracer scene raises ValueError in both
packages: render_ptracer renders it.
"""
from __future__ import annotations

import math

import torch

from ..accel.intersect import ray_intersect, ray_test
from ..bsdf.dispatch import bsdf_eval_pdf, bsdf_sample
from ..core import math as m
from ..core import warp
from ..core.rng import make_sampler
from ..core.types import INF, Ray
from ..emitter.dispatch import _env_radiance
from ..scene.ir import (EMITTER_CONSTANT, EMITTER_DIRECTIONAL,
                        EMITTER_ENVMAP, EMITTER_POINT, Scene)
from ..texture.eval import eval_texture


def _camera_axes(scene: Scene):
    return scene.sensor.to_world[:3, :3], scene.sensor.to_world[:3, 3]


def _tan_half(scene: Scene):
    return torch.tan(torch.deg2rad(scene.sensor.fov_x) * 0.5)


def project_to_film(scene: Scene, p):
    """World point -> (film position (N, 2), camera direction (N, 3),
    valid): the inverse of the pinhole's sample_ray."""
    R, t = _camera_axes(scene)
    w, h = scene.film_w, scene.film_h
    aspect = w / h
    rel = p - t
    cam = rel @ R            # world -> camera (R orthonormal)
    z = cam[..., 2]
    valid = z > 1e-6
    tan_half = _tan_half(scene)
    zc = torch.clamp(z, min=1e-6)
    xn = cam[..., 0] / zc / tan_half
    yn = cam[..., 1] / zc / (tan_half / aspect)
    fx = (1.0 - xn) * 0.5 * w
    fy = (1.0 - yn) * 0.5 * h
    valid = valid & (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
    return torch.stack([fx, fy], -1), m.normalize(rel), valid


def _importance(scene: Scene, d_world):
    """Pinhole importance We = 1 / (A cos^3 theta), A the film rectangle's
    area on the z = 1 plane."""
    R, _ = _camera_axes(scene)
    cos_t = torch.clamp(torch.sum(d_world * R[:, 2], -1), 1e-6, 1.0)
    aspect = scene.film_w / scene.film_h
    tan_half = _tan_half(scene)
    area = (2.0 * tan_half) * (2.0 * tan_half / aspect)
    return 1.0 / (area * cos_t ** 3)


def _sample_emitter_ray(scene: Scene, sampler):
    """Emit a light path -> (position, direction, power / pdf, normal,
    sampler)."""
    em = scene.emitters
    u_sel, sampler = sampler.next_1d()
    eidx, _, sel_pdf = em.distr.sample_reuse(u_sel)
    etype = em.etype[eidx]
    prm = em.params[eidx]
    u_pos, sampler = sampler.next_2d()
    u_dir, sampler = sampler.next_2d()

    # ---- area: a triangle of the shape drawn uniformly by index, a
    # uniform point on it, a cosine direction
    shape = torch.clamp(em.shape[eidx], min=0)
    off = scene.shape_prim_offset[shape]
    cnt = torch.clamp(scene.shape_prim_count[shape], min=1)
    u_tri, sampler = sampler.next_1d()
    tri = off + torch.minimum((u_tri * cnt).to(torch.int64), cnt - 1)
    tri = torch.clamp(tri, 0, scene.faces.shape[0] - 1)
    f = scene.faces[tri]
    v0 = scene.vertices[f[:, 0]]
    v1 = scene.vertices[f[:, 1]]
    v2 = scene.vertices[f[:, 2]]
    su = m.sqrt(torch.clamp(u_pos[:, 0], min=1e-12))
    b0 = 1.0 - su
    b1 = u_pos[:, 1] * su
    b2 = 1.0 - b0 - b1
    p_area = v0 * b0[:, None] + v1 * b1[:, None] + v2 * b2[:, None]
    n_area = m.normalize(m.cross(v1 - v0, v2 - v0))
    wo_l = warp.square_to_cosine_hemisphere(u_dir)
    fr = m.make_frame(n_area)
    d_area = wo_l[:, 0:1] * fr.s + wo_l[:, 1:2] * fr.t \
        + wo_l[:, 2:3] * n_area
    area = torch.clamp(scene.shape_area[shape], min=1e-12)
    # radiance: the tex0 texture where set, else params[0:3]; the corner
    # uvs are the interaction rows' (tri_si[:, 18:24])
    uvs = scene.tri_si[tri, 18:24]
    uv = uvs[:, 0:2] * b0[:, None] + uvs[:, 2:4] * b1[:, None] \
        + uvs[:, 4:6] * b2[:, None]
    tex0 = em.tex0[eidx]
    rad = torch.where((tex0 >= 0)[:, None],
                      eval_texture(scene.textures, tex0, uv), prm[:, 0:3])
    # power / (pdf_pos pdf_dir) = L cos / (1/A cos/pi) = L A pi
    w_area = rad * (area * math.pi)[:, None]

    # ---- point: isotropic intensity (p0:3 position, p3:6 intensity)
    d_point = warp.square_to_uniform_sphere(u_dir)
    is_point = (etype == EMITTER_POINT)[:, None]
    p0 = torch.where(is_point, prm[:, 0:3], p_area)
    d0 = torch.where(is_point, d_point, d_area)
    w0 = torch.where(is_point, prm[:, 3:6] * (4.0 * math.pi), w_area)

    # ---- the infinite family: an incoming direction, then a point on the
    # scene bounding sphere's disk perpendicular to it
    tp = set(em.types_present)
    inf_types = tp & {EMITTER_CONSTANT, EMITTER_ENVMAP, EMITTER_DIRECTIONAL}
    if inf_types:
        V = scene.vertices
        c = 0.5 * (V.amin(0) + V.amax(0))
        radius = torch.clamp(m.sqrt(torch.sum((V - c) ** 2, -1)).amax(),
                             min=1e-3)
        u_disk, sampler = sampler.next_2d()
        dd = -d_point                                 # toward the emitter
        w_inf = prm[:, 0:3] * (4.0 * math.pi)         # constant: L 4 pi
        if EMITTER_ENVMAP in tp:
            pos_lm, cell_pdf = em.env_distr.sample(u_dir)
            gh, gw = em.env_distr.data.shape
            phi = pos_lm[..., 0] / gw * (2 * math.pi)
            theta = pos_lm[..., 1] / gh * math.pi
            s_t = torch.sin(theta)
            d_loc = torch.stack([s_t * torch.sin(phi), torch.cos(theta),
                                 -s_t * torch.cos(phi)], -1)
            tw = m.table_lookup(em.to_world, eidx)
            dd_env = torch.einsum("nij,nj->ni", tw[:, :3, :3], d_loc)
            pdf_env = cell_pdf * (gh * gw) \
                / (2.0 * math.pi * math.pi * torch.clamp(s_t, min=1e-6))
            rad_env = _env_radiance(scene, eidx, dd_env)
            sel_env = (etype == EMITTER_ENVMAP)[:, None]
            dd = torch.where(sel_env, dd_env, dd)
            w_inf = torch.where(
                sel_env, rad_env / torch.clamp(pdf_env, min=1e-12)[:, None],
                w_inf)
        if EMITTER_DIRECTIONAL in tp:
            sel_dir = (etype == EMITTER_DIRECTIONAL)[:, None]
            dd = torch.where(sel_dir, -prm[:, 0:3], dd)
            w_inf = torch.where(sel_dir, prm[:, 3:6], w_inf)
        fr_d = m.make_frame(dd)
        dk = warp.square_to_uniform_disk_concentric(u_disk) * radius
        p_inf = c[None, :] + dd * (1.5 * radius) \
            + dk[:, 0:1] * fr_d.s + dk[:, 1:2] * fr_d.t
        w_inf = w_inf * (math.pi * radius * radius)
        is_inf = torch.zeros_like(etype, dtype=torch.bool)
        for it in inf_types:
            is_inf = is_inf | (etype == it)
        is_inf = is_inf[:, None]
        p0 = torch.where(is_inf, p_inf, p0)
        d0 = torch.where(is_inf, -dd, d0)
        w0 = torch.where(is_inf, w_inf, w0)

    w0 = w0 / torch.clamp(sel_pdf, min=1e-12)[:, None]
    n0 = torch.where(is_point, d0, n_area)
    return p0, d0, w0, n0, sampler


def _connect(scene: Scene, acc, p_v, contrib_v, valid):
    """Splat each vertex's contribution, seen through the pinhole, into
    the pixel it projects to (floored, unfiltered) when the connection
    is unoccluded."""
    w, h = scene.film_w, scene.film_h
    pos, _, on_film = project_to_film(scene, p_v)
    _, t = _camera_axes(scene)
    dvec = t - p_v
    dist = m.norm(dvec)
    d_to_cam = dvec / torch.clamp(dist, min=1e-9)[:, None]
    eps = (1.0 + torch.amax(torch.abs(p_v), -1)) * 1e-4
    occ = ray_test(scene, Ray(o=p_v + d_to_cam * eps[:, None], d=d_to_cam,
                              maxt=dist - 2 * eps))
    gw = _importance(scene, -d_to_cam) / torch.clamp(dist * dist, min=1e-9)
    ok = valid & on_film & ~occ
    val = torch.where(ok[:, None], contrib_v * gw[:, None], 0.0)
    px = torch.clamp(pos[:, 0].to(torch.int64), 0, w - 1)
    py = torch.clamp(pos[:, 1].to(torch.int64), 0, h - 1)
    return acc.index_add_(0, py * w + px, val)


@torch.no_grad()
def render_ptracer(scene: Scene, spp: int | None = None, seed: int = 0):
    """Light-trace the scene -> (h, w, 3) on the scene's device: w * h *
    max(1, spp // 4) light paths (each splats many pixels), scaled by
    w * h / paths."""
    spp = spp or scene.spp
    w, h = scene.film_w, scene.film_h
    n = w * h * max(1, spp // 4)
    lane = torch.arange(n, device=scene.device)
    sampler = make_sampler(lane, 0, seed)
    p, d, weight, _, sampler = _sample_emitter_ray(scene, sampler)
    acc = torch.zeros((h * w, 3), device=scene.device)
    _, cam_t = _camera_axes(scene)
    active = torch.ones((n,), dtype=torch.bool, device=scene.device)
    maxt = p.new_full((n,), INF)
    for depth in range(scene.max_depth):
        si = ray_intersect(scene, Ray(o=p + d * 1e-4, d=d, maxt=maxt))
        active = active & si.valid
        bidx = m.table_lookup(scene.shape_bsdf, torch.clamp(si.shape, min=0))
        # connect the surface vertex to the camera through the BSDF
        d_cam = m.normalize(cam_t - si.p)
        bval, _ = bsdf_eval_pdf(scene, si, bidx, si.to_local(d_cam))
        acc = _connect(scene, acc, si.p, weight * bval, active)
        # continue the light path
        u1, sampler = sampler.next_1d()
        u2, sampler = sampler.next_2d()
        bs = bsdf_sample(scene, si, bidx, u1, u2)
        weight = weight * bs.weight
        urr, sampler = sampler.next_1d()
        q = torch.clamp(torch.amax(weight, -1), max=0.95)
        keep = (urr < q) | (depth < scene.rr_depth)
        if depth >= scene.rr_depth:
            weight = weight / torch.clamp(q, min=1e-8)[:, None]
        active = active & (bs.pdf > 0) & keep \
            & (depth + 1 < scene.max_depth)
        p, d = si.p, si.to_world(bs.wo)
    return acc.view(h, w, 3) * ((w * h) / n)
