"""Emitter sampling and evaluation over the wavefront (counterpart of
liverrenderer_tpu/emitter/dispatch.py) for the area, point, constant,
envmap, directional, spot and projector emitters: next-event estimation
picks an emitter from the scene's discrete distribution and samples a
direction toward it (the envmap by its 2-D importance map); BSDF-sampled
rays that hit an area emitter evaluate it; escaped rays see the
environment (constant or lat-long envmap).  The point, directional, spot
and projector emitters are delta lights: only NEE reaches them, so their
direction pdf for MIS is 0 and no ray hits them.

Every emitter type present in the scene is evaluated on all lanes and
combined with masked selects, as in the JAX package.
"""
from __future__ import annotations

import math

import torch

from ..core import math as m
from ..core import warp
from ..core.types import DirectionSample
from ..scene.ir import (EMITTER_AREA, EMITTER_CONSTANT, EMITTER_DIRECTIONAL,
                        EMITTER_ENVMAP, EMITTER_POINT, EMITTER_PROJECTOR,
                        EMITTER_SPOT, SHAPE_SPHERE, Scene)
from ..texture.eval import eval_texture

WORLD_RADIUS = 1e4  # distance placed on environment and directional samples

def _sample_shape_position(scene: Scene, shape_idx, u2, u_reuse):
    """Uniform-area sample on an area emitter's shape (mesh triangles or an
    analytic sphere) -> (p, n, pdf_area)."""
    stype = m.table_lookup(scene.shape_type, shape_idx)
    off = m.table_lookup(scene.shape_prim_offset, shape_idx)
    cnt = m.table_lookup(scene.shape_prim_count, shape_idx)
    area = m.table_lookup(scene.shape_area, shape_idx)

    # mesh: pick a triangle in the shape's segment of the global area cdf
    cdf = scene.tri_area_cdf
    base = torch.where(off > 0, cdf[torch.clamp(off - 1, min=0)], 0.0)
    x = base + u_reuse * area
    tri = torch.searchsorted(cdf, x.contiguous())          # side="left"
    tri = torch.minimum(torch.maximum(tri, off),
                        off + torch.clamp(cnt - 1, min=0))
    f = scene.faces[torch.clamp(tri, 0, scene.faces.shape[0] - 1)]
    p0 = scene.vertices[f[:, 0]]
    p1 = scene.vertices[f[:, 1]]
    p2 = scene.vertices[f[:, 2]]
    b = warp.square_to_uniform_triangle(u2)
    w = 1.0 - b[..., 0] - b[..., 1]
    p_mesh = p0 * w[:, None] + p1 * b[..., 0:1] + p2 * b[..., 1:2]
    n_mesh = m.normalize(m.cross(p1 - p0, p2 - p0))

    # sphere: uniform area
    d_sph = warp.square_to_uniform_sphere(u2)
    if scene.n_spheres > 0:
        sp = torch.clamp(off, 0, scene.n_spheres - 1)
        c = m.table_lookup(scene.sph_center, sp)
        r = m.table_lookup(scene.sph_radius, sp)
    else:
        c = torch.zeros_like(p_mesh)
        r = p_mesh.new_ones(p_mesh.shape[:-1])
    p_sph = c + d_sph * r[..., None]

    is_sph = (stype == SHAPE_SPHERE)[:, None]
    p = torch.where(is_sph, p_sph, p_mesh)
    n = torch.where(is_sph, d_sph, n_mesh)
    return p, n, 1.0 / torch.clamp(area, min=1e-20)


def sample_emitter_direction(scene: Scene, ref_p, u2, u1):
    """Pick an emitter (discrete distribution), then sample a direction
    toward it -> (DirectionSample, emitted radiance / pdf).  Occlusion is
    not tested here: the integrator traces its own shadow rays."""
    em = scene.emitters
    n = ref_p.shape[0]
    if em.count == 0:
        z3 = ref_p.new_zeros((n, 3))
        return DirectionSample(
            p=z3, n=z3, d=z3, dist=ref_p.new_zeros(n),
            pdf=ref_p.new_zeros(n),
            delta=torch.zeros(n, dtype=torch.bool, device=ref_p.device),
            emitter=torch.full((n,), -1, dtype=torch.int64,
                               device=ref_p.device)), z3
    eidx, u_sel, sel_pdf = em.distr.sample_reuse(u1)
    etype = m.table_lookup(em.etype, eidx)
    prm = m.table_lookup(em.params, eidx)

    p = ref_p.new_zeros((n, 3))
    nrm = ref_p.new_zeros((n, 3))
    d = ref_p.new_zeros((n, 3))
    dist = ref_p.new_full((n,), WORLD_RADIUS)
    pdf = ref_p.new_zeros(n)
    delta = torch.zeros(n, dtype=torch.bool, device=ref_p.device)
    value = ref_p.new_zeros((n, 3))

    tp = em.types_present
    if EMITTER_AREA in tp:
        sp, sn, pdf_area = _sample_shape_position(
            scene, m.table_lookup(em.shape, eidx), u2, u_sel)
        dvec = sp - ref_p
        dist2 = torch.clamp(torch.sum(dvec * dvec, -1), min=1e-12)
        dist_a = m.sqrt(dist2)
        dd = dvec / dist_a[:, None]
        cos_e = -torch.sum(dd * sn, -1)
        # area density -> solid angle
        pdf_a = pdf_area * dist2 / torch.clamp(cos_e, min=1e-20)
        pdf_a = torch.where(cos_e > 0, pdf_a, 0.0)
        rad = eval_texture(scene.textures, m.table_lookup(em.tex0, eidx),
                           ref_p.new_zeros((n, 2))) * prm[..., 0:3]
        sel = etype == EMITTER_AREA
        p = torch.where(sel[:, None], sp, p)
        nrm = torch.where(sel[:, None], sn, nrm)
        d = torch.where(sel[:, None], dd, d)
        dist = torch.where(sel, dist_a, dist)
        pdf = torch.where(sel, pdf_a, pdf)
        value = torch.where(sel[:, None],
                            torch.where((cos_e > 0)[:, None], rad, 0.0),
                            value)

    if EMITTER_POINT in tp:
        pos = prm[..., 0:3]
        dvec = pos - ref_p
        dist2 = torch.clamp(torch.sum(dvec * dvec, -1), min=1e-12)
        dist_p = m.sqrt(dist2)
        sel = etype == EMITTER_POINT
        p = torch.where(sel[:, None], pos, p)
        d = torch.where(sel[:, None], dvec / dist_p[:, None], d)
        dist = torch.where(sel, dist_p, dist)
        pdf = torch.where(sel, 1.0, pdf)
        delta = delta | sel
        value = torch.where(sel[:, None], prm[..., 3:6] / dist2[:, None],
                            value)

    if EMITTER_CONSTANT in tp:
        dd = warp.square_to_uniform_sphere(u2)
        sel = etype == EMITTER_CONSTANT
        p = torch.where(sel[:, None], ref_p + dd * WORLD_RADIUS, p)
        d = torch.where(sel[:, None], dd, d)
        pdf = torch.where(sel, warp.INV_FOURPI, pdf)
        value = torch.where(sel[:, None], prm[..., 0:3], value)

    if EMITTER_ENVMAP in tp:
        # importance-sample the lat-long map (v = theta, u = phi)
        pos_lm, cell_pdf = em.env_distr.sample(u2)
        h, w = em.env_distr.data.shape
        phi = pos_lm[..., 0] / w * (2 * math.pi)
        theta = pos_lm[..., 1] / h * math.pi
        st = torch.sin(theta)
        d_loc = torch.stack([st * torch.sin(phi), torch.cos(theta),
                             -st * torch.cos(phi)], -1)
        tw = m.table_lookup(em.to_world, eidx)
        dd = torch.einsum("nij,nj->ni", tw[:, :3, :3], d_loc)
        pdf_e = cell_pdf * (h * w) / (2.0 * math.pi * math.pi
                                      * torch.clamp(st, min=1e-6))
        sel = etype == EMITTER_ENVMAP
        p = torch.where(sel[:, None], ref_p + dd * WORLD_RADIUS, p)
        d = torch.where(sel[:, None], dd, d)
        pdf = torch.where(sel, pdf_e, pdf)
        value = torch.where(sel[:, None], _env_radiance(scene, eidx, dd),
                            value)

    if EMITTER_DIRECTIONAL in tp:
        dd = -prm[..., 0:3]
        sel = etype == EMITTER_DIRECTIONAL
        d = torch.where(sel[:, None], dd, d)
        p = torch.where(sel[:, None], ref_p + dd * WORLD_RADIUS, p)
        pdf = torch.where(sel, 1.0, pdf)
        delta = delta | sel
        value = torch.where(sel[:, None], prm[..., 3:6], value)

    if EMITTER_SPOT in tp or EMITTER_PROJECTOR in tp:
        # both sit at prm[0:3] and fall off with the squared distance
        pos = prm[..., 0:3]
        dvec = pos - ref_p
        dist2 = torch.clamp(torch.sum(dvec * dvec, -1), min=1e-12)
        dist_p = m.sqrt(dist2)
        dd = dvec / dist_p[:, None]
        sel = (etype == EMITTER_SPOT) | (etype == EMITTER_PROJECTOR)
        p = torch.where(sel[:, None], pos, p)
        d = torch.where(sel[:, None], dd, d)
        dist = torch.where(sel, dist_p, dist)
        pdf = torch.where(sel, 1.0, pdf)
        delta = delta | sel

    if EMITTER_SPOT in tp:
        # smooth falloff from the beam width (cos prm[7]) to the cutoff
        # (cos prm[6]) around the axis prm[8:11]
        cos_cut, cos_beam = prm[..., 6], prm[..., 7]
        cos_a = -torch.sum(dd * prm[..., 8:11], -1)
        fall = torch.clamp((cos_a - cos_cut)
                           / torch.clamp(cos_beam - cos_cut, min=1e-6),
                           0.0, 1.0)
        value = torch.where((etype == EMITTER_SPOT)[:, None],
                            prm[..., 3:6] * fall[:, None] / dist2[:, None],
                            value)

    if EMITTER_PROJECTOR in tp:
        # the direction projector -> point in the projector's frame, its
        # texture looked up inside the frustum of half-angle tan prm[11]
        tan_half = torch.clamp(prm[..., 11], min=1e-4)
        tw = m.table_lookup(em.to_world, eidx)
        lv = torch.einsum("nji,nj->ni", tw[:, :3, :3], -dd)
        lz = torch.clamp(lv[..., 2], min=1e-6)
        u = 0.5 * (1.0 + lv[..., 0] / (lz * tan_half))
        v = 0.5 * (1.0 + lv[..., 1] / (lz * tan_half))
        inside = (lv[..., 2] > 0) & (u >= 0) & (u <= 1) & (v >= 0) \
            & (v <= 1)
        tex = eval_texture(scene.textures, m.table_lookup(em.tex0, eidx),
                           torch.stack([u, v], -1))
        val_proj = torch.where(inside[:, None],
                               prm[..., 3:6] * tex / dist2[:, None], 0.0)
        value = torch.where((etype == EMITTER_PROJECTOR)[:, None], val_proj,
                            value)

    pdf_total = pdf * sel_pdf
    # detached sampling: the density is not differentiated, the radiance is
    pdf_det = torch.clamp(pdf_total, min=1e-30).detach()
    weight = torch.where((pdf_total > 0)[:, None],
                         value / pdf_det[:, None], 0.0)
    return DirectionSample(p=p, n=nrm, d=d, dist=dist, pdf=pdf_total,
                           delta=delta, emitter=eidx), weight


def pdf_emitter_direction(scene: Scene, ref_p, si_emitter, si_p, si_n, d):
    """Solid-angle density with which NEE from ref_p samples direction d
    toward emitter `si_emitter`, hit at si_p with normal si_n."""
    em = scene.emitters
    if em.count == 0:
        return ref_p.new_zeros(ref_p.shape[:-1])
    eidx = torch.clamp(si_emitter, min=0)
    etype = m.table_lookup(em.etype, eidx)
    sel_pdf = em.distr.eval_pdf(eidx)
    pdf = ref_p.new_zeros(ref_p.shape[:-1])
    tp = em.types_present
    if EMITTER_AREA in tp:
        area = m.table_lookup(
            scene.shape_area,
            torch.clamp(m.table_lookup(em.shape, eidx), min=0))
        dvec = si_p - ref_p
        dist2 = torch.clamp(torch.sum(dvec * dvec, -1), min=1e-12)
        cos_e = torch.abs(torch.sum(d * si_n, -1))
        pdf_a = dist2 / torch.clamp(cos_e * area, min=1e-20)
        pdf = torch.where(etype == EMITTER_AREA, pdf_a, pdf)
    if EMITTER_CONSTANT in tp:
        pdf = torch.where(etype == EMITTER_CONSTANT, warp.INV_FOURPI, pdf)
    if EMITTER_ENVMAP in tp:
        pdf = torch.where(etype == EMITTER_ENVMAP, _env_pdf(scene, eidx, d),
                          pdf)
    return pdf * sel_pdf


def _env_uv(scene: Scene, eidx, d):
    """Lat-long (u, v) of world direction d in the envmap's frame, and
    its polar angle."""
    tw = m.table_lookup(scene.emitters.to_world, eidx)
    d_loc = torch.einsum("nji,nj->ni", tw[:, :3, :3], d)  # inverse rotation
    theta = m.safe_acos(d_loc[..., 1])
    phi = torch.atan2(d_loc[..., 0], -d_loc[..., 2])
    u = phi / (2 * math.pi)
    u = u - torch.floor(u)
    v = theta / math.pi
    return torch.stack([u, v], -1), theta


def _env_radiance(scene: Scene, eidx, d):
    em = scene.emitters
    uv, _ = _env_uv(scene, eidx, d)
    rad = eval_texture(scene.textures, em.tex0[eidx], uv)
    return rad * m.table_lookup(em.params, eidx)[..., 6:7]


def _env_pdf(scene: Scene, eidx, d):
    """Solid-angle density of the envmap's importance sampling."""
    em = scene.emitters
    uv, theta = _env_uv(scene, eidx, d)
    h, w = em.env_distr.data.shape
    col = torch.clamp((uv[..., 0] * w).to(torch.int64), 0, w - 1)
    row = torch.clamp((uv[..., 1] * h).to(torch.int64), 0, h - 1)
    cell_pdf = em.env_distr.eval_pdf(col, row)
    st = torch.clamp(torch.sin(theta), min=1e-6)
    return cell_pdf * (h * w) / (2.0 * math.pi * math.pi * st)


def eval_emitter_hit(scene: Scene, si, d):
    """Radiance of the area emitter attached to the hit shape, seen from
    -d (front side only) -> (radiance, emitter index or -1).  Only area
    emitters attach to shapes: without one the evaluation is elided."""
    em = scene.emitters
    n = si.t.shape[0]
    if em.count == 0 or EMITTER_AREA not in em.types_present:
        return si.p.new_zeros((n, 3)), \
            torch.full((n,), -1, dtype=torch.int64, device=si.p.device)
    shape = torch.clamp(si.shape, min=0)
    eidx = torch.where(si.valid, m.table_lookup(scene.shape_emitter, shape),
                       -1)
    eidx_s = torch.clamp(eidx, min=0)
    rad = eval_texture(scene.textures, em.tex0[eidx_s], si.uv) \
        * m.table_lookup(em.params, eidx_s)[..., 0:3]
    front = torch.sum(si.ng * d, -1) < 0
    return torch.where(((eidx >= 0) & front)[:, None], rad, 0.0), eidx


def eval_environment(scene: Scene, d):
    """Environment radiance for escaped rays (constant or envmap)."""
    em = scene.emitters
    n = d.shape[0]
    if em.env_index < 0:
        return d.new_zeros((n, 3))
    et = em.etype[em.env_index]
    out = torch.broadcast_to(
        torch.where(et == EMITTER_CONSTANT, em.params[em.env_index, 0:3], 0.0),
        (n, 3))
    if EMITTER_ENVMAP in em.types_present:
        eidx = torch.full((n,), em.env_index, dtype=torch.int64,
                          device=d.device)
        out = torch.where(et == EMITTER_ENVMAP,
                          _env_radiance(scene, eidx, d), out)
    return out
