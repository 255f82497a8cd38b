"""BSDF sampling and evaluation over the wavefront (counterpart of
liverrenderer_tpu/bsdf/dispatch.py), for the families ported so far: the
diffuse BSDF, the smooth dielectric and the null BSDF.

Conventions: directions in the local shading frame, wi points away from
the surface, `eval` returns f(wi, wo) * |cos_theta_o| (zero for delta
lobes), `sample` returns weight = f * |cos| / pdf and the discrete lobe
probability as the pdf of a delta lobe; twosided flips the frame when
cos_theta(wi) < 0.  The blend and mask wrappers are not ported.
"""
from __future__ import annotations

import torch

from ..core import fresnel as fr
from ..core import math as m
from ..core import warp
from ..core.types import BSDFSample
from ..errors import not_ported
from ..scene.ir import (BSDF_DIELECTRIC, BSDF_DIFFUSE, BSDF_NULL,
                        F_DELTA_REFL, F_DELTA_TRANS, F_DIFFUSE_REFL, F_NULL,
                        Scene)
from ..texture.eval import eval_texture


def _flip_z(v):
    return torch.stack([v[..., 0], v[..., 1], -v[..., 2]], -1)


def _sanitize_dir(v):
    """Replace non-finite / degenerate direction rows with +z."""
    ok = torch.isfinite(v).all(-1) & (torch.sum(v * v, -1) > 0.25)
    return torch.where(ok[..., None],
                       torch.where(torch.isfinite(v), v, 0.0),
                       v.new_tensor([0.0, 0.0, 1.0]))


def _diffuse_sample(wi, u1, u2, p, t0, t1):
    wo = warp.square_to_cosine_hemisphere(u2)
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    active = m.cos_theta(wi) > 0
    weight = torch.where(active[..., None], t0, 0.0)
    pdf = torch.where(active, pdf, 0.0)
    n = pdf.shape
    return wo, pdf, weight, wi.new_ones(n), \
        torch.full(n, F_DIFFUSE_REFL, dtype=torch.int64, device=wi.device)


def _diffuse_eval(wi, wo, p, t0, t1):
    ci = m.cos_theta(wi)
    co = m.cos_theta(wo)
    act = (ci > 0) & (co > 0)
    val = t0 * (warp.INV_PI * co)[..., None]
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    return torch.where(act[..., None], val, 0.0), torch.where(act, pdf, 0.0)


def _dielectric_sample(wi, u1, u2, p, t0, t1):
    """Smooth dielectric (src/bsdfs/dielectric.cpp)."""
    eta = p[..., 0]
    ci = m.cos_theta(wi)
    F, ctt, eta_it, eta_ti = fr.fresnel_dielectric(ci, eta)
    refl = u1 <= F
    wo = torch.where(refl[..., None], m.reflect(wi),
                     m.refract_local(wi, ctt, eta_ti))
    pdf = torch.where(refl, F, 1.0 - F)
    # radiance scale on refraction (solid-angle compression)
    weight = torch.where(refl[..., None], t0,
                         t1 * (eta_ti * eta_ti)[..., None])
    eta_s = torch.where(refl, 1.0, eta_it)
    st = torch.where(refl, F_DELTA_REFL, F_DELTA_TRANS)
    return wo, pdf, weight, eta_s, st


def _null_sample(wi, u1, u2, p, t0, t1):
    n = wi.shape[:-1]
    return -wi, wi.new_ones(n), wi.new_ones(n + (3,)), wi.new_ones(n), \
        torch.full(n, F_NULL, dtype=torch.int64, device=wi.device)


_SAMPLERS = {
    BSDF_DIFFUSE: _diffuse_sample,
    BSDF_DIELECTRIC: _dielectric_sample,
    BSDF_NULL: _null_sample,
}

# families with a non-delta lobe; the others evaluate to zero
_EVALS = {
    BSDF_DIFFUSE: _diffuse_eval,
}


def _check_types(b):
    bad = [t for t in b.types_present if t not in _SAMPLERS]
    if bad:
        raise not_ported(f"BSDF type codes {bad}", "Queue 1 M5")


def bsdf_sample(scene: Scene, si, bsdf_idx, u1, u2) -> BSDFSample:
    """Sample the BSDF at each lane; returns a local-frame wo."""
    b = scene.bsdfs
    _check_types(b)
    idx = torch.clamp(bsdf_idx, min=0)
    btype = b.btype[idx]
    wi = _sanitize_dir(si.wi)
    flip = b.twosided[idx] & (m.cos_theta(wi) < 0)
    wi_f = torch.where(flip[..., None], _flip_z(wi), wi)
    p = m.table_lookup(b.params, idx)
    t0 = eval_texture(scene.textures, b.tex0[idx], si.uv, b.tex0_types)
    t1 = eval_texture(scene.textures, b.tex1[idx], si.uv, b.tex1_types)

    n = wi.shape[:-1]
    wo = torch.broadcast_to(wi.new_tensor([0.0, 0.0, 1.0]), wi.shape)
    pdf = wi.new_zeros(n)
    weight = wi.new_zeros(n + (3,))
    eta = wi.new_ones(n)
    st = torch.zeros(n, dtype=torch.int64, device=wi.device)
    for ftype in b.types_present:
        fwo, fpdf, fw, feta, fst = _SAMPLERS[ftype](wi_f, u1, u2, p, t0, t1)
        sel = btype == ftype
        wo = torch.where(sel[..., None], fwo, wo)
        pdf = torch.where(sel, fpdf, pdf)
        weight = torch.where(sel[..., None], fw, weight)
        eta = torch.where(sel, feta, eta)
        st = torch.where(sel, fst, st)
    wo = torch.where(flip[..., None], _flip_z(wo), wo)
    return BSDFSample(wo=wo, pdf=pdf, eta=eta, sampled_type=st,
                      weight=weight)


def bsdf_eval_pdf(scene: Scene, si, bsdf_idx, wo):
    """(f * |cos_theta_o|, pdf) of each lane's BSDF for a local-frame wo;
    delta lobes evaluate to zero."""
    b = scene.bsdfs
    _check_types(b)
    idx = torch.clamp(bsdf_idx, min=0)
    btype = b.btype[idx]
    wi = _sanitize_dir(si.wi)
    wo = _sanitize_dir(wo)
    flip = b.twosided[idx] & (m.cos_theta(wi) < 0)
    wi_f = torch.where(flip[..., None], _flip_z(wi), wi)
    wo_f = torch.where(flip[..., None], _flip_z(wo), wo)
    p = m.table_lookup(b.params, idx)
    t0 = eval_texture(scene.textures, b.tex0[idx], si.uv, b.tex0_types)
    t1 = eval_texture(scene.textures, b.tex1[idx], si.uv, b.tex1_types)
    n = wi.shape[:-1]
    val = wi.new_zeros(n + (3,))
    pdf = wi.new_zeros(n)
    for ftype in b.types_present:
        if ftype not in _EVALS:
            continue
        fv, fp = _EVALS[ftype](wi_f, wo_f, p, t0, t1)
        sel = btype == ftype
        val = torch.where(sel[..., None], fv, val)
        pdf = torch.where(sel, fp, pdf)
    return val, pdf


def eval_null_transmission(scene: Scene, si, bsdf_idx):
    """Transmission of a straight shadow ray through the hit surface: 1 for
    the null BSDF, 0 for the others."""
    _check_types(scene.bsdfs)
    btype = scene.bsdfs.btype[torch.clamp(bsdf_idx, min=0)]
    out = si.uv.new_zeros(si.uv.shape[:-1] + (3,))
    if BSDF_NULL in scene.bsdfs.types_present:
        out = torch.where((btype == BSDF_NULL)[..., None], 1.0, out)
    return out
