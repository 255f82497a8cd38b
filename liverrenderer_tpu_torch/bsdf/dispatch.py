"""BSDF sampling over the wavefront (counterpart of
liverrenderer_tpu/bsdf/dispatch.py), for the families of the liver slice:
the smooth dielectric and the null BSDF.

Conventions: directions in the local shading frame, wi points away from
the surface, `sample` returns weight = f * |cos| / pdf and the discrete
lobe probability as the pdf of a delta lobe; twosided flips the frame when
cos_theta(wi) < 0.
"""
from __future__ import annotations

import torch

from ..core import fresnel as fr
from ..core import math as m
from ..core.types import BSDFSample
from ..errors import not_ported
from ..scene.ir import (BSDF_DIELECTRIC, BSDF_NULL, F_DELTA_REFL,
                        F_DELTA_TRANS, F_NULL, TEX_CONST, Scene, Textures)


def eval_texture(tex: Textures, tex_idx, types=None):
    """(N,3) linear RGB of texture tex_idx (-1 => white); constant
    textures only in this slice."""
    present = tex.types_present if types is None \
        else tuple(set(tex.types_present) & set(types))
    if any(t != TEX_CONST for t in present):
        raise not_ported("bitmap / procedural textures", "Queue 1 M5")
    idx = torch.clamp(tex_idx, min=0)
    out = torch.where((tex.ttype[idx] == TEX_CONST)[:, None],
                      tex.data[idx, 0:3], 1.0)
    return torch.where((tex_idx >= 0)[:, None], out, 1.0)


def _flip_z(v):
    return torch.stack([v[..., 0], v[..., 1], -v[..., 2]], -1)


def _sanitize_dir(v):
    """Replace non-finite / degenerate direction rows with +z."""
    ok = torch.isfinite(v).all(-1) & (torch.sum(v * v, -1) > 0.25)
    return torch.where(ok[..., None],
                       torch.where(torch.isfinite(v), v, 0.0),
                       v.new_tensor([0.0, 0.0, 1.0]))


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
    BSDF_DIELECTRIC: _dielectric_sample,
    BSDF_NULL: _null_sample,
}


def bsdf_sample(scene: Scene, si, bsdf_idx, u1, u2) -> BSDFSample:
    """Sample the BSDF at each lane; returns a local-frame wo."""
    b = scene.bsdfs
    bad = [t for t in b.types_present if t not in _SAMPLERS]
    if bad:
        raise not_ported(f"BSDF type codes {bad}", "Queue 1 M5")
    idx = torch.clamp(bsdf_idx, min=0)
    btype = b.btype[idx]
    wi = _sanitize_dir(si.wi)
    flip = b.twosided[idx] & (m.cos_theta(wi) < 0)
    wi_f = torch.where(flip[..., None], _flip_z(wi), wi)
    p = b.params[idx]
    t0 = eval_texture(scene.textures, b.tex0[idx], b.tex0_types)
    t1 = eval_texture(scene.textures, b.tex1[idx], b.tex1_types)

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
