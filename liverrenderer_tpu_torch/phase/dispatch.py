"""Phase function sampling/eval (counterpart of
liverrenderer_tpu/phase/dispatch.py) for the isotropic and Henyey-Greenstein
phases.  Directions follow the propagation convention: HG with g > 0 is
forward-scattering around the continuation of the ray."""
from __future__ import annotations

import torch

from ..core import math as m
from ..core import warp
from ..errors import not_ported
from ..scene.ir import PHASE_HG, PHASE_ISOTROPIC

_PORTED = (PHASE_ISOTROPIC, PHASE_HG)


def _check(present):
    bad = [p for p in (present or ()) if p not in _PORTED]
    if bad:
        raise not_ported(f"phase function codes {bad}", "Queue 1 M10")


def phase_eval(ptype, g, cos_theta, prm=None, fwd=None, wo=None,
               present=None):
    """Phase value (== pdf: both phases are sampled exactly)."""
    _check(present)
    iso = torch.full_like(cos_theta, warp.INV_FOURPI)
    return torch.where(ptype == PHASE_HG, warp.hg_pdf(cos_theta, g), iso)


def phase_sample(ptype, g, fwd, u2, prm=None, present=None):
    """Sample an outgoing direction: ptype, g (N,); fwd (N,3) propagation
    direction.  Returns (wo_world, weight, pdf)."""
    _check(present)
    d_iso = warp.square_to_uniform_sphere(u2)
    frame = m.make_frame(fwd)
    d_hg = frame.to_world(warp.square_to_hg(u2, g))
    is_hg = ptype == PHASE_HG
    wo = torch.where(is_hg[..., None], d_hg, d_iso)
    exact = is_hg | (ptype == PHASE_ISOTROPIC)
    val = phase_eval(ptype, g, m.dot(fwd, wo), prm, fwd, wo, present)
    pdf = torch.where(exact, val, warp.INV_FOURPI)
    weight = torch.where(exact, 1.0, val / warp.INV_FOURPI)
    return wo, weight, pdf
