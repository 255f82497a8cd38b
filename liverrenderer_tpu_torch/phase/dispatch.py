"""Phase function sampling/eval (counterpart of
liverrenderer_tpu/phase/dispatch.py; reference src/phase/{isotropic,hg,
rayleigh,blendphase,tabphase,sggx}.cpp), dispatched per lane by the
medium's phase type code.

Directions follow the propagation convention: the sampled direction is
measured around the forward axis (the continuation of the ray), so HG with
g > 0 is forward-scattering.

The extended phases read their parameters from the medium row: blendphase
(weight, child types, child g's) at [11:16]; tabphase a 32-bin
piecewise-constant density over cos_theta at [16:48]; sggx the six S
entries at [16:22] (a specular microflake, reflected off a sampled visible
normal).  isotropic, hg, tabphase, sggx and blendphase are sampled with
their own density (weight 1); rayleigh is sampled uniformly over the
sphere and weighted by value / (1 / 4pi), as in the JAX package.  Every
phase draws the same two numbers, so the streams of both packages stay
aligned whatever the phase.
"""
from __future__ import annotations

import math

import torch

from ..core import math as m
from ..core import warp
from ..scene.ir import (PHASE_BLEND, PHASE_HG, PHASE_ISOTROPIC,
                        PHASE_RAYLEIGH, PHASE_SGGX, PHASE_TAB, TAB_BINS)

_EXTENDED = (PHASE_BLEND, PHASE_TAB, PHASE_SGGX)


# ---------------------------------------------------------------------------
# SGGX microflake helpers (microflake.h)
# ---------------------------------------------------------------------------

def _s6(s):
    return tuple(s[..., i] for i in range(6))


def _sggx_det(s):
    xx, yy, zz, xy, xz, yz = _s6(s)
    return torch.abs(xx * yy * zz - xx * yz * yz - yy * xz * xz
                     - zz * xy * xy + 2.0 * xy * xz * yz)


def _sggx_ndf(wm, s):
    """D(wm) of the SGGX ellipsoid distribution."""
    xx, yy, zz, xy, xz, yz = _s6(s)
    x, y, z = wm[..., 0], wm[..., 1], wm[..., 2]
    den = x * x * (yy * zz - yz * yz) + y * y * (xx * zz - xz * xz) \
        + z * z * (xx * yy - xy * xy) \
        + 2.0 * (x * y * (xz * yz - zz * xy) + x * z * (xy * yz - yy * xz)
                 + y * z * (xy * xz - xx * yz))
    det = _sggx_det(s)
    return det * m.sqrt(torch.clamp(det, min=0.0)) \
        / torch.clamp(math.pi * den * den, min=1e-20)


def _sggx_sigma(w, s):
    """Projected area sigma(w) = sqrt(w^T S w)."""
    xx, yy, zz, xy, xz, yz = _s6(s)
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    q = x * x * xx + y * y * yy + z * z * zz \
        + 2.0 * (x * y * xy + x * z * xz + y * z * yz)
    return m.sqrt(torch.clamp(q, min=1e-20))


def _sggx_sample_normal(wi, u2, s):
    """A visible microflake normal around wi (world)."""
    frame = m.make_frame(wi)
    xx, yy, zz, xy, xz, yz = _s6(s)

    def sq(a, b):       # a^T S b
        return (a[..., 0] * b[..., 0] * xx + a[..., 1] * b[..., 1] * yy
                + a[..., 2] * b[..., 2] * zz
                + (a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0]) * xy
                + (a[..., 0] * b[..., 2] + a[..., 2] * b[..., 0]) * xz
                + (a[..., 1] * b[..., 2] + a[..., 2] * b[..., 1]) * yz)

    skk = sq(frame.s, frame.s)
    sjj = sq(frame.t, frame.t)
    sii = sq(frame.n, frame.n)
    skj = sq(frame.s, frame.t)
    ski = sq(frame.s, frame.n)
    sji = sq(frame.t, frame.n)
    det = torch.abs(skk * sjj * sii - skk * sji * sji - sjj * ski * ski
                    - sii * skj * skj + 2.0 * skj * ski * sji)
    inv_sqrt_sii = 1.0 / m.sqrt(torch.clamp(sii, min=1e-20))
    tmp = m.sqrt(torch.clamp(sjj * sii - sji * sji, min=1e-20))
    mk_x = m.sqrt(torch.clamp(det, min=0.0)) / tmp
    mj_x = -inv_sqrt_sii * (ski * sji - skj * sii) / tmp
    mj_y = inv_sqrt_sii * tmp

    uvw = warp.square_to_cosine_hemisphere(u2)
    nx = uvw[..., 0] * mk_x + uvw[..., 1] * mj_x \
        + uvw[..., 2] * inv_sqrt_sii * ski
    ny = uvw[..., 1] * mj_y + uvw[..., 2] * inv_sqrt_sii * sji
    nz = uvw[..., 2] * inv_sqrt_sii * sii
    return frame.to_world(m.normalize(torch.stack([nx, ny, nz], -1)))


def _safe_s(prm, ptype):
    """SGGX S entries, the identity on non-sggx lanes: those slots hold
    other media's data, and a non-finite value in an untaken branch would
    reach the reverse pass through torch.where."""
    ident = prm.new_tensor([1.0, 1.0, 1.0, 0.0, 0.0, 0.0])
    return torch.where((ptype == PHASE_SGGX)[..., None], prm[..., 16:22],
                       ident)


# ---------------------------------------------------------------------------
# Tabulated phase helpers
# ---------------------------------------------------------------------------

def _tab_table(prm):
    return torch.clamp(prm[..., 16:16 + TAB_BINS], min=0.0)


def _tab_eval(prm, cos_theta):
    """The piecewise-constant density over cos_theta as a solid-angle pdf
    (a bin's mass over 2pi * dcos, dcos = 2 / BINS)."""
    tab = _tab_table(prm)
    total = torch.sum(tab, -1)
    b = torch.clamp(((cos_theta + 1.0) * 0.5 * TAB_BINS).to(torch.int64),
                    0, TAB_BINS - 1)
    val = torch.gather(tab, -1, b[..., None])[..., 0]
    return val / torch.clamp(total, min=1e-20) * TAB_BINS \
        / (4.0 * math.pi)


def _tab_sample_cos(prm, u):
    """Inverse CDF over the bins, then uniform within the bin.  The bin is
    the count of cdf entries below u * total (the JAX package's rule)."""
    tab = _tab_table(prm)
    cdf = torch.cumsum(tab, -1)
    target = u[..., None] * cdf[..., -1:]
    idx = torch.clamp(torch.sum(cdf < target, -1), 0, TAB_BINS - 1)
    lo = torch.where(
        idx > 0,
        torch.gather(cdf, -1, torch.clamp(idx - 1, min=0)[..., None])[..., 0],
        0.0)
    mass = torch.gather(tab, -1, idx[..., None])[..., 0]
    frac = torch.clamp((target[..., 0] - lo) / torch.clamp(mass, min=1e-20),
                       0.0, 1.0)
    return -1.0 + (idx.to(torch.float32) + frac) * (2.0 / TAB_BINS)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def _blend_children(prm):
    w = torch.clamp(prm[..., 11], 0.0, 1.0)
    return (w, prm[..., 12].to(torch.int64), prm[..., 13],
            prm[..., 14].to(torch.int64), prm[..., 15])


def _basic_eval(ptype, g, cos_theta):
    out = torch.full_like(cos_theta, warp.INV_FOURPI)
    out = torch.where(ptype == PHASE_HG, warp.hg_pdf(cos_theta, g), out)
    ray = (3.0 / (16.0 * math.pi)) * (1.0 + cos_theta * cos_theta)
    return torch.where(ptype == PHASE_RAYLEIGH, ray, out)


def _present(present):
    return set(present) if present is not None else set(_EXTENDED)


def phase_eval(ptype, g, cos_theta, prm=None, fwd=None, wo=None,
               present=None):
    """Phase value (the pdf too for the exactly sampled phases).

    prm: (N, MEDIUM_P) medium rows for the extended phases; fwd and wo the
    world directions sggx needs (it is not a function of cos_theta alone);
    `present`: scene.media.phase_types, which leaves out the branches of
    phases no medium uses."""
    out = _basic_eval(ptype, g, cos_theta)
    if prm is None:
        return out
    present = _present(present)
    if PHASE_BLEND in present:
        w, t1, g1, t2, g2 = _blend_children(prm)
        blend = w * _basic_eval(t1, g1, cos_theta) \
            + (1.0 - w) * _basic_eval(t2, g2, cos_theta)
        out = torch.where(ptype == PHASE_BLEND, blend, out)
    if PHASE_TAB in present:
        out = torch.where(ptype == PHASE_TAB, _tab_eval(prm, cos_theta), out)
    if PHASE_SGGX in present and fwd is not None and wo is not None:
        s = _safe_s(prm, ptype)
        wi_m = -fwd
        h = m.normalize(wi_m + wo)
        sggx = 0.25 * _sggx_ndf(h, s) / _sggx_sigma(wi_m, s)
        out = torch.where(ptype == PHASE_SGGX, sggx, out)
    return out


def phase_sample(ptype, g, fwd, u2, prm=None, present=None):
    """Sample an outgoing direction: ptype, g (N,); fwd (N,3) propagation
    direction; u2 (N,2).  Returns (wo_world, weight, pdf), weight =
    value / pdf."""
    frame = m.make_frame(fwd)
    d_iso = warp.square_to_uniform_sphere(u2)
    d_hg = frame.to_world(warp.square_to_hg(u2, g))
    is_hg = ptype == PHASE_HG
    wo = torch.where(is_hg[..., None], d_hg, d_iso)
    # blendphase's pdf is its mixture pdf, which phase_eval gives
    exact = is_hg | (ptype == PHASE_ISOTROPIC) | (ptype == PHASE_BLEND)
    pres = _present(present)
    if prm is not None and PHASE_BLEND in pres:
        # pick a child with u2[:, 0], rescale it, sample that child
        w, t1, g1, t2, g2 = _blend_children(prm)
        pick1 = u2[..., 0] < w
        u0r = torch.where(pick1,
                          u2[..., 0] / torch.clamp(w, min=1e-9),
                          (u2[..., 0] - w) / torch.clamp(1.0 - w, min=1e-9))
        u2b = torch.stack([torch.clamp(u0r, 0.0, 1.0 - 1e-7), u2[..., 1]],
                          -1)
        tb = torch.where(pick1, t1, t2)
        gb = torch.where(pick1, g1, g2)
        d_hgb = frame.to_world(warp.square_to_hg(u2b, gb))
        d_isob = warp.square_to_uniform_sphere(u2b)
        d_blend = torch.where((tb == PHASE_HG)[..., None], d_hgb, d_isob)
        wo = torch.where((ptype == PHASE_BLEND)[..., None], d_blend, wo)
    if prm is not None and PHASE_TAB in pres:
        ct = _tab_sample_cos(prm, u2[..., 0])
        st = m.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
        phi = 2.0 * math.pi * u2[..., 1]
        d_tab = frame.to_world(torch.stack(
            [st * torch.cos(phi), st * torch.sin(phi), ct], -1))
        wo = torch.where((ptype == PHASE_TAB)[..., None], d_tab, wo)
        exact = exact | (ptype == PHASE_TAB)
    if prm is not None and PHASE_SGGX in pres:
        s = _safe_s(prm, ptype)
        wi_m = -fwd
        nrm = _sggx_sample_normal(wi_m, u2, s)
        d_sggx = m.normalize(2.0 * m.dot(wi_m, nrm)[..., None] * nrm - wi_m)
        wo = torch.where((ptype == PHASE_SGGX)[..., None], d_sggx, wo)
        exact = exact | (ptype == PHASE_SGGX)
    val = phase_eval(ptype, g, m.dot(fwd, wo), prm, fwd, wo, present)
    pdf = torch.where(exact, val, warp.INV_FOURPI)
    weight = torch.where(exact, 1.0, val / warp.INV_FOURPI)
    return wo, weight, pdf
