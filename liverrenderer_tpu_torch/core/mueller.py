"""Mueller calculus for polarized transport (counterpart of
liverrenderer_tpu/core/mueller.py; reference mueller.h).

Stokes vectors are expressed with respect to a basis vector perpendicular
to the propagation direction; `stokes_basis` fixes the canonical basis and
`rotate_mueller_basis` adapts matrices between frames.  Every function is
batched over leading axes and returns (..., 4, 4).  The Fresnel matrix
does its complex arithmetic on (re, im) pairs with the JAX package's
clamps, not on complex tensors, so that both packages round alike.
"""
from __future__ import annotations

import torch

from . import math as m


def _mat(rows):
    """(..., 4, 4) from four rows of four broadcastable tensors."""
    return torch.stack([torch.stack(torch.broadcast_tensors(*r), -1)
                        for r in rows], -2)


def depolarizer(v=1.0):
    """Depolarizing matrix with transmittance v: kills S1..S3."""
    v = torch.as_tensor(v, dtype=torch.float32)
    z = torch.zeros_like(v)
    return _mat([[v, z, z, z], [z, z, z, z], [z, z, z, z], [z, z, z, z]])


def rotator(theta):
    """Stokes rotation: a frame rotation of the basis by theta rotates
    (S1, S2) by 2 theta."""
    c = torch.cos(2.0 * theta)
    s = torch.sin(2.0 * theta)
    o = torch.ones_like(c)
    z = torch.zeros_like(c)
    return _mat([[o, z, z, z], [z, c, s, z], [z, -s, c, z], [z, z, z, o]])


def linear_polarizer(v=1.0):
    """Ideal linear polarizer, transmission axis at 0 deg, transmittance
    v."""
    h = 0.5 * torch.as_tensor(v, dtype=torch.float32)
    z = torch.zeros_like(h)
    return _mat([[h, h, z, z], [h, h, z, z], [z, z, z, z], [z, z, z, z]])


def linear_retarder(phase):
    """Linear retarder, fast axis at 0 deg, phase delay `phase` (pi: half
    wave, pi/2: quarter wave)."""
    c = torch.cos(phase)
    s = torch.sin(phase)
    o = torch.ones_like(c)
    z = torch.zeros_like(c)
    return _mat([[o, z, z, z], [z, o, z, z], [z, z, c, -s], [z, z, s, c]])


def circular_polarizer(left=False, device=None):
    """Ideal right (or left) circular polarizer."""
    sgn = -1.0 if left else 1.0
    h = 0.5
    return torch.tensor([[h, 0, 0, sgn * h], [0, 0, 0, 0], [0, 0, 0, 0],
                         [sgn * h, 0, 0, h]], dtype=torch.float32,
                        device=device)


def specular_reflection_fresnel(cos_theta_i, eta_re, eta_im=None):
    """Mueller matrix of specular reflection in the s/p basis.  A real
    eta is a dielectric, a complex (eta_re, eta_im) a conductor.
    Unnormalized: M[0, 0] is the unpolarized Fresnel reflectance."""
    ci = torch.clamp(torch.abs(cos_theta_i), 1e-6, 1.0)
    si2 = 1.0 - ci * ci
    if eta_im is None:
        eta_im = torch.zeros_like(eta_re)
    e2_re = eta_re * eta_re - eta_im * eta_im
    e2_im = 2.0 * eta_re * eta_im
    # ct = sqrt(eta^2 - sin^2), complex
    a_re = e2_re - si2
    a_im = e2_im
    r = m.sqrt(a_re * a_re + a_im * a_im)
    ct_re = m.sqrt(torch.clamp((r + a_re) * 0.5, min=0.0))
    ct_im = torch.sign(a_im + 1e-30) * m.sqrt(
        torch.clamp((r - a_re) * 0.5, min=0.0))

    def cdiv(nre, nim, dre, dim):
        d = torch.clamp(dre * dre + dim * dim, min=1e-20)
        return (nre * dre + nim * dim) / d, (nim * dre - nre * dim) / d

    # rs = (ci - ct) / (ci + ct), rp = (eta^2 ci - ct) / (eta^2 ci + ct)
    rs_re, rs_im = cdiv(ci - ct_re, -ct_im, ci + ct_re, ct_im)
    rp_re, rp_im = cdiv(e2_re * ci - ct_re, e2_im * ci - ct_im,
                        e2_re * ci + ct_re, e2_im * ci + ct_im)
    Rs = rs_re * rs_re + rs_im * rs_im
    Rp = rp_re * rp_re + rp_im * rp_im
    # relative phase: rs * conj(rp)
    cr_re = rs_re * rp_re + rs_im * rp_im
    cr_im = rs_im * rp_re - rs_re * rp_im
    amp = m.sqrt(torch.clamp(Rs * Rp, min=0.0))
    nrm = torch.clamp(m.sqrt(cr_re * cr_re + cr_im * cr_im), min=1e-20)
    cosd = cr_re / nrm
    sind = cr_im / nrm

    A = 0.5 * (Rs + Rp)
    B = 0.5 * (Rs - Rp)
    C = amp * cosd
    S = amp * sind
    z = torch.zeros_like(A)
    return _mat([[A, B, z, z], [B, A, z, z], [z, z, C, S], [z, z, -S, C]])


def stokes_basis(d):
    """Canonical Stokes basis vector for propagation direction d: the
    first axis of the Duff orthonormal basis."""
    return m.coordinate_system(d)[0]


def rotation_angle(d, b_from, b_to):
    """Signed angle rotating basis b_from onto b_to about direction d."""
    s = torch.sum(m.cross(b_from, b_to) * d, -1)
    c = torch.sum(b_from * b_to, -1)
    return torch.atan2(s, c)


def rotate_mueller_basis(M, in_d, in_basis_cur, in_basis_tgt,
                         out_d, out_basis_cur, out_basis_tgt):
    """Express M (defined for input basis in_basis_tgt and output basis
    out_basis_tgt) as acting on Stokes vectors in in_basis_cur /
    out_basis_cur."""
    R_in = rotator(rotation_angle(in_d, in_basis_cur, in_basis_tgt))
    R_out = rotator(rotation_angle(out_d, out_basis_tgt, out_basis_cur))
    return R_out @ M @ R_in
