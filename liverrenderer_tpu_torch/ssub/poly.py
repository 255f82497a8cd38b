"""Degree-3 implicit-polynomial algebra for shape-adaptive subsurface
scattering (counterpart of liverrenderer_tpu/ssub/poly.py).

Coefficient order is the JAX package's and the reference's (degree-major,
x-major within a degree): 1, x, y, z, x2, xy, xz, y2, yz, z2, x3, x2y, x2z,
xy2, xyz, xz2, y3, y2z, yz2, z3.

Written as a few batched tensor operations: the monomial basis and its
closed-form derivatives are gathers of the per-axis powers, and the
coefficient rotation contracts each degree's coefficient tensor with the
rotation once per mode.  (The JAX package unrolls the rotation into ~330
product terms to keep every intermediate a flat lane vector on its TPU;
here that would be ~1,000 elementwise launches per bounce.)  Results equal
the JAX package's within fp32 summation order.
"""
from __future__ import annotations

import math
from itertools import product

import numpy as np
import torch

from ..core.math import sqrt

# (dx, dy, dz) exponents in reference order
EXPONENTS = np.array(
    [(0, 0, 0),
     (1, 0, 0), (0, 1, 0), (0, 0, 1),
     (2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1), (0, 0, 2),
     (3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1), (1, 0, 2),
     (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3)], np.int64)
_INDEX = {tuple(e): m for m, e in enumerate(EXPONENTS.tolist())}


def _rotation_tables():
    """Per degree d = 1..3: (monomials of degree d, one-hot placement of
    each monomial's coefficient on one ordered index tuple (n_d, 3^d), and
    the gather matrix (3^d, n_d) summing every index tuple into the
    monomial whose exponents its index counts give)."""
    tables = []
    for d in (1, 2, 3):
        mono = [m for m, e in enumerate(EXPONENTS.tolist()) if sum(e) == d]
        place = np.zeros((len(mono), 3 ** d), np.float32)
        for r, m in enumerate(mono):
            slots = [ax for ax in range(3) for _ in range(EXPONENTS[m][ax])]
            place[r, np.ravel_multi_index(slots, (3,) * d)] = 1.0
        gather = np.zeros((3 ** d, len(mono)), np.float32)
        for k, tup in enumerate(product(range(3), repeat=d)):
            e = tuple(int(np.sum(np.asarray(tup) == ax)) for ax in range(3))
            gather[k, mono.index(_INDEX[e])] = 1.0
        tables.append((mono, place, gather))
    return tables


_ROT = _rotation_tables()


def _axis_powers(rel):
    """(..., 3) -> (..., 3, 4): 1, x, x*x, x*x*x per axis (the JAX
    package's roundings)."""
    sq = rel * rel
    return torch.stack([torch.ones_like(rel), rel, sq, sq * rel], -1)


def _gather_powers(pw, ex):
    """pw (..., 3, 4), ex (20, 3) exponents -> (..., 20) products
    x^ex * y^ey * z^ez, multiplied left to right."""
    idx = torch.as_tensor(ex, device=pw.device)
    return pw[..., 0, idx[:, 0]] * pw[..., 1, idx[:, 1]] \
        * pw[..., 2, idx[:, 2]]


def _powers(rel):
    """rel (..., 3) -> monomial basis (..., 20) in reference order."""
    return _gather_powers(_axis_powers(rel), EXPONENTS)


def _basis_grad(rel):
    """(..., 20, 3): d monomial / d (x, y, z) in closed form, e.g.
    d(x^2 y)/dx = 2 x y (zero where the exponent is 0)."""
    pw = _axis_powers(rel)
    out = []
    for ax in range(3):
        ex = EXPONENTS.copy()
        coef = ex[:, ax].astype(np.float32)
        ex[:, ax] = np.maximum(ex[:, ax] - 1, 0)
        out.append(torch.as_tensor(coef, device=rel.device)
                   * _gather_powers(pw, ex))
    return torch.stack(out, -1)


def eval_poly(coeffs, rel):
    """coeffs (..., 20), rel (..., 3) scaled relative position -> (...)."""
    return torch.sum(coeffs * _powers(rel), -1)


def eval_poly_grad(coeffs, rel):
    """Gradient of the polynomial with respect to the scaled coordinates:
    (..., 3)."""
    return torch.einsum("...m,...mk->...k", coeffs, _basis_grad(rel))


def onb_duff(n):
    """Duff et al. orthonormal basis: n (..., 3) -> (b1, b2), frame
    (b1, b2, n)."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    b1 = torch.stack([1.0 + sign * n[..., 0] ** 2 * a, sign * b,
                      -sign * n[..., 0]], -1)
    b2 = torch.stack([b, sign + n[..., 1] ** 2 * a, -n[..., 1]], -1)
    return b1, b2


# 1 - exp(-8) with exp rounded to float32 first, as the JAX package's
# float32 jnp.exp rounds it
_ONE_MINUS_E8 = 1.0 - float(np.exp(np.float32(-8.0)))


def effective_albedo(albedo):
    """The similarity-theory effective albedo (sss_particle_tracer.h:365)."""
    return -torch.log(1.0 - albedo * _ONE_MINUS_E8) / 8.0


def kernel_eps(sigma_t, albedo, g, kernel_multiplier=1.0):
    """The fit kernel's epsilon (polynomials.h getKernelEps), per channel:
    tensors of one shape, or floats."""
    sigma_t, albedo, g = (torch.as_tensor(x, dtype=torch.float32)
                          for x in (sigma_t, albedo, g))
    sigma_s = albedo * sigma_t
    sigma_a = sigma_t - sigma_s
    sigma_sp = (1.0 - g) * sigma_s
    sigma_tp = sigma_sp + sigma_a
    alpha_p = sigma_sp / torch.clamp(sigma_tp, min=1e-12)
    eff = effective_albedo(alpha_p)
    val = 0.25 * g + 0.25 * alpha_p + 1.0 * eff
    return kernel_multiplier * 4.0 * val * val \
        / torch.clamp(sigma_tp * sigma_tp, min=1e-12)


def fit_scale(k_eps):
    return 1.0 / sqrt(k_eps)


def rotate_poly(coeffs, S):
    """Coefficients of f'(x) = f(S x): coeffs (..., 20), S (..., 3, 3)
    (columns s, t, n).  Each degree's coefficients are placed on a
    d-index tensor T with sum T[i..] y_i.. = f_d(y), contracted with S on
    every mode, T'[a..] = sum T[i..] S[i, a].., and gathered back by the
    exponents each index tuple counts."""
    out = [coeffs[..., :1]]
    for d, (mono, place, gather) in zip((1, 2, 3), _ROT):
        c = coeffs[..., mono]
        T = (c @ torch.as_tensor(place, device=c.device)).reshape(
            c.shape[:-1] + (3,) * d)
        if d == 1:
            T = torch.einsum("...i,...ia->...a", T, S)
        elif d == 2:
            T = torch.einsum("...ij,...ia,...jb->...ab", T, S, S)
        else:
            T = torch.einsum("...ijk,...ia,...jb,...kc->...abc", T, S, S, S)
        out.append(T.reshape(c.shape[:-1] + (3 ** d,))
                   @ torch.as_tensor(gather, device=c.device))
    return torch.cat(out, -1)


def fit_polynomials(query_p, cons_p, cons_n, k_eps, regularization=1e-4):
    """Degree-3 implicit polynomials fitted around each query point by
    weighted least squares (fitPolynomialsImpl), batched.

    query_p (V, 3); cons_p / cons_n (V, K, 3) the K nearest constraint
    positions and outward normals of each; k_eps (V,).  Returns (V, 20)
    coefficients in scaled relative coordinates rel = (x - query_p) *
    fit_scale(k_eps), with coeff[0] = 0 (the hard surface constraint)."""
    V, K, _ = cons_p.shape
    scale = fit_scale(k_eps)
    diff = cons_p - query_p[:, None, :]
    rel = diff * scale[:, None, None]
    d2 = torch.sum(diff ** 2, -1)
    w = sqrt(torch.exp(-d2 / (2.0 * k_eps[:, None]))) / math.sqrt(K)
    w = torch.clamp(w, min=1e-6)
    basis = _powers(rel)                               # (V, K, 20)
    gbasis = _basis_grad(rel)                          # (V, K, 20, 3)
    # rows: the value constraints (= 0), then the gradient constraints
    # (= the normals) per axis; the constant column is dropped
    A = torch.cat([basis * w[..., None]]
                  + [gbasis[..., ax] * w[..., None] for ax in range(3)],
                  1)[..., 1:]                          # (V, 4K, 19)
    b = torch.cat([torch.zeros_like(w)]
                  + [cons_n[..., ax] * w for ax in range(3)], 1)
    AtA = torch.einsum("vki,vkj->vij", A, A)
    # no regularisation of the linear terms
    reg = torch.full((19,), regularization, device=A.device)
    reg[:3] = 0.0
    Atb = torch.einsum("vki,vk->vi", A, b)
    sol = torch.linalg.solve(AtA + torch.diag(reg), Atb[..., None])[..., 0]
    return torch.cat([torch.zeros_like(sol[:, :1]), sol], -1)


def poly_normal_and_adjusted_dir(coeffs, in_dir, sh_n):
    """adjustRayDirForPolynomialTracing: the polynomial's normal at the
    vertex (its linear coefficients) and in_dir rotated by the rotation
    taking sh_n to it (Rodrigues)."""
    g = coeffs[..., 1:4]
    pn = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True),
                         min=1e-12)
    axis = torch.linalg.cross(sh_n, pn, dim=-1)
    s = torch.linalg.norm(axis, dim=-1)
    parallel = s < 1e-8
    axis = axis / torch.clamp(s, min=1e-12)[..., None]
    c = torch.clamp(torch.sum(pn * sh_n, -1), -1.0, 1.0)
    sin_t = sqrt(torch.clamp(1.0 - c * c, min=0.0))
    d = in_dir
    rot = d * c[..., None] + torch.linalg.cross(axis, d, dim=-1) \
        * sin_t[..., None] \
        + axis * torch.sum(axis * d, -1, keepdim=True) * (1.0 - c[..., None])
    return pn, torch.where(parallel[..., None], d, rot)
