"""Build-time subsurface preprocessing: the per-vertex polynomial fits
(counterpart of liverrenderer_tpu/ssub/preprocess.py).

Area-uniform constraint samples (position and outward normal) stand in for
the reference's constraint k-d tree; each vertex is fitted to its K nearest
samples, all vertices in one batched least-squares solve.  The samples and
the nearest-sample search are the JAX package's numpy code, so both
packages fit to the same constraints; the solve runs in float32 on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from .poly import fit_polynomials, kernel_eps

N_CONSTRAINT_SAMPLES = 4096
K_NEAREST = 24


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                   seed: int = 7):
    """Area-uniform surface samples -> (pos (n, 3), normal (n, 3)), float32.

    The fit's gradient constraints need outward normals (inside is f < 0):
    the winding is checked globally by the divergence-theorem signed volume
    and flipped when it is negative."""
    rng = np.random.default_rng(seed)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    signed_vol = np.sum(np.einsum("ij,ij->i", v0, np.cross(v1, v2))) / 6.0
    if signed_vol < 0:
        v1, v2 = v2, v1
    fn = np.cross(v1 - v0, v2 - v0)
    area = 0.5 * np.linalg.norm(fn, axis=-1)
    fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    cdf = np.cumsum(area)
    cdf /= cdf[-1]
    tri = np.searchsorted(cdf, rng.random(n))
    u1 = rng.random(n)
    u2 = rng.random(n)
    su1 = np.sqrt(u1)
    b0 = 1.0 - su1
    b1 = u2 * su1
    pos = (v0[tri] * b0[:, None] + v1[tri] * b1[:, None]
           + v2[tri] * (1.0 - b0 - b1)[:, None])
    return pos.astype(np.float32), fn[tri].astype(np.float32)


def nearest_samples(verts: np.ndarray, cons_p: np.ndarray,
                    k: int = K_NEAREST) -> np.ndarray:
    """(V, k) indices of the k nearest constraint samples of each vertex
    (in argpartition's order; the fit does not depend on it)."""
    idx = np.empty((len(verts), k), np.int64)
    chunk = max(1, (1 << 24) // max(len(cons_p), 1))
    for s in range(0, len(verts), chunk):
        e = min(s + chunk, len(verts))
        d2 = np.sum((verts[s:e, None, :] - cons_p[None, :, :]) ** 2, -1)
        idx[s:e] = np.argpartition(d2, k, axis=1)[:, :k]
    return idx


def fit_shape_polys(verts: np.ndarray, faces: np.ndarray,
                    sigma_t: np.ndarray, albedo: np.ndarray, g: float,
                    kernel_eps_scale: float = 1.0) -> np.ndarray:
    """Per-vertex degree-3 fits for one subsurface shape -> (V, 3, 20)
    float32 world-space coefficients, one fit per RGB channel (the kernel
    epsilon depends on the channel's sigma_t and albedo)."""
    cons_p, cons_n = sample_surface(verts, faces, N_CONSTRAINT_SAMPLES)
    idx = nearest_samples(verts, cons_p)
    q = torch.from_numpy(np.ascontiguousarray(verts, np.float32))
    cp = torch.from_numpy(cons_p[idx])
    cn = torch.from_numpy(cons_n[idx])
    out = np.zeros((len(verts), 3, 20), np.float32)
    for c in range(3):
        k = kernel_eps(float(sigma_t[c]), float(albedo[c]), float(g),
                       kernel_eps_scale)
        out[:, c, :] = fit_polynomials(q, cp, cn,
                                       k.expand(len(verts))).numpy()
    return out
