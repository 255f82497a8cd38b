"""Guiding distributions for projective (boundary) sampling (counterpart of
liverrenderer_tpu/integrators/guiding.py; the reference's
python/ad/guiding.py).

* `GridDistr`: the regular-grid distribution over U^3, a categorical over
  flattened cells plus a uniform jitter inside the chosen cell, with the
  reference's mass clamp (`clamp_mass_thres`) and power transform
  (`scale_mass`).
* `edge_guided_weights`: a pilot round's per-sample |contribution|
  scatter-added onto its silhouette edge and blended defensively with the
  uniform length measure, as the main round's categorical edge weights.
* `OcSpaceDistr` / `octree_from_samples`: the adaptive octree over U^3,
  built on the host by numpy recursion from pilot samples and flattened to
  a leaf-box table, so drawing from it is one categorical pick plus a
  uniform jitter inside the leaf.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

Tensor = torch.Tensor


@dataclass
class GridDistr:
    """Regular-grid guiding distribution over U^3."""
    cdf: Tensor         # (num_cells,) inclusive cumsum of the cell masses
    pmf: Tensor         # (num_cells,) normalized cell masses
    res: tuple          # (nx, ny, nz)


def grid_from_mass(mass: Tensor, res: tuple, clamp_mass_thres: float = 0.0,
                   scale_mass: float = 0.0) -> GridDistr:
    """A GridDistr from per-cell mass (guiding.py set_mass): cells below
    `clamp_mass_thres` are zeroed, `scale_mass` > 0 raises the mass to
    that power; an all-zero mass falls back to uniform."""
    m = torch.abs(torch.as_tensor(mass, dtype=torch.float32).reshape(-1))
    if clamp_mass_thres > 0.0:
        m = torch.where(m < clamp_mass_thres, 0.0, m)
    if scale_mass > 0.0:
        m = torch.pow(torch.clamp(m, min=0.0), scale_mass)
    total = torch.sum(m)
    pmf = torch.where(total > 0.0, m / torch.clamp(total, min=1e-30),
                      1.0 / m.shape[0])
    return GridDistr(cdf=torch.cumsum(pmf, 0), pmf=pmf, res=tuple(res))


def grid_sample(distr: GridDistr, u: Tensor):
    """Points in U^3 from u (N, 4) uniforms: u[:, 0] picks the cell,
    u[:, 1:4] jitters inside it -> (points (N, 3), rcp_density (N,))."""
    nx, ny, nz = distr.res
    n_cells = nx * ny * nz
    idx = torch.searchsorted(distr.cdf, u[:, 0].contiguous(), right=True)
    idx = torch.clamp(idx, 0, n_cells - 1)
    iz = idx % nz
    iy = (idx // nz) % ny
    ix = idx // (ny * nz)
    cell = torch.stack([ix, iy, iz], -1).to(torch.float32)
    delta = u.new_tensor([1.0 / nx, 1.0 / ny, 1.0 / nz])
    p = (cell + u[:, 1:4]) * delta
    dens = distr.pmf[idx] * n_cells             # pmf / cell volume
    rcp = torch.where(dens > 0.0, 1.0 / torch.clamp(dens, min=1e-30), 0.0)
    return p, rcp


def grid_cell_of(distr: GridDistr, p: Tensor) -> Tensor:
    """U^3 point -> flat cell index."""
    nx, ny, nz = distr.res
    ix = torch.clamp((p[..., 0] * nx).to(torch.int32), 0, nx - 1)
    iy = torch.clamp((p[..., 1] * ny).to(torch.int32), 0, ny - 1)
    iz = torch.clamp((p[..., 2] * nz).to(torch.int32), 0, nz - 1)
    return (ix * ny + iy) * nz + iz


def edge_guided_weights(abs_contrib: Tensor, e_idx: Tensor, base_wgt: Tensor,
                        uniform_frac: float = 0.25) -> Tensor:
    """(E,) categorical edge weights from a pilot round: abs_contrib (P,)
    the pilot samples' |contribution|, e_idx (P,) their edges, base_wgt
    (E,) the uniform length measure (0 off the silhouette).  The result is
    (1 - uniform_frac) * mass + uniform_frac * uniform, both restricted to
    the silhouette set, so every silhouette edge stays reachable; a pilot
    that saw nothing gives the uniform measure."""
    mass = torch.zeros_like(base_wgt).index_add(0, e_idx, abs_contrib)
    mass = torch.where(base_wgt > 0.0, mass, 0.0)
    m_tot = torch.sum(mass)
    b_tot = torch.sum(base_wgt)
    f = torch.where(m_tot > 0.0, uniform_frac, 1.0)
    return (1.0 - f) * mass / torch.clamp(m_tot, min=1e-30) \
        + f * base_wgt / torch.clamp(b_tot, min=1e-30)


@dataclass
class OcSpaceDistr:
    """Adaptive octree distribution over the unit cube, as a leaf table.
    A defensive uniform mixture keeps the density positive everywhere."""
    leaf_lo: Tensor     # (L, 3)
    leaf_hi: Tensor     # (L, 3)
    pmf: Tensor         # (L,)
    cdf: Tensor         # (L,)

    def sample(self, u_sel: Tensor, u3: Tensor):
        """u_sel (N,), u3 (N, 3) -> (points (N, 3), density (N,)), the
        density relative to the uniform measure on U^3."""
        i = torch.clamp(torch.searchsorted(self.cdf, u_sel.contiguous(),
                                           right=True),
                        0, self.pmf.shape[0] - 1)
        lo, hi = self.leaf_lo[i], self.leaf_hi[i]
        p = lo + u3 * (hi - lo)
        vol = torch.prod(hi - lo, -1)
        dens = self.pmf[i] / torch.clamp(vol, min=1e-12)
        return p, dens


def octree_from_samples(points, weights, max_depth: int = 6,
                        min_frac: float = 0.01, min_count: int = 64,
                        uniform_mix: float = 0.25,
                        device=None) -> OcSpaceDistr:
    """An OcSpaceDistr from pilot points (P, 3) in U^3 and their |weights|,
    on `device` (the points' device when they are a tensor, else the CPU).
    A cell splits while it holds at least `min_frac` of the total mass, at
    least `min_count` points and its depth is below max_depth; a leaf's
    pmf is (1 - mix) * mass / total + mix * volume."""
    if device is None:
        device = points.device if isinstance(points, Tensor) else "cpu"
    if isinstance(points, Tensor):
        points = points.detach().cpu().numpy()
    if isinstance(weights, Tensor):
        weights = weights.detach().cpu().numpy()
    pts = np.clip(np.asarray(points, np.float64), 0.0, 1.0 - 1e-9)
    wts = np.abs(np.asarray(weights, np.float64)).reshape(-1)
    total = max(wts.sum(), 1e-30)
    leaves = []

    def rec(lo, hi, idx, depth):
        mass = wts[idx].sum()
        if (depth >= max_depth or mass < min_frac * total
                or idx.size < min_count):
            leaves.append((lo, hi, mass))
            return
        mid = 0.5 * (lo + hi)
        code = ((pts[idx] >= mid) * np.array([1, 2, 4])).sum(-1)
        for c in range(8):
            bits = np.array([c & 1, (c >> 1) & 1, (c >> 2) & 1], bool)
            clo = np.where(bits, mid, lo)
            chi = np.where(bits, hi, mid)
            rec(clo, chi, idx[code == c], depth + 1)

    rec(np.zeros(3), np.ones(3), np.arange(len(pts)), 0)
    lo = np.asarray([l for l, _, _ in leaves], np.float32)
    hi = np.asarray([h for _, h, _ in leaves], np.float32)
    mass = np.asarray([m for _, _, m in leaves], np.float64)
    vol = np.prod(hi - lo, -1).astype(np.float64)
    pmf = (1.0 - uniform_mix) * mass / total + uniform_mix * vol
    pmf = pmf / pmf.sum()

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    return OcSpaceDistr(leaf_lo=put(lo), leaf_hi=put(hi), pmf=put(pmf),
                        cdf=put(np.cumsum(pmf)))
