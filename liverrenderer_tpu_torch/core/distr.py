"""Discrete and piecewise-constant 2-D distributions for emitter selection
and envmap importance sampling (counterpart of
liverrenderer_tpu/core/distr.py).

CDFs are built host-side into dense arrays; sampling is a vectorised
search with numpy's side="right" (torch.searchsorted right=True), as the
JAX package samples them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

Tensor = torch.Tensor


@dataclass
class DiscreteDistribution:
    """Normalized discrete distribution over n entries."""
    cdf: Tensor    # (n,) inclusive cumulative sum, cdf[-1] == total
    pmf: Tensor    # (n,) unnormalized weights
    total: Tensor  # () sum of weights

    @staticmethod
    def build(weights) -> "DiscreteDistribution":
        w = torch.as_tensor(weights, dtype=torch.float32)
        cdf = torch.cumsum(w, 0)
        return DiscreteDistribution(cdf=cdf, pmf=w, total=cdf[-1])

    def to(self, device) -> "DiscreteDistribution":
        return DiscreteDistribution(self.cdf.to(device), self.pmf.to(device),
                                    self.total.to(device))

    def _index(self, x):
        idx = torch.searchsorted(self.cdf, x.contiguous(), right=True)
        return torch.clamp(idx, 0, self.pmf.shape[0] - 1)

    def sample(self, u):
        """u in [0,1) -> (index, pdf)."""
        idx = self._index(u * self.total)
        return idx, self.pmf[idx] / torch.clamp(self.total, min=1e-30)

    def sample_reuse(self, u):
        """Sample and rescale u for reuse -> (index, u', pdf)."""
        x = u * self.total
        idx = self._index(x)
        lo = torch.where(idx > 0, self.cdf[torch.clamp(idx - 1, min=0)], 0.0)
        w = self.pmf[idx]
        u2 = torch.clamp((x - lo) / torch.clamp(w, min=1e-30), 0.0,
                         1.0 - 1e-7)
        return idx, u2, w / torch.clamp(self.total, min=1e-30)

    def eval_pdf(self, idx):
        return self.pmf[idx] / torch.clamp(self.total, min=1e-30)


def build_distribution_2d_np(weights) -> dict:
    """Distribution2D's tables from (h, w) weights, in float32 numpy:
    sequential row cumsums and the cumsum of the row totals (the scene
    builder's form; the JAX package sums with XLA's cumsum, whose order
    differs by a few ulps)."""
    w = np.asarray(weights, np.float32)
    cond = np.cumsum(w, axis=1, dtype=np.float32)
    marg = np.cumsum(cond[:, -1], dtype=np.float32)
    return dict(cond_cdf=cond, marg_cdf=marg, data=w, total=marg[-1])


@dataclass
class Distribution2D:
    """Row-major 2-D piecewise-constant distribution (envmap sampling): a
    marginal CDF over the rows and a conditional CDF along each row."""
    cond_cdf: Tensor   # (h, w) per-row inclusive cumsum
    marg_cdf: Tensor   # (h,) inclusive cumsum of the row totals
    data: Tensor       # (h, w) weights
    total: Tensor      # ()

    @staticmethod
    def build(weights) -> "Distribution2D":
        w = torch.as_tensor(weights, dtype=torch.float32)
        cond = torch.cumsum(w, 1)
        marg = torch.cumsum(cond[:, -1], 0)
        return Distribution2D(cond_cdf=cond, marg_cdf=marg, data=w,
                              total=marg[-1])

    def to(self, device) -> "Distribution2D":
        return Distribution2D(self.cond_cdf.to(device),
                              self.marg_cdf.to(device), self.data.to(device),
                              self.total.to(device))

    def _row_search(self, row, y):
        """searchsorted(cond_cdf[row], y, side="right") per lane, without
        materialising the (N, w) rows: a batched binary search of
        bit_length(w) gather steps over the flat table."""
        w = self.data.shape[1]
        flat = self.cond_cdf.reshape(-1)
        base = row * w
        lo = torch.zeros_like(row)
        hi = torch.full_like(row, w)
        for _ in range(w.bit_length()):
            mid = (lo + hi) >> 1
            go = lo < hi
            right = flat[base + torch.clamp(mid, max=w - 1)] <= y
            lo = torch.where(go & right, mid + 1, lo)
            hi = torch.where(go & ~right, mid, hi)
        return lo

    def sample(self, u2):
        """u2: (N, 2) -> ((col, row) float positions in [0,w)x[0,h), pdf
        of the discrete cell; the density per texel is pdf * h * w)."""
        h, w = self.data.shape
        x = u2[..., 1] * self.total
        row = torch.clamp(torch.searchsorted(self.marg_cdf, x.contiguous(),
                                             right=True), 0, h - 1)
        row_lo = torch.where(row > 0,
                             self.marg_cdf[torch.clamp(row - 1, min=0)], 0.0)
        flat = self.cond_cdf.reshape(-1)
        row_w = flat[row * w + (w - 1)]
        y = u2[..., 0] * row_w
        col = torch.clamp(self._row_search(row, y), 0, w - 1)
        col_lo = torch.where(col > 0,
                             flat[row * w + torch.clamp(col - 1, min=0)], 0.0)
        cell = self.data.reshape(-1)[row * w + col]
        pdf = cell / torch.clamp(self.total, min=1e-30)
        du = torch.clamp((y - col_lo) / torch.clamp(cell, min=1e-30), 0.0, 1.0)
        dv = torch.clamp((x - row_lo) / torch.clamp(row_w, min=1e-30), 0.0,
                         1.0)
        pos = torch.stack([col.to(torch.float32) + du,
                           row.to(torch.float32) + dv], -1)
        return pos, pdf

    def eval_pdf(self, col, row):
        return self.data[row, col] / torch.clamp(self.total, min=1e-30)
