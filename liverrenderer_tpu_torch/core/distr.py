"""Discrete distribution for emitter selection (counterpart of
liverrenderer_tpu/core/distr.py, its DiscreteDistribution).

The CDF is built host-side into a dense array; sampling is a vectorised
`torch.searchsorted` with numpy's side="right" (right=True), as the JAX
package samples it.  The envmap's Distribution2D comes with the envmap.
"""
from __future__ import annotations

from dataclasses import dataclass

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
