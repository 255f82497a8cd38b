"""1D Catmull-Rom spline evaluation, integration and sampling on a
uniform grid (counterpart of liverrenderer_tpu/core/spline.py; the
reference's include/mitsuba/core/spline.h eval_1d / integrate_1d /
sample_1d), as torch functions vectorized over the query points, on the
device of the values.
"""
from __future__ import annotations

import torch


def _hermite_weights(t):
    t2 = t * t
    t3 = t2 * t
    w0 = 2 * t3 - 3 * t2 + 1
    w1 = t3 - 2 * t2 + t
    w2 = -2 * t3 + 3 * t2
    w3 = t3 - t2
    return w0, w1, w2, w3


def _values(values):
    return torch.as_tensor(values, dtype=torch.float32)


def eval_1d(x, values, x_min: float = 0.0, x_max: float = 1.0):
    """Catmull-Rom interpolation of `values` (K,) sampled uniformly on
    [x_min, x_max], evaluated at x (...,). Clamped outside the domain."""
    values = _values(values)
    x = torch.as_tensor(x, dtype=torch.float32, device=values.device)
    K = values.shape[0]
    u = torch.clamp((x - x_min) / (x_max - x_min), 0.0, 1.0) * (K - 1)
    i = torch.clamp(u.to(torch.int64), 0, K - 2)
    t = u - i
    f0 = values[i]
    f1 = values[i + 1]
    # one-sided derivative estimates at the segment ends (spline.h:273-285)
    d0 = torch.where(i > 0, 0.5 * (f1 - values[torch.clamp(i - 1, min=0)]),
                     f1 - f0)
    d1 = torch.where(i + 2 < K,
                     0.5 * (values[torch.clamp(i + 2, max=K - 1)] - f0),
                     f1 - f0)
    w0, w1, w2, w3 = _hermite_weights(t)
    return w0 * f0 + w1 * d0 + w2 * f1 + w3 * d1


def integrate_1d(values, x_min: float = 0.0, x_max: float = 1.0):
    """Cumulative integral of the spline at each node (K,) — spline.h
    integrate_1d: each segment's Hermite integral has closed form."""
    values = _values(values)
    K = values.shape[0]
    h = (x_max - x_min) / (K - 1)
    f0 = values[:-1]
    f1 = values[1:]
    prev = torch.cat([values[0:1], values[:-2]])
    nxt = torch.cat([values[2:], values[-1:]])
    seg_i = torch.arange(K - 1, device=values.device)
    d0 = torch.where(seg_i > 0, 0.5 * (f1 - prev), f1 - f0)
    d1 = torch.where(seg_i + 2 < K, 0.5 * (nxt - f0), f1 - f0)
    seg = h * ((f0 + f1) * 0.5 + (d0 - d1) * (1.0 / 12.0))
    return torch.cat([torch.zeros(1, device=values.device),
                      torch.cumsum(seg, 0)])


def sample_1d(u, values, x_min: float = 0.0, x_max: float = 1.0,
              newton_iters: int = 8):
    """Sample x proportional to the (non-negative) spline density — the
    inverse CDF with per-segment Newton refinement (spline.h sample_1d)."""
    values = _values(values)
    u = torch.as_tensor(u, dtype=torch.float32, device=values.device)
    K = values.shape[0]
    cdf = integrate_1d(values, x_min, x_max)
    target = u * cdf[-1]
    i = torch.clamp(torch.searchsorted(cdf, target, right=True) - 1, 0,
                    K - 2)
    h = (x_max - x_min) / (K - 1)

    t = torch.full_like(u, 0.5)
    for _ in range(newton_iters):
        x = x_min + (i + t) * h
        # segment-local integral via trapezoid-of-spline (good to O(h^4))
        f_mid = eval_1d(x, values, x_min, x_max)
        f_lo = values[i]
        c_here = cdf[i] + 0.5 * (f_lo + f_mid) * t * h
        err = c_here - target
        t = torch.clamp(t - err / torch.clamp(f_mid * h, min=1e-12), 0.0,
                        1.0)
    return x_min + (i + t) * h
