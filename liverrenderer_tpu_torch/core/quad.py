"""Quadrature rules (counterpart of liverrenderer_tpu/core/quad.py; the
reference's include/mitsuba/core/quad.h gauss_legendre /
composite_simpson): nodes and weights on the host in numpy float64, and
the integral of a vectorized callable.
"""
from __future__ import annotations

import numpy as np


def gauss_legendre(n: int):
    """Nodes/weights of the n-point Gauss-Legendre rule on [-1, 1]
    (quad.h gauss_legendre)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return x.astype(np.float64), w.astype(np.float64)


def composite_simpson(n: int):
    """Nodes/weights of the composite Simpson rule with n (odd) nodes on
    [-1, 1] (quad.h composite_simpson)."""
    if n < 3 or n % 2 != 1:
        raise ValueError(f"composite Simpson needs odd n >= 3, not {n}")
    h = 2.0 / (n - 1)
    x = -1.0 + h * np.arange(n)
    w = np.full(n, 2.0, np.float64)
    w[1::2] = 4.0
    w[0] = w[-1] = 1.0
    return x, w * (h / 3.0)


def integrate(f, a: float, b: float, n: int = 64, rule=gauss_legendre):
    """Integrate a vectorized callable over [a, b]."""
    x, w = rule(n)
    xm = 0.5 * (b - a) * x + 0.5 * (a + b)
    return 0.5 * (b - a) * np.sum(w * np.asarray(f(xm)))
