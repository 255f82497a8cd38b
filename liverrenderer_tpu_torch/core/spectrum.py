"""RGB-side spectrum helpers for scene loading (counterpart of the host
part of liverrenderer_tpu/core/spectrum.py): the sRGB transfer curves and
the conversion of `blackbody`, `regular` and `irregular` spectra to linear
RGB, all numpy on the host, in the JAX package's float64 operations.
Transport stays RGB; hero-wavelength spectral rendering is ROADMAP M10.
"""
from __future__ import annotations

import numpy as np

# np.trapz was renamed np.trapezoid in numpy 2.0
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def srgb_to_linear(c):
    c = np.asarray(c)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb_np(c):
    c = np.asarray(c)
    return np.where(c <= 0.0031308, c * 12.92,
                    1.055 * np.maximum(c, 1e-8) ** (1.0 / 2.4) - 0.055)


def cie1931_xyz_bar(lam):
    """CIE 1931 colour matching functions, the multi-lobe Gaussian fit of
    Wyman, Sloan and Shirley 2013 (lam in nm)."""
    lam = np.asarray(lam, np.float64)

    def g(x, alpha, mu, s1, s2):
        t = (x - mu) * np.where(x < mu, 1.0 / s1, 1.0 / s2)
        return alpha * np.exp(-0.5 * t * t)

    x = (g(lam, 1.056, 599.8, 37.9, 31.0)
         + g(lam, 0.362, 442.0, 16.0, 26.7)
         + g(lam, -0.065, 501.1, 20.4, 26.2))
    y = (g(lam, 0.821, 568.8, 46.9, 40.5)
         + g(lam, 0.286, 530.9, 16.3, 31.1))
    z = (g(lam, 1.217, 437.0, 11.8, 36.0)
         + g(lam, 0.681, 459.0, 26.0, 13.8))
    return np.stack([x, y, z], -1)


_XYZ_TO_SRGB = np.array([[3.240479, -1.537150, -0.498535],
                         [-0.969256, 1.875991, 0.041556],
                         [0.055648, -0.204043, 1.057311]])


def planck(lam_nm, t_kelvin):
    """Planck's spectral radiance (unnormalised), lam in nm."""
    lam = np.asarray(lam_nm, np.float64) * 1e-9
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    return (2 * h * c * c) / (lam ** 5) / \
        (np.exp(h * c / (lam * kb * t_kelvin)) - 1.0)


def d65_spd(lam):
    """D65 as a 6504 K blackbody normalised at 560 nm."""
    return planck(lam, 6504.0) / planck(np.asarray(560.0), 6504.0)


def spd_to_rgb(lam, vals):
    """An SPD integrated against the CIE curves on 256 samples of its
    range -> linear sRGB (a flat spectrum maps to about (1, 1, 1))."""
    lam = np.asarray(lam, np.float64)
    vals = np.asarray(vals, np.float64)
    grid = np.linspace(lam.min(), lam.max(), 256)
    v = np.interp(grid, lam, vals)
    xyzbar = cie1931_xyz_bar(grid)
    xyz = _trapezoid(v[:, None] * xyzbar, grid, axis=0)
    norm = _trapezoid(cie1931_xyz_bar(grid)[:, 1], grid)
    xyz = xyz / max(norm, 1e-12)
    rgb = _XYZ_TO_SRGB @ xyz
    return np.maximum(rgb, 0.0).astype(np.float32)


def blackbody_rgb(temperature, scale=1.0):
    """The `blackbody` spectrum -> linear RGB radiance."""
    grid = np.linspace(360.0, 830.0, 256)
    spd = planck(grid, float(temperature))
    return (spd_to_rgb(grid, spd) * scale).astype(np.float32)
