"""Spectrum helpers (counterpart of liverrenderer_tpu/core/spectrum.py).

Host side, numpy in the JAX package's float64 operations: the sRGB
transfer curves and the conversion of `blackbody`, `regular` and
`irregular` spectra to linear RGB for scene loading.

Transport side, torch on the lanes' device: the spectral variant's
hero-wavelength packets.  Each lane carries N_SPEC wavelengths over
[SPEC_MIN, SPEC_MAX) (`sample_hero`); RGB reflectances are lifted to the
packet by the Smits (1999) basis (`smits_upsample`), RGB radiances by the
same basis times the D65 illuminant (`smits_upsample_illum`), and a
finished lane's packet becomes linear sRGB by the Monte-Carlo CIE
estimate (`spec_to_rgb_estimate`).  The tables are the JAX package's,
computed in numpy the same way; each lives once per device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

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


def luminance(c):
    return (0.212671 * c[..., 0] + 0.715160 * c[..., 1]
            + 0.072169 * c[..., 2])


# ---------------------------------------------------------------------------
# the spectral variant's transport
# ---------------------------------------------------------------------------

SPEC_MIN = 360.0
SPEC_MAX = 830.0
N_SPEC = 4            # packet entries per lane (hero + 3 strata)

# Smits (1999) base spectra, 10 bins over 380..720 nm ("An RGB to Spectrum
# Conversion for Reflectances", tables 2-3)
_SMITS_LAM = np.linspace(380.0, 720.0, 10)
_SMITS = {
    "white":   [1.0000, 1.0000, 0.9999, 0.9993, 0.9992, 0.9998, 1.0000,
                1.0000, 1.0000, 1.0000],
    "cyan":    [0.9710, 0.9426, 1.0007, 1.0007, 1.0007, 1.0007, 0.1564,
                0.0000, 0.0000, 0.0000],
    "magenta": [1.0000, 1.0000, 0.9685, 0.2229, 0.0000, 0.0458, 0.8369,
                1.0000, 1.0000, 0.9959],
    "yellow":  [0.0001, 0.0000, 0.1088, 0.6651, 1.0000, 1.0000, 0.9996,
                0.9586, 0.9685, 0.9840],
    "red":     [0.1012, 0.0515, 0.0000, 0.0000, 0.0000, 0.0000, 0.8325,
                1.0149, 1.0149, 1.0149],
    "green":   [0.0000, 0.0000, 0.0273, 0.7937, 1.0000, 0.9418, 0.1719,
                0.0000, 0.0000, 0.0025],
    "blue":    [1.0000, 1.0000, 0.8916, 0.3323, 0.0000, 0.0000, 0.0003,
                0.0369, 0.0483, 0.0496],
}
# (10, 7): the bases as columns in the order w, c, m, y, r, g, b
_SMITS_TABLE = np.asarray(
    [_SMITS[k] for k in ("white", "cyan", "magenta", "yellow", "red",
                         "green", "blue")], np.float32).T

_D65_GRID = np.linspace(SPEC_MIN, SPEC_MAX, 236)
_D65_TABLE = d65_spd(_D65_GRID).astype(np.float32)
# normalised so that rgb (1, 1, 1) lifts to the D65 SPD whose XYZ -> sRGB
# is (1, 1, 1), the sRGB white point
_D65_TABLE /= float(_trapezoid(
    _D65_TABLE * cie1931_xyz_bar(_D65_GRID)[:, 1], _D65_GRID)
    / _trapezoid(cie1931_xyz_bar(_D65_GRID)[:, 1], _D65_GRID))

_CIE_GRID = np.linspace(SPEC_MIN, SPEC_MAX, 236)
_CIE_TABLE = cie1931_xyz_bar(_CIE_GRID).astype(np.float32)   # (236, 3)
_CIE_Y_INT = float(_trapezoid(_CIE_TABLE[:, 1], _CIE_GRID))

_TABLES = {"smits": _SMITS_TABLE, "d65": _D65_TABLE, "cie": _CIE_TABLE,
           "xyz_to_srgb_t": _XYZ_TO_SRGB.T.astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _table(name: str, device: torch.device) -> torch.Tensor:
    """A constant table on `device`, copied there once (a copy per lift
    would cost a host-to-device transfer in every bounce)."""
    return torch.as_tensor(_TABLES[name], device=device)


def _interp(tbl, lam, lo, hi):
    """Rows of `tbl` (M, ...) interpolated linearly at lam over [lo, hi]
    (clamped at both ends) -> lam.shape + tbl.shape[1:]."""
    x = torch.clamp((lam - lo) / (hi - lo), 0.0, 1.0) * (tbl.shape[0] - 1)
    i0 = torch.clamp(x.to(torch.int64), 0, tbl.shape[0] - 2)
    f = x - i0
    if tbl.dim() > 1:
        f = f[..., None]
    return tbl[i0] * (1 - f) + tbl[i0 + 1] * f


def _smits_bases(lam):
    """The seven Smits bases at lam (..., K) -> (..., K, 7), linear over
    their 10 bins and flat beyond 380 and 720 nm."""
    return _interp(_table("smits", lam.device), lam,
                   float(np.float32(_SMITS_LAM[0])),
                   float(np.float32(_SMITS_LAM[-1])))


def _smits_combine(rgb, bases):
    """The Smits decomposition of rgb (..., 3) over bases (..., K, 7)
    -> (..., K): white plus one secondary (cyan, magenta or yellow) plus
    one primary, by the channel order.  The six cases are tested in the
    JAX package's order, so a tie between equal channels picks the same
    (first) case."""
    w, c, m, y, r, g, bl = bases.unbind(-1)
    R, G, B = rgb[..., 0:1], rgb[..., 1:2], rgb[..., 2:3]

    def comb(lo, mid, hi, sec, prim):
        return lo * w + (mid - lo) * sec + (hi - mid) * prim

    out = torch.where(
        (R <= G) & (G <= B), comb(R, G, B, c, bl),
        torch.where(
            (R <= B) & (B <= G), comb(R, B, G, c, g),
            torch.where(
                (G <= R) & (R <= B), comb(G, R, B, m, bl),
                torch.where(
                    (G <= B) & (B <= R), comb(G, B, R, m, r),
                    torch.where((B <= R) & (R <= G), comb(B, R, G, y, g),
                                comb(B, G, R, y, r))))))
    # maximum, not clamp: at out == 0 the derivative splits evenly, as
    # jnp.maximum's does (clamp passes it whole)
    return torch.maximum(out, torch.zeros_like(out))


def smits_upsample(rgb, lam):
    """Linear-sRGB reflectance (..., 3) lifted to spectral samples at the
    wavelengths lam (..., K) -> (..., K), by the Smits basis."""
    return _smits_combine(rgb, _smits_bases(lam))


def d65(lam):
    """The normalised D65 illuminant at lam (...,) -> (...,)."""
    return _interp(_table("d65", lam.device), lam, SPEC_MIN, SPEC_MAX)


def smits_upsample_illum(rgb, lam):
    """An RGB radiance lifted to a spectrum: the reflectance lift times
    D65 (the reference's srgb_d65 emitter model), so whites stay neutral
    because sRGB is D65-referenced."""
    return smits_upsample(rgb, lam) * d65(lam)


class Packet:
    """The lanes' hero wavelengths lam (N, K) with their lifts.  The Smits
    bases and D65 at lam are interpolated once and shared by every lift
    of the packet (a bounce lifts several RGB factors at the same
    wavelengths); the results equal smits_upsample and
    smits_upsample_illum.  refl also takes extra dims between the lanes
    and the channels, (N, ..., 3) -> (N, ..., K), in one pass."""

    def __init__(self, lam):
        self.lam = lam
        self._bases = _smits_bases(lam)
        self._d65 = None

    def refl(self, rgb):
        b = self._bases
        for _ in range(rgb.dim() - 2):
            b = b.unsqueeze(1)
        return _smits_combine(rgb, b)

    def illum(self, rgb):
        if self._d65 is None:
            self._d65 = d65(self.lam)
        return self.refl(rgb) * self._d65


def sample_hero(u):
    """Hero-wavelength packet from one uniform per lane: lam (..., N_SPEC),
    equally shifted strata over [SPEC_MIN, SPEC_MAX), each with the
    uniform pdf 1 / (SPEC_MAX - SPEC_MIN)."""
    span = SPEC_MAX - SPEC_MIN
    lam0 = SPEC_MIN + u * span
    shifts = torch.arange(N_SPEC, dtype=torch.float32, device=u.device) \
        * (span / N_SPEC)
    lam = lam0[..., None] + shifts
    return torch.where(lam >= SPEC_MAX, lam - span, lam)


def xyz_bar(lam):
    """CIE colour matching functions at lam (...,) -> (..., 3), linear in
    the 236-sample table."""
    return _interp(_table("cie", lam.device), lam, SPEC_MIN, SPEC_MAX)


def rgb_estimate_weights(lam):
    """d rgb_j / d L_k of `spec_to_rgb_estimate` at wavelengths lam
    (..., K) -> (..., K, 3).  The estimate is linear in L, so these
    weights turn an RGB loss cotangent into the packet cotangent the
    spectral replay adjoint walks with: delta_k = sum_j delta_j W[k, j]."""
    span = SPEC_MAX - SPEC_MIN
    K = lam.shape[-1]
    return (xyz_bar(lam) @ _table("xyz_to_srgb_t", lam.device)) \
        * (span / (K * _CIE_Y_INT))


def spec_to_rgb_estimate(L, lam):
    """Monte-Carlo spectral-to-RGB: radiance samples L (..., K) at lam
    (..., K), drawn with the uniform hero pdf -> (..., 3) linear sRGB.
    A spectrally flat radiance 1 maps to RGB luminance 1 (the film-side
    CIE integration of the reference's hdrfilm)."""
    span = SPEC_MAX - SPEC_MIN
    xyz = torch.mean(L[..., None] * xyz_bar(lam), dim=-2) * span \
        / _CIE_Y_INT
    return xyz @ _table("xyz_to_srgb_t", lam.device)
