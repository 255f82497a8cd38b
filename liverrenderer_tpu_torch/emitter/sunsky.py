"""Preetham analytic sun/sky model, baked to a lat-long environment map
(counterpart of liverrenderer_tpu/emitter/sunsky.py, the same numpy
operations in the same order, so the baked image is bit-equal).

Capability analog of reference src/emitters/{sunsky,timed_sunsky}.cpp
(Hosek-Wilkie there): the sky dome is evaluated analytically at scene build
time and registered as a regular envmap emitter, so sampling/eval reuse the
envmap machinery (2D CDF importance sampling).  Preetham et al. 1999 Perez
coefficients; sun disc added with its solid-angle-normalized radiance.
"""
from __future__ import annotations

import numpy as np

_XYZ_TO_SRGB = np.array([[3.240479, -1.537150, -0.498535],
                         [-0.969256, 1.875991, 0.041556],
                         [0.055648, -0.204043, 1.057311]])


def _perez(theta, gamma, A, B, C, D, E):
    cos_t = np.maximum(np.cos(theta), 1e-2)
    return (1.0 + A * np.exp(B / cos_t)) * \
        (1.0 + C * np.exp(D * gamma) + E * np.cos(gamma) ** 2)


def sun_direction(hour: float = 12.0, latitude: float = 35.0,
                  day_of_year: int = 180):
    """Approximate solar position (timed_sunsky capability): returns a unit
    direction with y up."""
    decl = np.deg2rad(23.45) * np.sin(2 * np.pi * (284 + day_of_year) / 365)
    lat = np.deg2rad(latitude)
    h = np.deg2rad(15.0 * (hour - 12.0))
    sin_alt = np.sin(lat) * np.sin(decl) + np.cos(lat) * np.cos(decl) * \
        np.cos(h)
    alt = np.arcsin(np.clip(sin_alt, -1, 1))
    cos_az = (np.sin(decl) - np.sin(lat) * sin_alt) / \
        np.maximum(np.cos(lat) * np.cos(alt), 1e-6)
    az = np.arccos(np.clip(cos_az, -1, 1))
    if hour > 12:
        az = 2 * np.pi - az
    d = np.array([np.cos(alt) * np.sin(az), np.sin(alt),
                  np.cos(alt) * np.cos(az)])
    return d / np.linalg.norm(d)


def preetham_envmap(turbidity: float = 3.0, sun_dir=None,
                    res: int = 128, sun_scale: float = 1.0,
                    sky_scale: float = 1.0) -> np.ndarray:
    """Bake the Preetham sky + sun disc into an (res, 2*res, 3) lat-long
    map matching the envmap mapping in emitter/dispatch.py (`_env_uv`:
    theta from +y, phi = atan2(x, -z))."""
    if sun_dir is None:
        sun_dir = sun_direction()
    sun_dir = np.asarray(sun_dir, np.float64)
    sun_dir = sun_dir / np.linalg.norm(sun_dir)
    T = float(turbidity)

    theta_s = np.arccos(np.clip(sun_dir[1], -1, 1))
    theta_s = min(theta_s, np.deg2rad(89.0))

    # zenith values (Preetham A.2)
    chi = (4.0 / 9.0 - T / 120.0) * (np.pi - 2 * theta_s)
    Yz = (4.0453 * T - 4.9710) * np.tan(chi) - 0.2155 * T + 2.4192  # kcd/m2
    Yz = max(Yz, 0.001) * 1000.0
    t2, th = T * T, theta_s
    th2, th3 = th * th, th ** 3
    xz = ((0.00166 * th3 - 0.00375 * th2 + 0.00209 * th) * t2 +
          (-0.02903 * th3 + 0.06377 * th2 - 0.03202 * th + 0.00394) * T +
          (0.11693 * th3 - 0.21196 * th2 + 0.06052 * th + 0.25886))
    yz = ((0.00275 * th3 - 0.00610 * th2 + 0.00317 * th) * t2 +
          (-0.04214 * th3 + 0.08970 * th2 - 0.04153 * th + 0.00516) * T +
          (0.15346 * th3 - 0.26756 * th2 + 0.06670 * th + 0.26688))

    # Perez coefficients (Preetham A.2)
    AY, BY = 0.1787 * T - 1.4630, -0.3554 * T + 0.4275
    CY, DY, EY = -0.0227 * T + 5.3251, 0.1206 * T - 2.5771, -0.0670 * T + 0.3703
    Ax, Bx = -0.0193 * T - 0.2592, -0.0665 * T + 0.0008
    Cx, Dx, Ex = -0.0004 * T + 0.2125, -0.0641 * T - 0.8989, -0.0033 * T + 0.0452
    Ay, By = -0.0167 * T - 0.2608, -0.0950 * T + 0.0092
    Cy, Dy, Ey = -0.0079 * T + 0.2102, -0.0441 * T - 1.6537, -0.0109 * T + 0.0529

    h, w = res, 2 * res
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    theta = v * np.pi                      # from +y
    phi = u * 2 * np.pi - np.pi
    TH, PH = np.meshgrid(theta, phi, indexing="ij")
    # direction consistent with _env_uv: y = cos(theta), x = sin*sin(phi),
    # z = -sin*cos(phi)
    dirs = np.stack([np.sin(TH) * np.sin(PH), np.cos(TH),
                     -np.sin(TH) * np.cos(PH)], -1)
    cos_g = np.clip(dirs @ sun_dir, -1, 1)
    gamma = np.arccos(cos_g)
    th_v = np.minimum(TH, np.pi / 2 - 1e-3)

    def ratio(A, B, C, D, E):
        return _perez(th_v, gamma, A, B, C, D, E) / \
            _perez(0.0, theta_s, A, B, C, D, E)

    Y = Yz * ratio(AY, BY, CY, DY, EY)
    x = xz * ratio(Ax, Bx, Cx, Dx, Ex)
    y = np.clip(yz * ratio(Ay, By, Cy, Dy, Ey), 1e-3, 0.8)

    X = x / y * Y
    Z = (1.0 - x - y) / y * Y
    xyz = np.stack([X, Y, Z], -1)
    rgb = np.einsum("ij,hwj->hwi", _XYZ_TO_SRGB, xyz)
    rgb = np.maximum(rgb, 0.0) / 1000.0 * sky_scale  # kcd-ish normalization

    # horizon clamp + ground
    below = dirs[..., 1] < 0.0
    ground = rgb[np.abs(theta - np.pi / 2).argmin(), :, :].mean(0) * 0.3
    rgb[below] = ground

    # sun disc (~0.545 deg diameter).  The disc is far smaller than an
    # envmap texel at bake resolutions (0.27 deg radius vs ~1.4 deg
    # texels at res=128), so a cos-threshold mask usually selects ZERO
    # texels and the sun silently disappears.  Instead deposit the
    # disc's power solid-angle-correctly: every texel receives the disc
    # radiance scaled by (disc solid angle overlapping the texel) /
    # (texel solid angle) — approximated by splatting the full disc
    # into the containing texel — so irradiance is invariant to res.
    if sun_scale > 0.0:
        # direct-normal spectral transmittance (the Rayleigh + aerosol
        # terms of Preetham A.1's sun model; ozone/gas/vapor corrections
        # are a few percent and omitted) at effective RGB wavelengths
        lam = np.array([0.61, 0.545, 0.465])          # um
        th_deg = np.rad2deg(theta_s)
        m_air = 1.0 / (np.cos(theta_s)
                       + 0.15 * (93.885 - th_deg) ** -1.253)
        beta = 0.04608 * T - 0.04586                  # Preetham turbidity
        tau = np.exp(-m_air * (0.008735 * lam ** -4.08
                               + beta * lam ** -1.3))
        # extraterrestrial direct-normal illuminance ~128 klux; map units
        # are kcd/m^2, so the disc's irradiance in map units is E0 * tau
        e_sun = 128.0 * tau
        theta_sun = np.arccos(np.clip(sun_dir[1], -1, 1))
        phi_sun = np.arctan2(sun_dir[0], -sun_dir[2])
        i = min(int(theta_sun / np.pi * h), h - 1)
        j = min(int((phi_sun + np.pi) / (2 * np.pi) * w), w - 1)
        omega_texel = (np.pi / h) * (2 * np.pi / w) * max(np.sin(TH[i, j]),
                                                          1e-4)
        rgb[i, j] += e_sun * sun_scale / omega_texel
    return rgb.astype(np.float32)
