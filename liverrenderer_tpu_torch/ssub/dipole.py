"""The classical isotropic dipole BSSRDF (Jensen et al. 2001; counterpart
of liverrenderer_tpu/ssub/dipole.py).

  preprocess  area-uniform surface points of the dipole shapes with their
              direct irradiance, estimated by NEE at build time
              (`compute_irradiance`, 8 rounds of one shadow query each);
  eval        Mo(p) = sum_i Rd(|p - x_i|) E_i A_i with the standard dipole
              Rd (the published r^2 form), Lo = Ft / pi * Mo, summed over
              the point cloud in chunks of CHUNK points.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.fresnel import fresnel_dielectric
from ..core.math import sqrt
from ..core.rng import make_sampler
from ..core.types import Ray

CHUNK = 256


def fresnel_diffuse_reflectance(eta):
    """Polynomial fit of the diffuse Fresnel reflectance (Egan and
    Hilgeman), numpy."""
    e = eta
    return np.where(
        e < 1.0,
        -0.4399 + 0.7099 / e - 0.3319 / e ** 2 + 0.0636 / e ** 3,
        -1.4399 / e ** 2 + 0.7099 / e + 0.6681 + 0.0636 * e)


def dipole_constants(sigma_s, sigma_a, g, eta):
    """(zr, zv, sigma_tr, fdr) per channel, float32 (dipole.cpp
    configure)."""
    sigma_s = np.asarray(sigma_s, np.float64)
    sigma_a = np.asarray(sigma_a, np.float64)
    sigma_tp = sigma_s * (1.0 - g) + sigma_a
    fdr = float(fresnel_diffuse_reflectance(1.0 / eta))
    A = (1.0 + fdr) / (1.0 - fdr)
    mfp = 1.0 / np.maximum(sigma_tp, 1e-9)
    sigma_tr = np.sqrt(3.0 * sigma_a * sigma_tp)
    zv = mfp * (1.0 + 4.0 / 3.0 * A)
    return (mfp.astype(np.float32), zv.astype(np.float32),
            sigma_tr.astype(np.float32), np.float32(fdr))


def compute_irradiance(scene, points, normals, n_light_samples: int = 8,
                       seed: int = 13):
    """(P, 3) direct irradiance at surface points on the scene's device:
    the mean of n_light_samples NEE rounds, each point's stream keyed by
    (point, round, seed)."""
    from ..accel.intersect import ray_test
    from ..emitter.dispatch import sample_emitter_direction

    dev = scene.device
    pts = torch.as_tensor(points, device=dev)
    nrm = torch.as_tensor(normals, device=dev)
    n = pts.shape[0]
    eps = (1.0 + torch.amax(torch.abs(pts), -1)) * 1e-4
    E = torch.zeros((n, 3), device=dev)
    for k in range(n_light_samples):
        sampler = make_sampler(torch.arange(n, device=dev), k, seed)
        u2, sampler = sampler.next_2d()
        u1, sampler = sampler.next_1d()
        ds, em_w = sample_emitter_direction(scene, pts, u2, u1)
        cos_i = torch.sum(ds.d * nrm, -1)
        ok = (ds.pdf > 0) & (cos_i > 0)
        occ = ray_test(scene, Ray(o=pts + ds.d * eps[:, None], d=ds.d,
                                  maxt=ds.dist * (1 - 1e-3) - eps))
        E = E + torch.where((ok & ~occ)[:, None], em_w * cos_i[:, None], 0.0)
    return E / n_light_samples


def dipole_lo(scene, p, wi_cos, active):
    """Outgoing radiance at entry points p (N, 3) with incident cosine
    wi_cos: Lo = Ft(cos) / pi * Mo(p), zero off `active`."""
    ss = scene.ssub
    zr, zv = ss.dip_consts[0:3], ss.dip_consts[3:6]
    sigma_tr, eta = ss.dip_consts[6:9], ss.dip_consts[9]
    mo = torch.zeros((p.shape[0], 3), device=p.device)
    for c in range(0, ss.dip_points.shape[0], CHUNK):
        pts = ss.dip_points[c:c + CHUNK]
        r2 = torch.sum((p[:, None, :] - pts[None, :, :]) ** 2, -1)[..., None]
        dr = sqrt(r2 + zr * zr)
        dv = sqrt(r2 + zv * zv)
        c1 = zr * (sigma_tr + 1.0 / dr)
        c2 = zv * (sigma_tr + 1.0 / dv)
        rd = (1.0 / (4.0 * math.pi)) * (
            c1 * torch.exp(-sigma_tr * dr) / (dr * dr)
            + c2 * torch.exp(-sigma_tr * dv) / (dv * dv))
        mo = mo + torch.sum(rd * ss.dip_irradiance[None, c:c + CHUNK]
                            * ss.dip_area[None, c:c + CHUNK, None], 1)
    fr = fresnel_dielectric(wi_cos, eta)[0]
    lo = (1.0 - fr)[:, None] / math.pi * mo
    return torch.where(active[:, None], lo, 0.0)
