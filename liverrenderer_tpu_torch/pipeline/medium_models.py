"""Biophysical absorption and scattering models of the liver media
(counterpart of liverrenderer_tpu/pipeline/medium_models.py; the
reference's liver/glisson/{collagen,elastin}.py and liver/parenchyma/
{blood,bile,water,lipid,water_lipid,hepatocity}.py): the
wavelength-dependent coefficient of each tissue element, binned to RGB by
`prepare_medium`.  numpy float64 and the standard library, as in the JAX
package.

The spectra tables (public data from omlc.org and the cited papers) are
read from `DATA_DIR`: by default liver/data/ at the root of the
checkout, where the reference repository keeps them; set it to a directory holding hemoglobin_data.txt (columns
lambda, HbO2, Hb), bile_data.txt, water_data.txt and lipid_data.txt
(lambda, value).  The collagen fibres' Mie efficiency is the Bohren &
Huffman series (`mie_qsca`), which needs no table.
"""
from __future__ import annotations

import math
import os
from pathlib import Path

import numpy as np

DATA_DIR = str(Path(__file__).resolve().parents[2] / "liver" / "data")


def mie_qsca(m: float, x: float) -> float:
    """Scattering efficiency Q_sca of a homogeneous sphere.

    m: relative refractive index (real), x: size parameter 2*pi*a/lambda.
    Bohren & Huffman: a_n/b_n via logarithmic-derivative downward
    recurrence."""
    if x <= 0:
        return 0.0
    nmax = int(x + 4.05 * x ** (1 / 3) + 2) + 1
    nmx = max(nmax, int(abs(m * x))) + 16
    # downward recurrence for D_n(mx)
    D = np.zeros(nmx + 1, np.complex128)
    mx = m * x
    for n in range(nmx, 0, -1):
        D[n - 1] = n / mx - 1.0 / (D[n] + n / mx)
    # Riccati-Bessel psi, chi by upward recurrence
    psi0 = math.sin(x)
    psi1 = psi0 / x - math.cos(x)
    chi0 = math.cos(x)
    chi1 = chi0 / x + math.sin(x)
    xi0 = complex(psi0, -chi0)
    xi1 = complex(psi1, -chi1)
    qsca = 0.0
    psi_nm1, psi_n = psi0, psi1
    xi_nm1, xi_n = xi0, xi1
    for n in range(1, nmax + 1):
        dn = D[n]
        an = ((dn / m + n / x) * psi_n - psi_nm1) / \
             ((dn / m + n / x) * xi_n - xi_nm1)
        bn = ((dn * m + n / x) * psi_n - psi_nm1) / \
             ((dn * m + n / x) * xi_n - xi_nm1)
        qsca += (2 * n + 1) * (abs(an) ** 2 + abs(bn) ** 2)
        psi_np1 = (2 * n + 1) / x * psi_n - psi_nm1
        xi_np1 = (2 * n + 1) / x * xi_n - xi_nm1
        psi_nm1, psi_n = psi_n, psi_np1
        xi_nm1, xi_n = xi_n, xi_np1
    return qsca * 2.0 / (x * x)


def _load_table(name: str, ncols: int = 2):
    """The first `ncols` columns of DATA_DIR/name, '#' lines skipped,
    sorted by the first."""
    path = os.path.join(DATA_DIR, name)
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            rows.append([float(p) for p in parts[:ncols]])
    arr = np.asarray(rows)
    order = np.argsort(arr[:, 0])
    return arr[order]


def _interp_ref(tab, lam):
    """Table lookup with the reference's out-of-range semantics
    (parenchyma/*.py interpolateTable): below the first key the value is
    lerped from an implicit (0, 0) entry.  The reference's lipid table is
    in m^-1 where water and bile are in cm^-1; this follows its code, as
    the JAX package does."""
    lam = float(lam)
    if lam < tab[0, 0]:
        return lam / tab[0, 0] * tab[0, 1]
    return float(np.interp(lam, tab[:, 0], tab[:, 1]))


class CollagenElement:
    """Mie scattering of collagen fibers modelled as cylinders
    (Jacques 1996 density; liver/glisson/collagen.py)."""

    def coeff(self, vf, diameter_um, n_med, n_p, lam_nm):
        a = diameter_um / 2.0
        y = lam_nm / 1000.0          # vacuum wavelength in um
        m = n_p / n_med
        x = 2.0 * math.pi * a / (y / n_med)
        A = math.pi * a * a
        ps = vf / ((math.pi * (a * 2) ** 2) / 4.0)
        return ps * mie_qsca(m, x) * A          # cm-1-ish relative units


class ElastinElement:
    """Rayleigh approximation for thin elastin fibers
    (liver/glisson/elastin.py, Bohren & Huffman eq. 5.7-5.9)."""

    def coeff(self, vf, diameter_um, n_med, n_p, lam_nm):
        a = diameter_um / 2.0
        y = lam_nm / 1000.0
        m = n_p / n_med
        x = 2.0 * math.pi * a / (y / n_med)
        A = math.pi * a * a
        ps = vf / ((math.pi * (a * 2.0) ** 2) / 4.0)
        ratio = (m ** 2 - 1) / (m ** 2 + 2)
        qsca = 8.0 / 3.0 * x ** 4 * abs(ratio) ** 2
        return ps * qsca * A


class BloodElement:
    """Hemoglobin absorption with pigment packaging
    (liver/parenchyma/blood.py; data from omlc.org/spectra/hemoglobin)."""

    def __init__(self, vf, st02, radius):
        self.vf = vf
        self.st02 = st02
        self.R = radius
        self.conv = 0.0054
        self.tab = _load_table("hemoglobin_data.txt", 3)

    def u_a_hbt(self, lam):
        hbo2 = np.interp(lam, self.tab[:, 0], self.tab[:, 1]) * self.conv
        hb = np.interp(lam, self.tab[:, 0], self.tab[:, 2]) * self.conv
        return self.st02 * hbo2 + (1.0 - self.st02) * hb

    def u_a(self, lam):
        hbt = self.u_a_hbt(lam)
        c = (1.0 - math.exp(-2.0 * self.R * hbt)) / (2.0 * self.R * hbt)
        return c * self.vf * hbt


class BileElement:
    """Bile absorption (liver/parenchyma/bile.py)."""

    def __init__(self, vf):
        self.vf = vf
        self.tab = _load_table("bile_data.txt")

    def u_a(self, lam):
        return _interp_ref(self.tab, lam) * self.vf


class WaterLipidElement:
    """liver/parenchyma/water_lipid.py: mixed water+lipid absorption."""

    def __init__(self, water_vf, lipid_vf):
        self.water_vf = water_vf
        self.lipid_vf = lipid_vf
        self.vwl = lipid_vf * water_vf + water_vf
        self.water = _load_table("water_data.txt")
        self.lipid = _load_table("lipid_data.txt")

    def u_a(self, lam):
        ua_w = _interp_ref(self.water, lam)
        ua_l = _interp_ref(self.lipid, lam)
        return self.vwl * (self.lipid_vf * ua_l
                           + (1.0 - self.lipid_vf) * ua_w)


def hepatocyte_ug(vf, l_axis, g_axis):
    """Geometric scattering of spheroidal hepatocytes (Chen 2015;
    liver/parenchyma/hepatocity.py) — wavelength independent."""
    a, b = l_axis, g_axis
    c = math.sqrt(1.0 - (a * a) / (b * b))
    s_v = (3.0 / (2.0 * a)) * (a / b + math.asin(c) / c)
    return s_v * (vf / 4.0)


def rgb_bin(fn, lam_lo=360, lam_hi=710):
    """Average a spectral coefficient into the reference's RGB bands
    (prepare_medium.py calc_abs_coeff: R 680-720, G 520-570, B 410-460)."""
    acc = np.zeros(3)
    cnt = np.zeros(3)
    for lam in range(lam_lo, lam_hi + 1):
        v = fn(lam)
        if 680 < lam < 720:
            acc[0] += v
            cnt[0] += 1
        elif 520 < lam < 570:
            acc[1] += v
            cnt[1] += 1
        elif 410 < lam < 460:
            acc[2] += v
            cnt[2] += 1
    return acc / np.maximum(cnt, 1)
