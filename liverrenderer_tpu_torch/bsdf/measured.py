"""Data-driven measured BSDF in the RGL material format (counterpart of
liverrenderer_tpu/bsdf/measured.py; the reference's src/bsdfs/measured.cpp
with the Dupuy & Jakob 2018 parameterization).

The per-incidence-slice warps are precomputed on the host into dense
cumulative tables (numpy, at scene build); on the device a lane does
fixed-depth binary searches over the mixture CDF of the two theta_i slices
that bracket it, which is exact because a CDF is linear in its density.
Sampling is piecewise constant per texel while values stay bilinear, so
sample and pdf agree by construction.  Isotropic materials with RGB
spectra (the "rgb" field), one material per scene, as in the JAX package.

Tensor file layout (core/tensor.cpp): magic "tensor_file\\0", 2-byte
version, uint32 field count; per field uint16 name_len, name, uint16 ndim,
uint8 dtype, uint64 offset, uint64 dims[ndim].
"""
from __future__ import annotations

import math
import struct as pystruct

import numpy as np
import torch

from ..core import math as m
from ..scene.ir import MeasuredTable

_DTYPES = {1: np.uint8, 2: np.int8, 3: np.uint16, 4: np.int16,
           5: np.uint32, 6: np.int32, 7: np.uint64, 8: np.int64,
           9: np.float16, 10: np.float32, 11: np.float64}


def load_tensor_file(path: str) -> dict:
    """An RGL tensor file as {name: ndarray}."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:11] != b"tensor_file":
        raise ValueError(f"{path}: not a tensor file")
    (n_fields,) = pystruct.unpack_from("<I", buf, 14)
    pos = 18
    out = {}
    for _ in range(n_fields):
        (name_len,) = pystruct.unpack_from("<H", buf, pos)
        pos += 2
        name = buf[pos:pos + name_len].decode()
        pos += name_len
        ndim, dtype = pystruct.unpack_from("<HB", buf, pos)
        pos += 3
        (offset,) = pystruct.unpack_from("<Q", buf, pos)
        pos += 8
        shape = pystruct.unpack_from("<" + "Q" * ndim, buf, pos)
        pos += 8 * ndim
        count = int(np.prod(shape)) if ndim else 1
        arr = np.frombuffer(buf, _DTYPES[dtype], count, offset)
        out[name] = arr.reshape(shape)
    return out


def write_tensor_file(path: str, fields: dict):
    """The inverse of load_tensor_file (test fixtures, dataset tools)."""
    inv = {v: k for k, v in _DTYPES.items()}
    header = b"tensor_file\x00" + bytes([1, 0]) \
        + pystruct.pack("<I", len(fields))
    meta, blobs = [], []
    offset = len(header)
    for name, arr in fields.items():
        arr = np.ascontiguousarray(arr)
        rec = pystruct.pack("<H", len(name)) + name.encode() \
            + pystruct.pack("<HB", arr.ndim, inv[np.dtype(arr.dtype).type])
        meta.append((rec, arr))
        offset += len(rec) + 8 + 8 * arr.ndim
    data_pos = offset
    out = [header]
    for rec, arr in meta:
        out.append(rec)
        out.append(pystruct.pack("<Q", data_pos))
        out.append(pystruct.pack("<" + "Q" * arr.ndim, *arr.shape))
        blobs.append(arr.tobytes())
        data_pos += arr.nbytes
    out += blobs
    with open(path, "wb") as f:
        f.write(b"".join(out))


# ---------------------------------------------------------------------------
# Host-side precompute
# ---------------------------------------------------------------------------

def _build_warp(density: np.ndarray):
    """density (S, H, W) >= 0 -> (row_cdf (S, H+1), cond_cdf (S, H, W+1),
    pdf (S, H, W)): texel masses normalized over each slice, cumulated
    unnormalized within a row, so that slice mixtures blend exactly."""
    d = np.maximum(np.asarray(density, np.float64), 0.0)
    S, H, W = d.shape
    mass = d / np.maximum(d.sum((1, 2), keepdims=True), 1e-30)
    cond = np.zeros((S, H, W + 1))
    cond[:, :, 1:] = np.cumsum(mass, 2)
    row = np.zeros((S, H + 1))
    row[:, 1:] = np.cumsum(cond[:, :, -1], 1)
    pdf = (mass * H * W).astype(np.float32)
    return row.astype(np.float32), cond.astype(np.float32), pdf


class MeasuredData:
    """One .bsdf material on the host (the builder uploads its tables)."""

    def __init__(self, path: str):
        tf = load_tensor_file(path)
        self.theta_i = np.asarray(tf["theta_i"], np.float32)
        if tf["phi_i"].shape[0] > 2:
            raise ValueError(f"{path}: anisotropic measured materials are "
                             "not supported, as in the JAX package")
        vndf = np.asarray(tf["vndf"], np.float32)[0]       # (S, H, W)
        lum = np.asarray(tf["luminance"], np.float32)[0]
        self.spectra = np.asarray(tf["rgb"], np.float32)[0]  # (S, 3, H, W)
        self.ndf = np.asarray(tf["ndf"], np.float32)
        self.sigma = np.asarray(tf["sigma"], np.float32)
        self.jacobian = bool(np.asarray(tf["jacobian"]).ravel()[0]) \
            if "jacobian" in tf else False
        self.vndf = vndf
        self.vndf_tables = _build_warp(vndf)
        self.lum_tables = _build_warp(lum)


def table_arrays(mds) -> tuple:
    """Host MeasuredData list -> (arrays under the Scene's "measured."
    paths, statics): one material per scene."""
    if len(mds) != 1:
        raise ValueError("one measured material per scene, as in the JAX "
                         "package")
    md = mds[0]
    vr, vc, vp = md.vndf_tables
    lr_, lc, lp = md.lum_tables
    arrays = {"theta_i": md.theta_i, "vndf_row": vr, "vndf_cond": vc,
              "vndf_pdf": vp, "lum_row": lr_, "lum_cond": lc,
              "lum_pdf": lp, "spectra": md.spectra, "ndf": md.ndf,
              "sigma": md.sigma}
    return ({f"measured.{k}": v for k, v in arrays.items()},
            {"measured.jacobian": md.jacobian, "measured.enabled": True})


def empty_table_arrays() -> dict:
    """The placeholder tables of a scene without a measured material."""
    f32 = np.float32
    return {"measured.theta_i": np.zeros((1,), f32),
            "measured.vndf_row": np.zeros((1, 3), f32),
            "measured.vndf_cond": np.zeros((1, 2, 3), f32),
            "measured.vndf_pdf": np.ones((1, 2, 2), f32),
            "measured.lum_row": np.zeros((1, 3), f32),
            "measured.lum_cond": np.zeros((1, 2, 3), f32),
            "measured.lum_pdf": np.ones((1, 2, 2), f32),
            "measured.spectra": np.ones((1, 3, 2, 2), f32),
            "measured.ndf": np.ones((2, 2), f32),
            "measured.sigma": np.ones((2, 2), f32)}


# ---------------------------------------------------------------------------
# Device-side warp ops (fixed-depth bisection over mixture CDFs)
# ---------------------------------------------------------------------------

def _bisect(cdf_fn, size: int, target):
    """j with cdf(j) <= target < cdf(j + 1), the cdf over [0, size]."""
    lo = torch.zeros(target.shape, dtype=torch.int64, device=target.device)
    hi = torch.full_like(lo, size)
    for _ in range(max(1, int(np.ceil(np.log2(size + 1))))):
        mid = (lo + hi) // 2
        below = cdf_fn(mid) <= target
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return torch.clamp(lo, 0, size - 1)


def _slice_of(theta_grid, theta):
    """Bracketing slice index and lerp weight of each lane's theta_i."""
    S = theta_grid.shape[0]
    if S == 1:
        return torch.zeros(theta.shape, dtype=torch.int64,
                           device=theta.device), torch.zeros_like(theta)
    s0 = torch.clamp(torch.searchsorted(theta_grid, theta.contiguous(),
                                        right=True) - 1, 0, S - 2)
    t0 = theta_grid[s0]
    t1 = theta_grid[s0 + 1]
    w = torch.clamp((theta - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)
    return s0, w


def _mix(tab, s0, w, *idx):
    """tab[s0, *idx] and tab[s0 + 1, *idx] blended by w."""
    S = tab.shape[0]
    a = tab[(s0,) + idx]
    b = tab[(torch.clamp(s0 + 1, max=S - 1),) + idx]
    return a * (1.0 - w) + b * w


def _warp_sample(tables, s0, w, u):
    """Sample the slice-mixture warp: u[:, 1] picks the row (phi axis),
    u[:, 0] the column (theta axis) -> (x, y, pdf)."""
    row_cdf, cond_cdf, pdf_tex = tables
    _, H, W = pdf_tex.shape

    def rc(j):
        return _mix(row_cdf, s0, w, j)

    j = _bisect(rc, H, u[:, 1])
    c0, c1 = rc(j), rc(j + 1)
    mass_row = torch.clamp(c1 - c0, min=1e-12)
    y = (j + (u[:, 1] - c0) / mass_row) / H

    def cc(i):
        return _mix(cond_cdf, s0, w, j, i)

    target = u[:, 0] * mass_row
    i = _bisect(cc, W, target)
    d0, d1 = cc(i), cc(i + 1)
    mass_tex = torch.clamp(d1 - d0, min=1e-12)
    x = (i + (target - d0) / mass_tex) / W
    return x, y, _mix(pdf_tex, s0, w, j, i)


def _warp_invert(tables, s0, w, x, y):
    """The mixture warp's forward CDF, the preimage of (x, y) under
    _warp_sample -> (u0, u1, pdf)."""
    row_cdf, cond_cdf, pdf_tex = tables
    _, H, W = pdf_tex.shape
    j = torch.clamp((y * H).to(torch.int64), 0, H - 1)
    i = torch.clamp((x * W).to(torch.int64), 0, W - 1)
    fy = y * H - j
    fx = x * W - i
    c0, c1 = _mix(row_cdf, s0, w, j), _mix(row_cdf, s0, w, j + 1)
    mass_row = torch.clamp(c1 - c0, min=1e-12)
    u1 = c0 + fy * mass_row
    d0, d1 = _mix(cond_cdf, s0, w, j, i), _mix(cond_cdf, s0, w, j, i + 1)
    u0 = (d0 + fx * torch.clamp(d1 - d0, min=0.0)) / mass_row
    return u0, u1, _mix(pdf_tex, s0, w, j, i)


def _bilinear2d(tab, x, y, s=None):
    """tab (H, W), or (S, H, W) at per-lane slice s, sampled at
    vertex-based (x, y) in [0, 1]."""
    H, W = tab.shape[-2:]
    fx = torch.clamp(x, 0.0, 1.0) * (W - 1)
    fy = torch.clamp(y, 0.0, 1.0) * (H - 1)
    x0 = torch.clamp(fx.to(torch.int64), 0, W - 2)
    y0 = torch.clamp(fy.to(torch.int64), 0, H - 2)
    tx = fx - x0
    ty = fy - y0
    pre = () if s is None else (s,)
    v00 = tab[pre + (y0, x0)]
    v01 = tab[pre + (y0, x0 + 1)]
    v10 = tab[pre + (y0 + 1, x0)]
    v11 = tab[pre + (y0 + 1, x0 + 1)]
    return (v00 * (1 - tx) + v01 * tx) * (1 - ty) \
        + (v10 * (1 - tx) + v11 * tx) * ty


def _spectra_eval(spectra, s0, w, x, y):
    """spectra (S, 3, H, W) -> rgb (N, 3), bilinear in (x, y), linear in
    the theta slice."""
    S = spectra.shape[0]
    s1 = torch.clamp(s0 + 1, max=S - 1)
    return torch.stack([
        _bilinear2d(spectra[:, c], x, y, s0) * (1.0 - w)
        + _bilinear2d(spectra[:, c], x, y, s1) * w for c in range(3)], -1)


# ---------------------------------------------------------------------------
# BSDF interface (measured.cpp sample / eval / pdf)
# ---------------------------------------------------------------------------

_HALF_PI = math.pi / 2.0


def _u2theta(u):
    return u * u * _HALF_PI


def _theta2u(t):
    return m.sqrt(torch.clamp(t, min=0.0) / _HALF_PI)


def _u2phi(u):
    return (2.0 * u - 1.0) * math.pi


def _phi2u(p):
    return 0.5 * (p / math.pi + 1.0)


def _elevation(d):
    dist = m.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2
                      + (d[..., 2] - 1.0) ** 2)
    return 2.0 * torch.arcsin(torch.clamp(0.5 * dist, -1.0, 1.0))


def _jacobian_scale(md: MeasuredTable, spec, mx, my, theta_i, phi_i):
    nd = _bilinear2d(md.ndf, mx, my)
    sg = _bilinear2d(md.sigma, _theta2u(theta_i), _phi2u(phi_i))
    return spec * (nd / torch.clamp(4.0 * sg, min=1e-12))[..., None]


def measured_sample(md: MeasuredTable, wi, u1, u2):
    """(wo, pdf, weight) of the scene's measured material."""
    theta_i = _elevation(wi)
    phi_i = torch.atan2(wi[..., 1], wi[..., 0])
    s0, w = _slice_of(md.theta_i, theta_i)

    # the luminance warp, then the vndf warp
    u_swap = torch.stack([u2[:, 1], u2[:, 0]], -1)
    lx, ly, lum_pdf = _warp_sample((md.lum_row, md.lum_cond, md.lum_pdf),
                                   s0, w, u_swap)
    mx, my, ndf_pdf = _warp_sample((md.vndf_row, md.vndf_cond, md.vndf_pdf),
                                   s0, w, torch.stack([lx, ly], -1))
    theta_m = _u2theta(mx)
    phi_m = _u2phi(my) + phi_i          # isotropic
    st, ct = torch.sin(theta_m), torch.cos(theta_m)
    sp, cp = torch.sin(phi_m), torch.cos(phi_m)
    m_vec = torch.stack([cp * st, sp * st, ct], -1)

    dot = torch.sum(wi * m_vec, -1)
    wo = 2.0 * dot[..., None] * m_vec - wi
    jac = torch.clamp(2.0 * math.pi ** 2 * mx * st, min=1e-6) * 4.0 * dot
    pdf = ndf_pdf * lum_pdf / torch.clamp(jac, min=1e-12)

    spec = _spectra_eval(md.spectra, s0, w, lx, ly)
    if md.jacobian:
        spec = _jacobian_scale(md, spec, mx, my, theta_i, phi_i)

    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0) & (pdf > 1e-12) \
        & torch.all(torch.isfinite(spec), -1)
    weight = torch.where(ok[..., None],
                         spec / torch.clamp(pdf, min=1e-12)[..., None], 0.0)
    return wo, torch.where(ok, pdf, 0.0), weight


def measured_eval_pdf(md: MeasuredTable, wi, wo):
    """(f * cos (the RGL spectra are cosine-weighted), sampling pdf)."""
    theta_i = _elevation(wi)
    phi_i = torch.atan2(wi[..., 1], wi[..., 0])
    s0, w = _slice_of(md.theta_i, theta_i)

    m_vec = wi + wo
    ml = m.sqrt(torch.sum(m_vec * m_vec, -1))
    m_vec = m_vec / torch.clamp(ml, min=1e-9)[..., None]
    theta_m = _elevation(m_vec)
    phi_m = torch.atan2(m_vec[..., 1], m_vec[..., 0])
    mx = _theta2u(theta_m)
    my = _phi2u(phi_m - phi_i)
    my = my - torch.floor(my)

    lx, ly, ndf_pdf = _warp_invert((md.vndf_row, md.vndf_cond, md.vndf_pdf),
                                   s0, w, mx, my)
    _, _, lum_pdf = _warp_invert((md.lum_row, md.lum_cond, md.lum_pdf),
                                 s0, w, lx, ly)

    spec = _spectra_eval(md.spectra, s0, w, lx, ly)
    if md.jacobian:
        spec = _jacobian_scale(md, spec, mx, my, theta_i, phi_i)

    st = torch.sin(theta_m)
    dot = torch.sum(wi * m_vec, -1)
    jac = torch.clamp(2.0 * math.pi ** 2 * mx * st, min=1e-6) * 4.0 \
        * torch.clamp(dot, min=1e-9)
    pdf = ndf_pdf * lum_pdf / jac

    ok = (wi[..., 2] > 0) & (wo[..., 2] > 0) & (ml > 1e-9)
    return torch.where(ok[..., None], spec, 0.0), \
        torch.where(ok & torch.isfinite(pdf), pdf, 0.0)
