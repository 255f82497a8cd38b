"""CIELab images as Pillow 12.1 converts them to RGB (`Image.convert("RGB")`
of a "LAB" image), with numpy and no colour library.

Pillow builds the conversion with LittleCMS 2 (`ImageCms.buildTransform`
from `createProfile("LAB")`, Lab D50 in its version 2 encoding, to
`createProfile("sRGB")`, perceptual intent) and LittleCMS optimises it by
resampling: a 33 x 33 x 33 16-bit table of the float pipeline Lab -> XYZ
-> the inverse of sRGB's colorant matrix (Rec. 709 primaries, white
x 0.3127 y 0.3290, Bradford-adapted to D50) -> the inverse of sRGB's
parametric curve, evaluated at each node, then tetrahedral interpolation
of the 8-bit input (x * 257) in LittleCMS's 16.16 fixed point and the
16-to-8-bit rounding of its packer.  The node values follow its
arithmetic step by step: the 3 x 3 matrices in double by its cofactor
inverse and its row-by-column products, each stage's output rounded to
float, the words saturated by its magic-number floor.
"""
from __future__ import annotations

import numpy as np

GRID = 33
_D50 = (0.9642, 1.0, 0.8249)
_BRADFORD = ((0.8951, 0.2664, -0.1614), (-0.7502, 1.7135, 0.0367),
             (0.0389, -0.0685, 1.0296))
_MAX_ENCODEABLE_XYZ = 1.0 + 32767.0 / 32768.0
# sRGB's parametric curve (type 4): gamma, a, b, c, d
_SRGB = (2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045)
_TABLE = None


def _per(a, b):
    """_cmsMAT3per: a x b."""
    return tuple(tuple(a[i][0] * b[0][j] + a[i][1] * b[1][j]
                       + a[i][2] * b[2][j] for j in range(3))
                 for i in range(3))


def _inverse(a):
    """_cmsMAT3inverse (cofactors over the determinant)."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return ((c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det),
            (c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det),
            (c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det))


def _eval(a, v):
    """_cmsMAT3eval: a x v."""
    return tuple(a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2]
                 for i in range(3))


def _srgb_to_d50_xyz():
    """cmsCreate_sRGBProfile's colorants: _cmsBuildRGB2XYZtransferMatrix,
    then _cmsAdaptMatrixToD50 (Bradford)."""
    xn, yn = 0.3127, 0.3290
    prim = ((0.64, 0.33), (0.30, 0.60), (0.15, 0.06))
    p = (tuple(x for x, _ in prim), tuple(y for _, y in prim),
         tuple(1 - x - y for x, y in prim))
    coef = _eval(_inverse(p), (xn / yn, 1.0, (1.0 - xn - yn) / yn))
    m = tuple(tuple(coef[j] * p[i][j] for j in range(3)) for i in range(3))
    src = ((xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0)
    cs, cd = _eval(_BRADFORD, src), _eval(_BRADFORD, _D50)
    cone = ((cd[0] / cs[0], 0.0, 0.0), (0.0, cd[1] / cs[1], 0.0),
            (0.0, 0.0, cd[2] / cs[2]))
    adapt = _per(_inverse(_BRADFORD), _per(cone, _BRADFORD))
    return _per(adapt, m)


def _saturate_word(d: np.ndarray) -> np.ndarray:
    """_cmsQuickSaturateWord: d + 0.5, floored after rounding to 1/65536
    (the magic-number floor), clamped to 0..65535."""
    d = np.asarray(d, np.float64) + 0.5
    w = np.floor(np.rint((d - 32767.0) * 65536.0) / 65536.0) + 32767.0
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, w)) \
        .astype(np.int64)


def _pipeline(lab: np.ndarray) -> np.ndarray:
    """The float pipeline on (N, 3) float32 Lab in 0..1 (version 4 16-bit
    encoding / 65535) -> (N, 3) float32 RGB."""
    L = lab[:, 0].astype(np.float64) * 100.0
    a = lab[:, 1].astype(np.float64) * 255.0 - 128.0
    b = lab[:, 2].astype(np.float64) * 255.0 - 128.0

    def f_1(t):
        return np.where(t <= 24.0 / 116.0,
                        (108.0 / 841.0) * (t - 16.0 / 116.0), t * t * t)

    y = (L + 16.0) / 116.0
    xyz = [(f_1(y + 0.002 * a) * _D50[0]) / _MAX_ENCODEABLE_XYZ,
           (f_1(y) * _D50[1]) / _MAX_ENCODEABLE_XYZ,
           (f_1(y - 0.005 * b) * _D50[2]) / _MAX_ENCODEABLE_XYZ]
    xyz = [v.astype(np.float32).astype(np.float64) for v in xyz]
    inv = _inverse(_srgb_to_d50_xyz())
    g, pa, pb, pc, pd = _SRGB
    disc = (pa * pd + pb) ** g
    out = []
    for i in range(3):
        r = np.zeros(len(lab))
        for j in range(3):
            r = r + xyz[j] * (inv[i][j] * _MAX_ENCODEABLE_XYZ)
        r = r.astype(np.float32).astype(np.float64)
        e = np.power(np.maximum(r, disc), 1.0 / g)
        out.append(np.where(r >= disc, (e - pb) / pa, r / pc)
                   .astype(np.float32))
    return np.stack(out, -1)


def table() -> np.ndarray:
    """The resampled 33^3 x 3 table of 16-bit words (computed once)."""
    global _TABLE
    if _TABLE is None:
        q = _saturate_word(np.arange(GRID) * 65535.0 / (GRID - 1))
        grid = np.stack(np.meshgrid(q, q, q, indexing="ij"), -1) \
            .reshape(-1, 3)
        out = _pipeline((grid / 65535.0).astype(np.float32))
        _TABLE = _saturate_word(out.astype(np.float64) * 65535.0) \
            .reshape(GRID, GRID, GRID, 3)
    return _TABLE


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 in Pillow's LAB encoding (L 0..255 for 0..100, a and
    b with 128 for 0) -> (..., 3) uint8 RGB as Pillow converts it."""
    shape = lab.shape
    v = lab.reshape(-1, 3).astype(np.int64) * 257 * (GRID - 1)
    f = v + (v + 0x7FFF) // 0xFFFF                    # _cmsToFixedDomain
    i0, r = f >> 16, f & 0xFFFF
    i1 = np.minimum(i0 + (r != 0), GRID - 1)
    tab = table()
    x0, y0, z0 = i0.T
    x1, y1, z1 = i1.T
    rx, ry, rz = (r[:, k:k + 1] for k in range(3))

    def t(x, y, z):
        return tab[x, y, z]

    c0 = t(x0, y0, z0)
    # the six tetrahedra of Eval3Inputs, in its order of tests
    cases = (
        ((rx >= ry) & (ry >= rz),
         lambda: (t(x1, y0, z0) - c0, t(x1, y1, z0) - t(x1, y0, z0),
                  t(x1, y1, z1) - t(x1, y1, z0))),
        ((rx >= rz) & (rz >= ry),
         lambda: (t(x1, y0, z0) - c0, t(x1, y1, z1) - t(x1, y0, z1),
                  t(x1, y0, z1) - t(x1, y0, z0))),
        ((rz >= rx) & (rx >= ry),
         lambda: (t(x1, y0, z1) - t(x0, y0, z1),
                  t(x1, y1, z1) - t(x1, y0, z1), t(x0, y0, z1) - c0)),
        ((ry >= rx) & (rx >= rz),
         lambda: (t(x1, y1, z0) - t(x0, y1, z0), t(x0, y1, z0) - c0,
                  t(x1, y1, z1) - t(x1, y1, z0))),
        ((ry >= rz) & (rz >= rx),
         lambda: (t(x1, y1, z1) - t(x0, y1, z1), t(x0, y1, z0) - c0,
                  t(x0, y1, z1) - t(x0, y1, z0))),
        ((rz >= ry) & (ry >= rx),
         lambda: (t(x1, y1, z1) - t(x0, y1, z1),
                  t(x0, y1, z1) - t(x0, y0, z1), t(x0, y0, z1) - c0)))
    out = np.zeros_like(c0)
    done = np.zeros((len(c0), 1), bool)
    for cond, diffs in cases:
        take = cond & ~done
        c1, c2, c3 = diffs()
        rest = c1 * rx + c2 * ry + c3 * rz + 0x8001
        out = np.where(take, c0 + ((rest + (rest >> 16)) >> 16), out)
        done |= take
    rgb = ((out * 65281 + 8388608) >> 24) & 0xFF        # FROM_16_TO_8
    return rgb.astype(np.uint8).reshape(shape)
