"""JPEG 2000's wavelets (ISO 15444-1 Annex F) as OpenJPEG 2.5.4 computes
them, in numpy.

- the reversible 5/3 in int32 (exact, so any order of its lifting
  steps gives OpenJPEG's result); a one-sample line whose sample is
  high-pass is halved with C's truncation, as opj_idwt53_h does.
- the irreversible 9/7 in float32 in opj_v8dwt_decode's
  order: the low samples scaled by K and the high ones by 2/K (OpenJPEG's
  `two_invK`, which its dequantisation compensates), then the four
  lifting steps, each `x += (left + right) * c` in float32 with no fused
  multiply-add, mirrored at the ends; a one-sample line stays as it is.
  Each level runs over the rows first, then the columns.
- `forward_53`: opj_dwt_encode's reversible transform, columns first,
  then rows, from an even origin (Pillow's save puts the image at 0, 0).

A level's sub-bands are (LL, HL, LH, HH) arrays; `x0` / `y0` are the
resolution's origin, whose parity says whether its first sample is low-
or high-pass (`cas`).
"""
from __future__ import annotations

import numpy as np

# dwt.c's 9/7 lifting constants
_ALPHA = np.float32(-1.586134342)
_BETA = np.float32(-0.052980118)
_GAMMA = np.float32(0.882911075)
_DELTA = np.float32(0.443506852)
_K = np.float32(1.230174105)
_TWO_INV_K = np.float32(1.625732422)


def _line_53(low: np.ndarray, high: np.ndarray, cas: int) -> np.ndarray:
    """One level along the last axis: (..., sn) lows and (..., dn) highs
    -> (..., sn + dn) samples."""
    sn, dn = low.shape[-1], high.shape[-1]
    n = sn + dn
    out = np.empty(low.shape[:-1] + (n,), np.int32)
    low = low.astype(np.int32)             # OpenJPEG's int32 arithmetic
    high = high.astype(np.int32)
    if cas == 0:
        if n > 1:
            i = np.arange(sn)
            hl = high[..., np.clip(i - 1, 0, dn - 1)]
            hr = high[..., np.clip(i, 0, dn - 1)]
            low = low - ((hl + hr + 2) >> 2)
            j = np.arange(dn)
            high = high + ((low[..., j] + low[..., np.clip(j + 1, 0,
                                                              sn - 1)]) >> 1)
        out[..., 0::2] = low
        out[..., 1::2] = high
    else:
        if n == 1:
            out[..., 0] = _cdiv2(high[..., 0])
            return out
        i = np.arange(sn)
        low = low - ((high[..., np.clip(i, 0, dn - 1)]
                      + high[..., np.clip(i + 1, 0, dn - 1)] + 2) >> 2)
        j = np.arange(dn)
        high = high + ((low[..., np.clip(j - 1, 0, sn - 1)]
                        + low[..., np.clip(j, 0, sn - 1)]) >> 1)
        out[..., 0::2] = high
        out[..., 1::2] = low
    return out


def _cdiv2(v: np.ndarray) -> np.ndarray:
    """C's v / 2 on integers (truncation toward zero)."""
    return np.where(v < 0, -((-v) // 2), v // 2)


def _line_97(low: np.ndarray, high: np.ndarray, cas: int) -> np.ndarray:
    """opj_v8dwt_decode along the last axis, float32."""
    sn, dn = low.shape[-1], high.shape[-1]
    n = sn + dn
    out = np.empty(low.shape[:-1] + (n,), np.float32)
    lo = low.astype(np.float32, copy=True)
    hi = high.astype(np.float32, copy=True)
    trivial = not (dn > 0 or sn > 1) if cas == 0 else not (sn > 0 or dn > 1)
    if not trivial:
        lo *= _K
        hi *= _TWO_INV_K
        # lows: neighbours high[i - 1 + cas], high[i + cas]; highs:
        # low[j - cas], low[j + 1 - cas] (each mirrored into range)
        _step(lo, hi, cas, -_DELTA)
        _step(hi, lo, 1 - cas, -_GAMMA)
        _step(lo, hi, cas, -_BETA)
        _step(hi, lo, 1 - cas, -_ALPHA)
    if cas == 0:
        out[..., 0::2] = lo
        out[..., 1::2] = hi
    else:
        out[..., 0::2] = hi
        out[..., 1::2] = lo
    return out


def _step(dst: np.ndarray, src: np.ndarray, offset: int, c: np.float32):
    n, m = dst.shape[-1], src.shape[-1]
    if n == 0 or m == 0:
        return
    i = np.arange(n)
    left = src[..., np.clip(i + offset - 1, 0, m - 1)]
    right = src[..., np.clip(i + offset, 0, m - 1)]
    dst += (left + right) * c


def _level(ll, hl, lh, hh, x0: int, y0: int, line) -> np.ndarray:
    """One inverse level: rows (the top ll | hl rows, then lh | hh), then
    columns."""
    cx, cy = x0 & 1, y0 & 1
    top = line(ll, hl, cx)
    bottom = line(lh, hh, cx)
    return np.swapaxes(line(np.swapaxes(top, 0, 1),
                            np.swapaxes(bottom, 0, 1), cy), 0, 1)


def inverse(levels, ll: np.ndarray, reversible: bool) -> np.ndarray:
    """levels: [(hl, lh, hh, x0, y0)] from the lowest resolution up, each
    with the origin of the resolution it builds -> the tile-component's
    samples (int32 for 5/3, float32 for 9/7)."""
    line = _line_53 if reversible else _line_97
    a = ll
    for hl, lh, hh, x0, y0 in levels:
        a = _level(a, hl, lh, hh, x0, y0, line)
    return a


def forward_53(a: np.ndarray, origins) -> tuple:
    """opj_dwt_encode (5/3) of (h, w) int samples; origins: the
    resolutions' (x0, y0) from the full one down -> (ll, [(hl, lh, hh)]
    from the lowest resolution up)."""
    bands = []
    a = a.astype(np.int64)
    for x0, y0 in origins[:-1]:
        cy, cx = y0 & 1, x0 & 1
        lo_v, hi_v = _fwd_53(np.swapaxes(a, 0, 1), cy)
        lo_v, hi_v = np.swapaxes(lo_v, 0, 1), np.swapaxes(hi_v, 0, 1)
        ll, hl = _fwd_53(lo_v, cx)
        lh, hh = _fwd_53(hi_v, cx)
        bands.append((hl, lh, hh))
        a = ll
    return a, bands[::-1]


def _fwd_53(x: np.ndarray, cas: int) -> tuple:
    """One forward 5/3 level along the last axis of a line starting on
    an even coordinate (the writer's only case) -> (lows, highs)."""
    if cas:
        raise ValueError("forward 5/3 from an odd origin")
    s, d = x[..., 0::2].copy(), x[..., 1::2].copy()
    sn, dn = s.shape[-1], d.shape[-1]
    if sn + dn > 1:
        j = np.arange(dn)
        d -= (s[..., j] + s[..., np.clip(j + 1, 0, sn - 1)]) >> 1
        i = np.arange(sn)
        s += (d[..., np.clip(i - 1, 0, dn - 1)]
              + d[..., np.clip(i, 0, dn - 1)] + 2) >> 2
    return s, d
