"""The lossless (ITU T.81 Annex H) Huffman decoder of io/jpeg.py, as
libjpeg-turbo 3's jdlhuff.c, jddiffct.c and jdlossls.c decode a scan: one
Huffman-coded difference per sample (category 16 is 32768), the seven
predictors of Table H.1 on 16-bit wrapped samples, the first row of each
scan and of each restart interval predicted from the left (its first
sample from 2^(P - Pt - 1)), the first column of the other rows from
above, and the point transform Pt applied as libjpeg's scaler does
(sample << Pt, kept to 8 bits).  A restart interval that is not a whole
number of MCU rows is libjpeg's JERR_BAD_RESTART.
"""
from __future__ import annotations

import numpy as np

from .jpeg import BROKEN, _Bits, _decode, _derive, _extend


def geometry(frame: dict):
    """A lossless frame's data units are single samples: each component's
    width and height in samples, and the MCU grid."""
    w, h = frame["w"], frame["h"]
    hmax, vmax = frame["hmax"], frame["vmax"]
    frame["mcux"], frame["mcuy"] = -(-w // hmax), -(-h // vmax)
    for c in frame["comps"]:
        c["w"] = c["bw"] = -(-w * c["h"] // hmax)
        c["hgt"] = c["bh"] = -(-h * c["v"] // vmax)
        c["stride"] = frame["mcux"] * c["h"]


def _undifference(diff: np.ndarray, prev, psv: int, first: bool,
                  initial: int) -> np.ndarray:
    """One row of differences -> samples (jdlossls.c's undifferencers)."""
    n = len(diff)
    out = [0] * n
    d = diff.tolist()
    if first:
        ra = (d[0] + initial) & 0xFFFF
        out[0] = ra
        for x in range(1, n):
            ra = (d[x] + ra) & 0xFFFF
            out[x] = ra
        return out
    rb = prev[0]
    ra = (d[0] + rb) & 0xFFFF
    out[0] = ra
    for x in range(1, n):
        rc, rb = rb, prev[x]
        if psv == 1:
            p = ra
        elif psv == 2:
            p = rb
        elif psv == 3:
            p = rc
        elif psv == 4:
            p = ra + rb - rc
        elif psv == 5:
            p = ra + ((rb - rc) >> 1)
        elif psv == 6:
            p = rb + ((ra - rc) >> 1)
        else:
            p = (ra + rb) >> 1
        ra = (d[x] + p) & 0xFFFF
        out[x] = ra
    return out


def scan(seg: bytes, scan: dict, frame: dict, out: list, tables: np.ndarray):
    """One lossless scan -> out[component] (height, width) uint8 samples
    after the point transform.  scan["comp"] as io/jpeg.py builds it."""
    psv, pt = scan["ss"], scan["al"]
    precision = frame["precision"]
    if not 1 <= psv <= 7 or scan["se"] != 0 or scan["ah"] != 0 \
            or pt >= precision:
        raise OSError(BROKEN)
    comp = scan["comp"]
    tabs = [_derive(tables[i]) for i in range(4)]
    b = _Bits(seg)
    inter = len(comp) > 1
    mcus_row = frame["mcux"] if inter else comp[0][1]
    restart = scan["restart"]
    if restart % mcus_row:
        raise OSError(BROKEN)
    rows_per_restart = restart // mcus_row
    total = frame["mcuy"]
    diffs = [np.zeros((total * cv, mcus_row * ch if inter else cbw),
                      np.int64)
             for (_, cbw, _, ch, cv, _) in comp]
    samples = [[None] * cbh for (_, _, cbh, _, _, _) in comp]
    first = [True] * len(comp)
    initial = 1 << (precision - pt - 1)
    to_go = rows_per_restart
    for imcu in range(total):
        last = imcu == total - 1
        if inter:
            mcu_rows = 1
        else:
            cv, cbh = comp[0][4], comp[0][2]
            mcu_rows = (cbh % cv or cv) if last else cv
        for yoff in range(mcu_rows):
            if restart:
                if to_go == 0:
                    b.restart()
                    to_go = rows_per_restart
                    first = [True] * len(comp)
            for mx in range(mcus_row):
                for ci, (_, _, _, ch, cv, _) in enumerate(comp):
                    t = tabs[scan["dc"][ci]]
                    nv, nh = (cv, ch) if inter else (1, 1)
                    y0 = imcu * cv + (0 if inter else yoff)
                    for vy in range(nv):
                        for hx in range(nh):
                            s = _decode(b, t)
                            if s == 16:
                                s = 32768
                            elif s:
                                s = _extend(b.get(s), s)
                            diffs[ci][y0 + vy, mx * nh + hx] = s
            if restart:
                to_go -= 1
        for ci, (_, cbw, cbh, _, cv, _) in enumerate(comp):
            rows = (cbh % cv or cv) if last else cv
            for r in range(rows):
                y = imcu * cv + r
                prev = samples[ci][y - 1] if y else None
                samples[ci][y] = _undifference(diffs[ci][y, :cbw], prev, psv,
                                               first[ci], initial)
                first[ci] = False
    for ci, (_, _, _, _, _, arr) in enumerate(comp):
        s = np.asarray(samples[ci], np.int64)
        out[arr] = ((s << pt) & 0xFF).astype(np.uint8)
