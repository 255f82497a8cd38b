"""The arithmetic entropy decoder of io/jpeg.py (ITU T.81 Annex D, F.2.4
and G.1.3 as libjpeg-turbo's jdarith.c runs them): the Q-coder with Table
D.2's probability estimation, the DC and AC statistics bins with their
DAC conditioning (L, U, Kx; defaults 0, 1, 5), sequential scans and the
four progressive kinds (DC first and refine, AC first and refine).

libjpeg's conventions are kept: a marker met inside the entropy data
makes the decoder read zero bytes from there on; the statistics, the DC
predictions and the coding registers restart at every scan and at every
restart marker; an overflow of the spectral index or of a magnitude
("Corrupt JPEG data") stops the decode of the rest of the restart
interval, leaving its blocks as they were.  Data that ends with no
marker raises OSError, as Pillow does for a truncated file.

The per-bit loop runs in C++ (csrc/jpeg_arith.cpp, built at first use by
host_build.compile_shared; a failed build raises); `_scan_plain` is its
plain Python version with the same contract, and the tests hold the two
equal.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "jpeg_arith.cpp"
_LIB = None

# T.81 Table D.2: Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS; the last
# row (113) is T.851's fixed probability 0.5 that libjpeg codes signs and
# DC refinement bits with
_TABLE_D2 = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]
# libjpeg's packed form (jaricom.c): Qe << 16 | NMPS << 8 | SWITCH << 7
# | NLPS
ARITAB = np.array([(q << 16) | (nm << 8) | (sw << 7) | nl
                   for q, nl, nm, sw in _TABLE_D2], np.int64)
_ARITAB = ARITAB.tolist()
FIXED_BIN = 113
DC_BINS, AC_BINS = 64, 256


def library():
    """Build (once per source hash) and load csrc/jpeg_arith.cpp; raises
    if the compiler fails."""
    global _LIB
    if _LIB is None:
        from ..host_build import BUILD_DIR, compile_shared
        info = compile_shared(_SRC, BUILD_DIR, "JPEG arithmetic decode")
        lib = ctypes.CDLL(info["path"])
        p, i32 = ctypes.c_void_p, ctypes.c_int32
        lib.lrt_jpeg_arith_scan.argtypes = [p, ctypes.c_int64, i32, p, p, p,
                                            p, p, p, i32, i32, i32, i32, i32,
                                            i32, i32, i32, p]
        lib.lrt_jpeg_arith_scan.restype = i32
        _LIB = lib
    return _LIB


def _scan_native(seg: bytes, scan: dict, coefs: list,
                 cond: np.ndarray) -> int:
    """One scan through csrc/jpeg_arith.cpp (see its argument list) -> the
    bytes of seg the decoder read."""
    comp = np.ascontiguousarray(scan["comp"], np.int32)
    ptrs = (ctypes.c_void_p * len(coefs))(*[c.ctypes.data for c in coefs])
    buf = np.frombuffer(seg, np.uint8) if seg else np.zeros(1, np.uint8)
    dc = np.ascontiguousarray(scan["dc"], np.int32)
    ac = np.ascontiguousarray(scan["ac"], np.int32)
    cond = np.ascontiguousarray(cond, np.int32)
    tab = np.ascontiguousarray(ARITAB, np.int64)
    used = ctypes.c_int64(0)
    rc = library().lrt_jpeg_arith_scan(
        buf.ctypes.data, len(seg), len(comp), comp.ctypes.data, ptrs,
        dc.ctypes.data, ac.ctypes.data, cond.ctypes.data, tab.ctypes.data,
        scan["mcux"], scan["mcuy"], scan["ss"], scan["se"], scan["ah"],
        scan["al"], int(scan["progressive"]), scan["restart"],
        ctypes.byref(used))
    if rc == -2:
        raise OSError("image file is truncated")
    if rc != 0:
        raise ValueError(f"JPEG: the arithmetic decode failed ({rc})")
    return used.value


class _Decoder:
    """The Q-coder's registers and libjpeg's byte source (get_byte, the
    unread marker, read_restart_marker with jpeg_resync_to_restart)."""

    def __init__(self, data: bytes):
        self.d, self.pos = data, 0
        self.unread = 0
        self.next_rst = 0
        self.reset()

    def reset(self):
        self.c, self.a, self.ct = 0, 0, -16

    def _byte(self) -> int:
        if self.pos >= len(self.d):
            raise OSError("image file is truncated")
        b = self.d[self.pos]
        self.pos += 1
        return b

    def decode(self, st: bytearray, i: int) -> int:
        while self.a < 0x8000:
            self.ct -= 1
            if self.ct < 0:
                if self.unread:
                    data = 0
                else:
                    data = self._byte()
                    if data == 0xFF:
                        data = self._byte()
                        while data == 0xFF:
                            data = self._byte()
                        if data == 0:
                            data = 0xFF
                        else:
                            self.unread, data = data, 0
                self.c = (self.c << 8) | data
                self.ct += 8
                if self.ct < 0:
                    self.ct += 1
                    if self.ct == 0:
                        self.a = 0x8000
            self.a <<= 1
        sv = st[i]
        qe = _ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        temp = self.a - qe
        self.a = temp
        temp <<= self.ct
        if self.c >= temp:
            self.c -= temp
            if self.a < qe:
                self.a = qe
                st[i] = (sv & 0x80) ^ nm
            else:
                self.a = qe
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif self.a < 0x8000:
            if self.a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        return sv >> 7

    def _next_marker(self):
        """jdmarker.c next_marker: skip to the next 0xFF xx, xx not 0."""
        while True:
            c = self._byte()
            while c != 0xFF:
                c = self._byte()
            c = self._byte()
            while c == 0xFF:
                c = self._byte()
            if c != 0:
                self.unread = c
                return

    def restart(self):
        """read_restart_marker, then the decoder's re-initialisation."""
        if self.unread == 0:
            self._next_marker()
        want = self.next_rst
        if self.unread == 0xD0 + want:
            self.unread = 0
        else:                            # jpeg_resync_to_restart
            marker = self.unread
            while True:
                if marker < 0xC0:
                    action = 2
                elif marker < 0xD0 or marker > 0xD7:
                    action = 3
                elif marker in (0xD0 + ((want + 1) & 7),
                                0xD0 + ((want + 2) & 7)):
                    action = 3
                elif marker in (0xD0 + ((want - 1) & 7),
                                0xD0 + ((want - 2) & 7)):
                    action = 2
                else:
                    action = 1
                if action == 1:
                    self.unread = 0
                    break
                if action == 3:
                    break
                self._next_marker()
                marker = self.unread
        self.next_rst = (want + 1) & 7
        self.reset()


def _scan_plain(seg: bytes, scan: dict, coefs: list,
                cond: np.ndarray) -> int:
    """The arithmetic decode loop in Python (the plain version of
    csrc/jpeg_arith.cpp, same arguments and result): `cond` is (16, 3)
    int32, each table's DAC conditioning L, U (DC) and Kx (AC)."""
    e = _Decoder(seg)
    ss, se, ah, al = scan["ss"], scan["se"], scan["ah"], scan["al"]
    prog = scan["progressive"]
    comp = scan["comp"]
    dct, act = scan["dc"], scan["ac"]
    dc_stats = [bytearray(DC_BINS) for _ in range(16)]
    ac_stats = [bytearray(AC_BINS) for _ in range(16)]
    fixed = bytearray([FIXED_BIN])
    last_dc = [0, 0, 0, 0]
    dc_ctx = [0, 0, 0, 0]

    def reset_stats():
        for ci in range(len(comp)):
            if not prog or (ss == 0 and ah == 0):
                dc_stats[dct[ci]][:] = bytes(DC_BINS)
                last_dc[ci] = dc_ctx[ci] = 0
            if not prog or ss:
                ac_stats[act[ci]][:] = bytes(AC_BINS)

    def i16(v):
        return ((v + 0x8000) & 0xFFFF) - 0x8000

    def dc_diff(ci):
        """F.19 - F.24 for one DC difference -> the new prediction, or
        None on a magnitude overflow."""
        tbl = dct[ci]
        stats = dc_stats[tbl]
        s0 = dc_ctx[ci]
        if e.decode(stats, s0) == 0:
            dc_ctx[ci] = 0
            return last_dc[ci]
        sign = e.decode(stats, s0 + 1)
        st = s0 + 2 + sign
        m = e.decode(stats, st)
        if m:
            st = 20
            while e.decode(stats, st):
                m <<= 1
                if m == 0x8000:
                    return None
                st += 1
        lo = (1 << int(cond[tbl, 0])) >> 1
        hi = (1 << int(cond[tbl, 1])) >> 1
        dc_ctx[ci] = 0 if m < lo else (12 + 4 * sign if m > hi
                                       else 4 + 4 * sign)
        v = m
        st += 14
        m >>= 1
        while m:
            if e.decode(stats, st):
                v |= m
            m >>= 1
        v += 1
        if sign:
            v = -v
        last_dc[ci] = (last_dc[ci] + v) & 0xFFFF
        return last_dc[ci]

    def ac_value(tbl, st, k):
        """F.21 - F.24 after a coefficient's nonzero decision at bin st
        (3 * (k - 1)) -> the signed value, or None on overflow."""
        stats = ac_stats[tbl]
        sign = e.decode(fixed, 0)
        st += 2
        m = e.decode(stats, st)
        if m:
            if e.decode(stats, st):
                m <<= 1
                st = 189 if k <= int(cond[tbl, 2]) else 217
                while e.decode(stats, st):
                    m <<= 1
                    if m == 0x8000:
                        return None
                    st += 1
        v = m
        st += 14
        m >>= 1
        while m:
            if e.decode(stats, st):
                v |= m
            m >>= 1
        v += 1
        return -v if sign else v

    def ac_run(tbl, k, last):
        """The zero run from coefficient k: -> (k of the next nonzero
        coefficient, its bin), or None past `last` (overflow)."""
        stats = ac_stats[tbl]
        st = 3 * (k - 1)
        while e.decode(stats, st + 1) == 0:
            st += 3
            k += 1
            if k > last:
                return None
        return k, st

    state = {"error": False}
    def block(c, ci):
        """One block of the scan; False on an overflow (libjpeg's ct = -1,
        the rest of the interval skipped)."""
        if not prog:
            v = dc_diff(ci)
            if v is None:
                return False
            c[0] = i16(v)
            tbl = act[ci]
            k = 1
            while k <= 63:
                if e.decode(ac_stats[tbl], 3 * (k - 1)):
                    break
                run = ac_run(tbl, k, 63)
                if run is None:
                    return False
                k, st = run
                v = ac_value(tbl, st, k)
                if v is None:
                    return False
                c[k] = i16(v)
                k += 1
            return True
        if ss == 0 and ah == 0:
            v = dc_diff(ci)
            if v is None:
                return False
            c[0] = i16(v << al)
            return True
        if ss == 0:
            if e.decode(fixed, 0):
                c[0] = i16(int(c[0]) | (1 << al))
            return True
        tbl = act[ci]
        if ah == 0:
            k = ss
            while k <= se:
                if e.decode(ac_stats[tbl], 3 * (k - 1)):
                    break
                run = ac_run(tbl, k, se)
                if run is None:
                    return False
                k, st = run
                v = ac_value(tbl, st, k)
                if v is None:
                    return False
                c[k] = i16(v << al)
                k += 1
            return True
        p1, m1 = 1 << al, -(1 << al)
        stats = ac_stats[tbl]
        kex = se
        while kex > 0 and c[kex] == 0:
            kex -= 1
        k = ss
        while k <= se:
            st = 3 * (k - 1)
            if k > kex and e.decode(stats, st):
                break
            while True:
                v = int(c[k])
                if v:
                    if e.decode(stats, st + 2):
                        c[k] = i16(v + (m1 if v < 0 else p1))
                    break
                if e.decode(stats, st + 1):
                    c[k] = m1 if e.decode(fixed, 0) else p1
                    break
                st += 3
                k += 1
                if k > se:
                    return False
            k += 1
        return True

    reset_stats()
    n_mcu = comp[0][1] * comp[0][2] if len(comp) == 1 \
        else scan["mcux"] * scan["mcuy"]
    to_go = scan["restart"]
    for m in range(n_mcu):
        if scan["restart"] > 0:
            if to_go == 0:
                e.restart()
                reset_stats()
                state["error"] = False
                to_go = scan["restart"]
            to_go -= 1
        if state["error"]:
            continue
        for ci, (stride, cbw, _, ch, cv, arr) in enumerate(comp):
            co = coefs[arr]
            if len(comp) == 1:
                blocks = [co[m // cbw, m % cbw]]
            else:
                my, mx = divmod(m, scan["mcux"])
                blocks = [co[my * cv + vy, mx * ch + hx]
                          for vy in range(cv) for hx in range(ch)]
            for c in blocks:
                if not block(c, ci):
                    state["error"] = True
                    break
            if state["error"]:
                break
    return e.pos
