"""JPEG 2000 tier-2 (ISO 15444-1 Annex B.9-B.12) as OpenJPEG 2.5.4 reads
and writes it: the packet header's bit reader and writer (a 0xFF byte is
followed by seven bits), the inclusion and zero-bitplane tag trees, the
coding-pass counts and the comma code, and the order packets come in.

`packets(tile, tcp)` yields (layer, resolution, component, precinct) in
the tile's progression orders as opj_pi_next does: one iterator per POC
entry (or one for the COD order), all sharing one record of the packets
already seen, so a packet a later entry names again is skipped.  The
position orders (RPCL, PCRL, CPRL) step through the tile's reference grid
by the smallest precinct step of any component and resolution and take
the precinct whose corner (or the tile's edge) lies there.

`read_header` decodes one packet's header into its code-blocks (the
passes and bytes each codeword segment gains), and `write_header` writes
one for the encoder, with its empty-header bit always 1 as OpenJPEG
writes it.
"""
from __future__ import annotations

from .j2k_t1 import LAZY, TERMALL


class Bio:
    """opj_bio_* on a bytes object from `start` up to `end`."""

    def __init__(self, data=b"", start=0, end=None):
        self.data = data
        self.start = self.bp = start
        self.end = len(data) if end is None else end
        self.buf = 0
        self.ct = 0
        self.out = bytearray()

    # reading
    def _bytein(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.bp >= self.end:
            return
        self.buf |= self.data[self.bp]
        self.bp += 1

    def read(self, n: int) -> int:
        v = 0
        for i in range(n - 1, -1, -1):
            if self.ct == 0:
                self._bytein()
            self.ct -= 1
            v |= ((self.buf >> self.ct) & 1) << i
        return v

    def inalign(self):
        if (self.buf & 0xFF) == 0xFF:
            self._bytein()
        self.ct = 0

    def numbytes(self) -> int:
        return self.bp - self.start

    # writing (init_enc: buf 0, ct 8)
    def _byteout(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        self.out.append(self.buf >> 8)

    def write(self, v: int, n: int):
        for i in range(n - 1, -1, -1):
            if self.ct == 0:
                self._byteout()
            self.ct -= 1
            self.buf |= ((v >> i) & 1) << self.ct

    def flush(self) -> bytes:
        self._byteout()
        if self.ct == 7:
            self._byteout()
        return bytes(self.out)


def writer() -> Bio:
    b = Bio()
    b.ct = 8
    return b


class TagTree:
    """opj_tgt_* over a w x h grid of leaves."""

    def __init__(self, w: int, h: int):
        self.parent = []
        dims = [(w, h)]
        while dims[-1][0] * dims[-1][1] > 1:
            pw, ph = dims[-1]
            dims.append(((pw + 1) // 2, (ph + 1) // 2))
        base = 0
        for lvl, (pw, ph) in enumerate(dims):
            nxt = base + pw * ph
            for y in range(ph):
                for x in range(pw):
                    if lvl + 1 < len(dims):
                        qw = dims[lvl + 1][0]
                        self.parent.append(nxt + (y // 2) * qw + x // 2)
                    else:
                        self.parent.append(-1)
            base = nxt
        self.reset()

    def reset(self):
        n = len(self.parent)
        self.value = [999] * n
        self.low = [0] * n
        self.known = [0] * n

    def set_value(self, leaf: int, v: int):
        node = leaf
        while node >= 0 and self.value[node] > v:
            self.value[node] = v
            node = self.parent[node]

    def _path(self, leaf: int) -> list:
        path = []
        node = leaf
        while node >= 0:
            path.append(node)
            node = self.parent[node]
        return path[::-1]

    def decode(self, bio: Bio, leaf: int, threshold: int) -> int:
        low = 0
        node = leaf
        for node in self._path(leaf):
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold and low < self.value[node]:
                if bio.read(1):
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
        return 1 if self.value[node] < threshold else 0

    def encode(self, bio: Bio, leaf: int, threshold: int):
        low = 0
        for node in self._path(leaf):
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold:
                if low >= self.value[node]:
                    if not self.known[node]:
                        bio.write(1, 1)
                        self.known[node] = 1
                    break
                bio.write(0, 1)
                low += 1
            self.low[node] = low


def _getnumpasses(bio: Bio) -> int:
    if not bio.read(1):
        return 1
    if not bio.read(1):
        return 2
    n = bio.read(2)
    if n != 3:
        return 3 + n
    n = bio.read(5)
    if n != 31:
        return 6 + n
    return 37 + bio.read(7)


def _putnumpasses(bio: Bio, n: int):
    if n == 1:
        bio.write(0, 1)
    elif n == 2:
        bio.write(2, 2)
    elif n <= 5:
        bio.write(0xC | (n - 3), 4)
    elif n <= 36:
        bio.write(0x1E0 | (n - 6), 9)
    else:
        bio.write(0xFF80 | (n - 37), 16)


def floorlog2(a: int) -> int:
    """opj_int_floorlog2 (0 for a <= 1)."""
    return max(a.bit_length() - 1, 0)


def _maxpasses(cblksty: int, prev, first: bool) -> int:
    """opj_t2_init_seg: the passes a new codeword segment holds."""
    if cblksty & TERMALL:
        return 1
    if cblksty & LAZY:
        if first:
            return 10
        return 2 if prev in (1, 10) else 1
    return 109


class HeaderError(Exception):
    """opj_t2_read_packet_header refuses the packet (the tile fails)."""


def read_header(bio: Bio, bands, precno: int, layno: int, cblksty: int,
                numbps_of) -> list:
    """The body of opj_t2_read_packet_header after its empty-packet bit
    (which the caller read and found 1) -> [(code-block, [(segment
    index, its most passes, new passes, new bytes)])] of the included
    code-blocks, in order.
    `bands`: the resolution's non-empty bands; a code-block is a dict
    with "segs" (each [maxpasses, passes]) kept across layers."""
    out = []
    for band in bands:
        prc = band["precincts"][precno]
        for cbi, cb in enumerate(prc["cblks"]):
            if not cb["segs"]:
                inc = prc["incl"].decode(bio, cbi, layno + 1)
            else:
                inc = bio.read(1)
            if not inc:
                continue
            if not cb["segs"]:
                i = 0
                while not prc["imsb"].decode(bio, cbi, i):
                    i += 1
                cb["numbps"] = numbps_of(band, i)
                cb["numlenbits"] = 3
            newpasses = _getnumpasses(bio)
            n = 0
            while bio.read(1):
                n += 1
            cb["numlenbits"] += n
            segs = cb["segs"]
            pending = [[s[0], s[1]] for s in segs]
            if not pending:
                pending.append([_maxpasses(cblksty, None, True), 0])
            elif pending[-1][1] == pending[-1][0]:
                pending.append([_maxpasses(cblksty, pending[-1][0], False),
                                0])
            segno = len(pending) - 1
            left = newpasses
            parts = []
            while True:
                take = min(pending[segno][0] - pending[segno][1], left)
                bits = cb["numlenbits"] + floorlog2(take)
                if bits > 32:
                    raise HeaderError(f"Invalid bit number {bits}")
                parts.append((segno, pending[segno][0], take, bio.read(bits)))
                left -= take
                if left <= 0:
                    break
                pending.append([_maxpasses(cblksty, pending[segno][0], False),
                                0])
                segno += 1
            out.append((cb, parts))
    return out


def write_header(bands, precno: int, layno: int) -> Bio:
    """opj_t2_encode_packet's header for one layer (every code-block's
    "layers"[layno] = (passes, [(pass length, terminated)]))."""
    bio = writer()
    bio.write(1, 1)
    for band in bands:
        prc = band["precincts"][precno]
        cblks = prc["cblks"]
        if layno == 0:
            prc["incl"].reset()
            prc["imsb"].reset()
            for cbi, cb in enumerate(cblks):
                cb["numpasses"] = 0
                prc["imsb"].set_value(cbi, band["numbps"] - cb["numbps"])
        for cbi, cb in enumerate(cblks):
            if not cb["numpasses"] and cb["layers"][layno][0]:
                prc["incl"].set_value(cbi, layno)
        for cbi, cb in enumerate(cblks):
            npasses, lens = cb["layers"][layno][:2]
            if not cb["numpasses"]:
                prc["incl"].encode(bio, cbi, layno + 1)
            else:
                bio.write(1 if npasses else 0, 1)
            if not npasses:
                continue
            if not cb["numpasses"]:
                cb["numlenbits"] = 3
                prc["imsb"].encode(bio, cbi, 999)
            _putnumpasses(bio, npasses)
            segs = []
            nump = total = 0
            for k, (ln, term) in enumerate(lens):
                nump += 1
                total += ln
                if term or k == len(lens) - 1:
                    segs.append((total, nump))
                    nump = total = 0
            inc = 0
            for total, nump in segs:
                inc = max(inc, floorlog2(total) + 1
                          - (cb["numlenbits"] + floorlog2(nump)))
            bio.write((1 << inc) - 1 << 1, inc + 1)
            cb["numlenbits"] += inc
            for total, nump in segs:
                bio.write(total, cb["numlenbits"] + floorlog2(nump))
            cb["numpasses"] += npasses
    return bio


# ---------------------------------------------------- packet iteration ----
def _ceildiv(a: int, b: int) -> int:
    return -(-a // b)


def packets(tile: dict, tcp: dict):
    """opj_pi_create_decode / opj_pi_next over the tile: yields (layer,
    resolution, component, precinct)."""
    comps = tile["comps"]
    max_res = max(c["numres"] for c in comps)
    max_prec = max((r["pw"] * r["ph"] for c in comps for r in c["res"]),
                   default=0)
    ncomp = len(comps)
    step_c = max_prec
    step_r = ncomp * step_c
    step_l = max_res * step_r
    size = (tcp["numlayers"] + 1) * step_l
    seen = set()
    if tcp["pocs"]:
        entries = [dict(p) for p in tcp["pocs"]]
        for e in entries:
            e["layno1"] = min(e["layno1"], tcp["numlayers"])
    else:
        entries = [dict(prg=tcp["prg"], resno0=0, compno0=0,
                        layno1=tcp["numlayers"], resno1=max_res,
                        compno1=ncomp)]
    for e in entries:
        # opj_pi_next gives up on an unknown order or component range
        if e["prg"] > 4 or e["compno0"] >= ncomp or e["compno1"] > ncomp:
            continue
        it = _ORDERS[e["prg"]](tile, comps, e, max_res)
        for lay, res, comp, prec in it:
            index = lay * step_l + res * step_r + comp * step_c + prec
            if index >= size:
                break
            if index in seen:
                continue
            seen.add(index)
            yield lay, res, comp, prec


def _lrcp(tile, comps, e, max_res):
    for lay in range(0, e["layno1"]):
        for r in range(e["resno0"], e["resno1"]):
            for c in range(e["compno0"], e["compno1"]):
                if r >= comps[c]["numres"]:
                    continue
                res = comps[c]["res"][r]
                for p in range(res["pw"] * res["ph"]):
                    yield lay, r, c, p


def _rlcp(tile, comps, e, max_res):
    for r in range(e["resno0"], e["resno1"]):
        for lay in range(0, e["layno1"]):
            for c in range(e["compno0"], e["compno1"]):
                if r >= comps[c]["numres"]:
                    continue
                res = comps[c]["res"][r]
                for p in range(res["pw"] * res["ph"]):
                    yield lay, r, c, p


def _steps(comps) -> tuple:
    """The smallest precinct step in the reference grid (pi->dx, dy)."""
    dx = dy = 0
    for comp in comps:
        n = comp["numres"]
        for r, res in enumerate(comp["res"]):
            sx = res["pdx"] + n - 1 - r
            sy = res["pdy"] + n - 1 - r
            if sx < 32 and comp["dx"] <= 0xFFFFFFFF // (1 << sx):
                v = comp["dx"] * (1 << sx)
                dx = v if not dx else min(dx, v)
            if sy < 32 and comp["dy"] <= 0xFFFFFFFF // (1 << sy):
                v = comp["dy"] * (1 << sy)
                dy = v if not dy else min(dy, v)
    return dx, dy


def _precinct_at(tile, comp, r, x, y):
    """The precinct of component `comp`, resolution r at reference grid
    point (x, y), or None where opj_pi_next_* skips the point."""
    if r >= comp["numres"]:
        return None
    res = comp["res"][r]
    levelno = comp["numres"] - 1 - r
    dx, dy = comp["dx"], comp["dy"]
    if levelno >= 32 or ((dx << levelno) >> levelno) != dx:
        return None
    tx0, ty0, tx1, ty1 = tile["x0"], tile["y0"], tile["x1"], tile["y1"]
    trx0 = _ceildiv(tx0, dx << levelno)
    try0 = _ceildiv(ty0, dy << levelno)
    trx1 = _ceildiv(tx1, dx << levelno)
    try1 = _ceildiv(ty1, dy << levelno)
    rpx = res["pdx"] + levelno
    rpy = res["pdy"] + levelno
    if rpx >= 31 or rpy >= 31:
        return None
    if not (y % (dy << rpy) == 0
            or (y == ty0 and (try0 << levelno) % (1 << rpy))):
        return None
    if not (x % (dx << rpx) == 0
            or (x == tx0 and (trx0 << levelno) % (1 << rpx))):
        return None
    if res["pw"] == 0 or res["ph"] == 0:
        return None
    if trx0 == trx1 or try0 == try1:
        return None
    prci = (_ceildiv(x, dx << levelno) >> res["pdx"]) - (trx0 >> res["pdx"])
    prcj = (_ceildiv(y, dy << levelno) >> res["pdy"]) - (try0 >> res["pdy"])
    return prci + prcj * res["pw"]


def _grid(tile, dx, dy):
    y = tile["y0"]
    while y < tile["y1"]:
        x = tile["x0"]
        while x < tile["x1"]:
            yield x, y
            x += dx - (x % dx)
        y += dy - (y % dy)


def _rpcl(tile, comps, e, max_res):
    dx, dy = _steps(comps)
    if not dx or not dy:
        return
    for r in range(e["resno0"], e["resno1"]):
        for x, y in _grid(tile, dx, dy):
            for c in range(e["compno0"], e["compno1"]):
                p = _precinct_at(tile, comps[c], r, x, y)
                if p is None:
                    continue
                for lay in range(0, e["layno1"]):
                    yield lay, r, c, p


def _pcrl(tile, comps, e, max_res):
    dx, dy = _steps(comps)
    if not dx or not dy:
        return
    for x, y in _grid(tile, dx, dy):
        for c in range(e["compno0"], e["compno1"]):
            for r in range(e["resno0"], min(e["resno1"],
                                            comps[c]["numres"])):
                p = _precinct_at(tile, comps[c], r, x, y)
                if p is None:
                    continue
                for lay in range(0, e["layno1"]):
                    yield lay, r, c, p


def _cprl(tile, comps, e, max_res):
    for c in range(e["compno0"], e["compno1"]):
        dx, dy = _steps([comps[c]])
        if not dx or not dy:
            return
        for x, y in _grid(tile, dx, dy):
            for r in range(e["resno0"], min(e["resno1"],
                                            comps[c]["numres"])):
                p = _precinct_at(tile, comps[c], r, x, y)
                if p is None:
                    continue
                for lay in range(0, e["layno1"]):
                    yield lay, r, c, p


_ORDERS = (_lrcp, _rlcp, _rpcl, _pcrl, _cprl)
