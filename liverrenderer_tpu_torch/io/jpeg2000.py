"""JPEG 2000 (ISO 15444-1) read as Pillow 12.1 reads it through OpenJPEG
2.5.4, and written as Pillow saves it with its defaults.

Reading follows Jpeg2KDecode.c: opj_read_header (a JP2 file's boxes, then
the codestream's main header), Pillow's checks of the image it describes
and its choice of unpacker, then OpenJPEG's tile API tile by tile
(opj_read_tile_header, opj_decode_tile_data), each tile unpacked into
Pillow's image, which starts black.  Any refusal of OpenJPEG's on the way
(strict mode, its default) is Pillow's OSError "broken data stream".

- The main header: SIZ (any component count, precision 1-31, signed, per
  component dx / dy, image and tile offsets), COD / COC, QCD / QCC, RGN,
  POC, PPM, TLM / PLM / PLT / CRG / COM (checked and skipped), unknown
  markers skipped up to the next known one, as opj_j2k_read_header_
  procedure reads them.
- Tile-parts: SOT / SOD with their tile-part header markers (and PPT),
  each tile's parts gathered until its last (TNsot) or the codestream's
  end; a tile is decoded once its data is whole, as
  opj_j2k_read_tile_header hands it over.
- A tile: tier-2 (io/j2k_t2.py) reads its packets into code-blocks,
  tier-1 (io/j2k_t1.py, csrc/j2k_t1.cpp) decodes them, then OpenJPEG's
  dequantisation (the reversible path halves t1's values with C's
  truncation; the irreversible one scales them by half the band's step,
  derived or expounded, with the gain OpenJPEG leaves out of the 9/7
  bands), ROI max-shift, the inverse wavelet (io/j2k_dwt.py), the
  inverse RCT or ICT, the DC level shift with lrintf's rounding and the
  clamp to the component's range.  HT (Part 15) code-blocks raise
  NotImplementedError (ROADMAP Queue 1 M9).
- Pillow's unpackers, chosen by mode, component count and colour space
  (a JP2 colr box's sRGB, greyscale, sYCC, e-sYCC or CMYK; otherwise
  grey for one or two components, sYCC when the first subsampled
  component is the second or third, else sRGB): the samples as
  OpenJPEG's tile buffer holds them (1, 2 or 4 bytes a sample), offset
  and shifted to 8 bits (16 for I;16), the subsampled components read
  at x / dx, y / dy of the tile with Pillow's rounded-down row lengths,
  sYCC through ConvertYCbCr.c.  A `pclr` palette is Pillow's to apply
  (the tile API leaves indices).

Writing is Jpeg2KEncode.c with Pillow's defaults on an L, RGB or RGBA
image: one tile, the 5/3 wavelet with as many levels (up to five) as
the image's shorter side allows, 64 x 64 code-blocks, one lossless layer,
LRCP, no MCT, OpenJPEG's comment, and the JP2 boxes unless the file's
extension is .j2k.
"""
from __future__ import annotations

import struct

import numpy as np

from ..errors import not_ported
from . import j2k_dwt, j2k_t1, j2k_t2, rawmode

BROKEN = "broken data stream when reading image file"

SIZ, COD, COC, TLM, PLM, PLT, QCD, QCC, RGN, POC, PPM, PPT, CRG, COM, SOT, \
    SOP, SOD, EOC = (
        0xFF51, 0xFF52, 0xFF53, 0xFF55, 0xFF57, 0xFF58, 0xFF5C, 0xFF5D,
        0xFF5E, 0xFF5F, 0xFF60, 0xFF61, 0xFF63, 0xFF64, 0xFF90, 0xFF91,
        0xFF93, 0xFFD9)
# opj_j2k_dec_state
S_MHSIZ, S_MH, S_TPHSOT, S_TPH, S_NEOC, S_EOC = 0x2, 0x4, 0x8, 0x10, 0x40, \
    0x100
# the states each marker is read in (j2k_memory_marker_handler_tab); the
# Part 2 and Part 15 markers are read and not used
_STATES = {SOT: S_MH | S_TPHSOT, COD: S_MH | S_TPH, COC: S_MH | S_TPH,
           RGN: S_MH | S_TPH, QCD: S_MH | S_TPH, QCC: S_MH | S_TPH,
           POC: S_MH | S_TPH, SIZ: S_MHSIZ, TLM: S_MH, PLM: S_MH,
           PLT: S_TPH, PPM: S_MH, PPT: S_TPH, SOP: 0, CRG: S_MH,
           COM: S_MH | S_TPH, 0xFF74: S_MH | S_TPH, 0xFF75: S_MH | S_TPH,
           0xFF77: S_MH | S_TPH, 0xFF78: S_MH, 0xFF50: S_MH, 0xFF59: S_MH}
_UNKNOWN = S_MH | S_TPH
MAXBANDS = 97
CSTY_PRT, CSTY_SOP, CSTY_EPH = 1, 2, 4
CBLKSTY_HT = 0x40
# OpenJPEG's colour spaces
CS_UNKNOWN, CS_UNSPECIFIED, CS_SRGB, CS_GRAY, CS_SYCC, CS_EYCC, CS_CMYK = \
    -1, 0, 1, 2, 3, 4, 5


class Fail(Exception):
    """OpenJPEG refuses the file (Pillow's "broken data stream")."""


# ---------------------------------------------------------- the stream ----
class _Stream:
    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def left(self) -> int:
        return len(self.data) - self.pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def u16(self, what="Stream too short") -> int:
        b = self.read(2)
        if len(b) != 2:
            raise Fail(what)
        return (b[0] << 8) | b[1]


def _tccp() -> dict:
    return dict(csty=0, numres=0, cblkw=0, cblkh=0, cblksty=0, qmfbid=0,
                prcw=[15] * 33, prch=[15] * 33, qntsty=0, numgbits=0,
                steps=[(0, 0)] * MAXBANDS, roishift=0)


def _tcp(ncomp: int) -> dict:
    return dict(csty=0, prg=0, numlayers=0, mct=0, cod=False, pocs=[],
                tccps=[_tccp() for _ in range(ncomp)], ppt={}, data=None,
                nparts=0, part=-1, merged=False)


def _copy_tcp(t: dict) -> dict:
    out = dict(t)
    out["tccps"] = [dict(c, prcw=list(c["prcw"]), prch=list(c["prch"]),
                         steps=list(c["steps"])) for c in t["tccps"]]
    out["pocs"] = [dict(p) for p in t["pocs"]]
    out["ppt"] = {}
    out["cod"] = False
    out["part"] = -1
    return out


# ------------------------------------------------------ marker readers ----
class Codestream:
    """opj_j2k_t's decoder state over one codestream."""

    def __init__(self, data: bytes, start: int, ihdr=None):
        self.s = _Stream(data, start)
        self.ihdr = ihdr                     # (w, h) of a JP2's ihdr box
        self.state = 0
        self.ppm = None
        self.tile = 0
        self.sot_length = 0
        self.last_part = False
        self.can_decode = False

    # opj_j2k_read_header_procedure
    def read_header(self):
        s = self.s
        self.state = S_MHSIZ
        if s.read(2) != b"\xff\x4f":
            raise Fail("Expected a SOC marker")
        marker = s.u16()
        seen = set()
        while marker != SOT:
            if marker < 0xFF00:
                raise Fail("A marker ID was expected")
            if marker not in _STATES:
                marker = self._unknown()
                if marker == SOT:
                    break
            seen.add(marker)
            if not self.state & _STATES.get(marker, _UNKNOWN):
                raise Fail("Marker is not compliant with its position")
            size = s.u16()
            if size < 2:
                raise Fail("Invalid marker size")
            body = s.read(size - 2)
            if len(body) != size - 2:
                raise Fail("Stream too short")
            _HANDLERS[marker](self, body)
            marker = s.u16()
        for m, what in ((SIZ, "SIZ"), (COD, "COD"), (QCD, "QCD")):
            if m not in seen:
                raise Fail(f"required {what} marker not found")
        self._merge_ppm()
        self.ppm_stream = None if self.ppm is None else _Headers(self.ppm)
        self.tcps = [_copy_tcp(self.dtcp) for _ in range(self.tw * self.th)]
        self.state = S_TPHSOT

    def _unknown(self) -> int:
        """opj_j2k_read_unk: two bytes at a time up to a known marker."""
        while True:
            m = self.s.u16()
            if m >= 0xFF00:
                states = _STATES.get(m, _UNKNOWN)
                if not self.state & states:
                    raise Fail("Marker is not compliant with its position")
                if m in _STATES:
                    return m

    def _tcp(self) -> dict:
        return self.tcps[self.tile] if self.state == S_TPH else self.dtcp

    def siz(self, b: bytes):
        n = len(b)
        if n < 36 or (n - 36) % 3:
            raise Fail("Error with SIZ marker size")
        (_, x1, y1, x0, y0, tdx, tdy, tx0, ty0, csiz) = struct.unpack_from(
            ">HIIIIIIIIH", b)
        if csiz >= 16385 or csiz != (n - 36) // 3:
            raise Fail("Error with SIZ marker: number of components")
        if x0 >= x1 or y0 >= y1:
            raise Fail("Error with SIZ marker: negative or zero image size")
        if tdx == 0 or tdy == 0:
            raise Fail("Error with SIZ marker: invalid tile size")
        if tx0 > x0 or ty0 > y0 or min(tx0 + tdx, 0xFFFFFFFF) <= x0 \
                or min(ty0 + tdy, 0xFFFFFFFF) <= y0:
            raise Fail("Error with SIZ marker: illegal tile offset")
        if self.ihdr is not None and self.ihdr != (x1 - x0, y1 - y0):
            raise Fail("Error with SIZ marker: IHDR vs. SIZ size")
        comps = []
        for i in range(csiz):
            t, dx, dy = b[36 + 3 * i:39 + 3 * i]
            if not (1 <= dx <= 255 and 1 <= dy <= 255):
                raise Fail("Invalid values for comp dx / dy")
            prec = (t & 0x7F) + 1
            if prec > 31:
                raise Fail("Invalid values for comp prec")
            comps.append(dict(prec=prec, sgnd=t >> 7, dx=dx, dy=dy))
        tw = -(-(x1 - tx0) // tdx)
        th = -(-(y1 - ty0) // tdy)
        if tw == 0 or th == 0 or tw > 65535 // th:
            raise Fail("Invalid number of tiles")
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.tdx, self.tdy, self.tx0, self.ty0 = tdx, tdy, tx0, ty0
        self.tw, self.th = tw, th
        self.comps = comps
        self.dtcp = _tcp(csiz)
        self.state = S_MH

    def _spcod(self, tccp: dict, b: bytes, o: int) -> int:
        """opj_j2k_read_SPCod_SPCoc from b[o:] -> the bytes left."""
        left = len(b) - o
        if left < 5:
            raise Fail("Error reading SPCod SPCoc element")
        numres = b[o] + 1
        if numres > 33:
            raise Fail("Invalid value for numresolutions")
        cblkw, cblkh = b[o + 1] + 2, b[o + 2] + 2
        if cblkw > 10 or cblkh > 10 or cblkw + cblkh > 12:
            raise Fail("Invalid cblkw/cblkh combination")
        cblksty = b[o + 3]
        if cblksty & 0x80:
            raise Fail("Unsupported Mixed HT code-block style found")
        if b[o + 4] > 1:
            raise Fail("Invalid transformation found")
        tccp.update(numres=numres, cblkw=cblkw, cblkh=cblkh,
                    cblksty=cblksty, qmfbid=b[o + 4])
        left -= 5
        o += 5
        if tccp["csty"] & CSTY_PRT:
            if left < numres:
                raise Fail("Error reading SPCod SPCoc element")
            for i in range(numres):
                t = b[o + i]
                if i and (not t & 0xF or not t >> 4):
                    raise Fail("Invalid precinct size")
                tccp["prcw"][i], tccp["prch"][i] = t & 0xF, t >> 4
            left -= numres
        else:
            tccp["prcw"] = [15] * 33
            tccp["prch"] = [15] * 33
        return left

    def cod(self, b: bytes):
        t = self._tcp()
        if t["cod"]:
            raise Fail("COD marker already read")
        t["cod"] = True
        if len(b) < 5:
            raise Fail("Error reading COD marker")
        csty, prg, layers, mct = struct.unpack_from(">BBHB", b)
        if csty & ~7:
            raise Fail("Unknown Scod value in COD marker")
        t["csty"] = csty
        t["prg"] = prg if prg <= 4 else -1
        if layers < 1:
            raise Fail("Invalid number of layers in COD marker")
        t["numlayers"] = layers
        if mct > 1:
            raise Fail("Invalid multiple component transformation")
        t["mct"] = mct
        for c in t["tccps"]:
            c["csty"] = csty & CSTY_PRT
        if self._spcod(t["tccps"][0], b, 5) != 0:
            raise Fail("Error reading COD marker")
        ref = t["tccps"][0]
        for c in t["tccps"][1:]:
            c.update(numres=ref["numres"], cblkw=ref["cblkw"],
                     cblkh=ref["cblkh"], cblksty=ref["cblksty"],
                     qmfbid=ref["qmfbid"], prcw=list(ref["prcw"]),
                     prch=list(ref["prch"]))

    def _compno(self, b: bytes, what: str) -> tuple:
        room = 1 if len(self.comps) <= 256 else 2
        if len(b) < room:
            raise Fail(f"Error reading {what} marker")
        c = b[0] if room == 1 else (b[0] << 8) | b[1]
        return c, room

    def coc(self, b: bytes):
        t = self._tcp()
        c, room = self._compno(b, "COC")
        if len(b) < room + 1:
            raise Fail("Error reading COC marker")
        if c >= len(self.comps):
            raise Fail("Error reading COC marker (bad number of components)")
        tccp = t["tccps"][c]
        tccp["csty"] = b[room]
        if self._spcod(tccp, b, room + 1) != 0:
            raise Fail("Error reading COC marker")

    def _sqcd(self, tccp: dict, b: bytes, o: int) -> int:
        left = len(b) - o
        if left < 1:
            raise Fail("Error reading SQcd or SQcc element")
        left -= 1
        tccp["qntsty"], tccp["numgbits"] = b[o] & 0x1F, b[o] >> 5
        o += 1
        steps = list(tccp["steps"])
        if tccp["qntsty"] == 0:
            for i in range(left):
                if i < MAXBANDS:
                    steps[i] = (b[o + i] >> 3, 0)
            left = 0
        else:
            n = 1 if tccp["qntsty"] == 1 else left // 2
            if left < 2 * n:
                raise Fail("Error reading SQcd or SQcc element")
            for i in range(n):
                v = (b[o + 2 * i] << 8) | b[o + 2 * i + 1]
                if i < MAXBANDS:
                    steps[i] = (v >> 11, v & 0x7FF)
            left -= 2 * n
        if tccp["qntsty"] == 1:
            e0, m0 = steps[0]
            for i in range(1, MAXBANDS):
                steps[i] = (max(e0 - (i - 1) // 3, 0), m0)
        tccp["steps"] = steps
        return left

    def qcd(self, b: bytes):
        t = self._tcp()
        if self._sqcd(t["tccps"][0], b, 0) != 0:
            raise Fail("Error reading QCD marker")
        ref = t["tccps"][0]
        for c in t["tccps"][1:]:
            c.update(qntsty=ref["qntsty"], numgbits=ref["numgbits"],
                     steps=list(ref["steps"]))

    def qcc(self, b: bytes):
        t = self._tcp()
        c, room = self._compno(b, "QCC")
        if c >= len(self.comps):
            raise Fail("Invalid component number")
        if self._sqcd(t["tccps"][c], b, room) != 0:
            raise Fail("Error reading QCC marker")

    def rgn(self, b: bytes):
        t = self._tcp()
        room = 1 if len(self.comps) <= 256 else 2
        if len(b) != 2 + room:
            raise Fail("Error reading RGN marker")
        c = b[0] if room == 1 else (b[0] << 8) | b[1]
        if c >= len(self.comps):
            raise Fail("bad component number in RGN")
        t["tccps"][c]["roishift"] = b[room + 1]

    def poc(self, b: bytes):
        t = self._tcp()
        room = 1 if len(self.comps) <= 256 else 2
        chunk = 5 + 2 * room
        n = len(b) // chunk
        if n <= 0 or len(b) % chunk:
            raise Fail("Error reading POC marker")
        if len(t["pocs"]) + n >= 32:
            raise Fail("Too many POCs")
        for i in range(n):
            o = i * chunk

            def num(k):
                return b[o + k] if room == 1 else (b[o + k] << 8) | b[
                    o + k + 1]
            resno0 = b[o]
            compno0 = num(1)
            layno1 = (b[o + 1 + room] << 8) | b[o + 2 + room]
            resno1 = b[o + 3 + room]
            compno1 = min(num(4 + room), len(self.comps))
            prg = b[o + 4 + 2 * room]
            t["pocs"].append(dict(resno0=resno0, compno0=compno0,
                                  layno1=layno1, resno1=resno1,
                                  compno1=compno1, prg=prg))

    def ppm_(self, b: bytes):
        if len(b) < 2:
            raise Fail("Error reading PPM marker")
        if self.ppm is None:
            self.ppm = {}
        if b[0] in self.ppm:
            raise Fail("Zppm already read")
        self.ppm[b[0]] = b[1:]

    def ppt(self, b: bytes):
        if len(b) < 2:
            raise Fail("Error reading PPT marker")
        if self.ppm is not None:
            raise Fail("PPT after PPM")
        t = self._tcp()
        if b[0] in t["ppt"]:
            raise Fail("Zppt already read")
        t["ppt"][b[0]] = b[1:]

    def tlm(self, b: bytes):
        if len(b) < 2:
            raise Fail("Error reading TLM marker")
        st, sp = (b[1] >> 4) & 3, (b[1] >> 6) & 1
        if (len(b) - 2) % ((sp + 1) * 2 + st):
            raise Fail("Error reading TLM marker")

    def plm(self, b: bytes):
        if len(b) < 1:
            raise Fail("Error reading PLM marker")

    def plt(self, b: bytes):
        if len(b) < 1:
            raise Fail("Error reading PLT marker")
        pending = 0
        for v in b[1:]:
            pending = 0 if not v & 0x80 else 1
        if pending:
            raise Fail("Error reading PLT marker")

    def crg(self, b: bytes):
        if len(b) != 4 * len(self.comps):
            raise Fail("Error reading CRG marker")

    def skip(self, b: bytes):
        pass

    def _merge_ppm(self):
        """opj_j2k_merge_ppm: the Nppm-prefixed packet headers of the
        PPM markers in Zppm order, as one stream."""
        if self.ppm is None:
            return
        out = bytearray()
        remaining = 0
        for z in sorted(self.ppm):
            d = self.ppm[z]
            o = 0
            if remaining >= len(d):
                remaining -= len(d)
                out += d
                continue
            out += d[:remaining]
            o = remaining
            remaining = 0
            while o < len(d):
                if len(d) - o < 4:
                    raise Fail("Not enough bytes to read Nppm")
                n = struct.unpack_from(">I", d, o)[0]
                o += 4
                take = d[o:o + n]
                out += take
                if len(take) < n:
                    remaining = n - len(take)
                o += n
        if remaining:
            raise Fail("Corrupted PPM markers")
        self.ppm = bytes(out)

    # --------------------------------------------------- tile-parts ----
    def sot(self, b: bytes):
        if len(b) != 8:
            raise Fail("Error reading SOT marker")
        tile, psot, part, nparts = struct.unpack(">HIBB", b)
        if tile >= self.tw * self.th:
            raise Fail("Invalid tile number")
        self.tile = tile
        t = self.tcps[tile]
        if t["part"] + 1 != part:
            raise Fail("Invalid tile part index")
        t["part"] = part
        if psot and psot < 14:
            if psot != 12:
                raise Fail("Psot value is not correct")
        self.last_part = psot == 0
        if t["nparts"] and part >= t["nparts"]:
            raise Fail("TPSot is not valid")
        if nparts:
            if part >= nparts:
                raise Fail("TPSot is not valid")
            t["nparts"] = nparts
        if t["nparts"] and t["nparts"] == part + 1:
            self.can_decode = True
        self.sot_length = 0 if self.last_part else psot - 12
        self.state = S_TPH

    def _sod(self):
        """opj_j2k_read_sod: the tile-part's data into its tile."""
        s = self.s
        if self.last_part:
            self.sot_length = max(s.left() - 2, 0)
        else:
            self.sot_length = max(self.sot_length - 2, 0)
        t = self.tcps[self.tile]
        if t["data"] is None:
            t["data"] = bytearray()
        got = b""
        if self.sot_length:
            if self.sot_length > s.left():
                raise Fail("Tile part length size inconsistent with stream "
                           "length")
            got = s.read(self.sot_length)
        self.state = S_NEOC if len(got) != self.sot_length else S_TPHSOT
        t["data"] += got

    def next_tile(self):
        """opj_j2k_read_tile_header -> the index of the next tile to
        decode, or None when there is none."""
        s = self.s
        if self.state == S_EOC:
            marker = EOC
        elif self.state != S_TPHSOT:
            raise Fail("not at a tile-part header")
        else:
            marker = SOT
        while not self.can_decode and marker != EOC:
            while marker != SOD:
                if s.left() == 0:
                    self.state = S_NEOC
                    break
                size = s.u16()
                if size < 2:
                    raise Fail("Inconsistent marker size")
                if self.state & S_TPH:
                    if self.sot_length < size + 2:
                        raise Fail("Sot length is less than marker size + "
                                   "marker ID")
                    self.sot_length -= size + 2
                if not self.state & _STATES.get(marker, _UNKNOWN):
                    raise Fail("Marker is not compliant with its position")
                body = s.read(size - 2)
                if len(body) != size - 2:
                    raise Fail("Stream too short")
                if marker not in _HANDLERS and marker != SOT:
                    # the table's unknown entry has no handler
                    raise Fail("Not sure how that happened.")
                if marker == SOT:
                    self.sot(body)
                else:
                    _HANDLERS[marker](self, body)
                marker = s.u16()
            if s.left() == 0 and self.state == S_NEOC:
                break
            self._sod()
            if not self.can_decode:
                marker = s.u16()
        if marker == EOC and self.state != S_EOC:
            self.tile = 0
            self.state = S_EOC
        if not self.can_decode:
            while self.tile < len(self.tcps) \
                    and self.tcps[self.tile]["data"] is None:
                self.tile += 1
            if self.tile == len(self.tcps):
                return None
        t = self.tcps[self.tile]
        if t["merged"]:
            raise Fail("opj_j2k_merge_ppt() has already been called")
        t["merged"] = True
        t["ppt_data"] = b"".join(t["ppt"][z] for z in sorted(t["ppt"])) \
            if t["ppt"] else None
        return self.tile

    def after_tile(self):
        """The end of opj_j2k_decode_tile: the marker after the tile."""
        t = self.tcps[self.tile]
        t["data"] = None
        self.can_decode = False
        s = self.s
        if s.left() == 0 and self.state == S_NEOC:
            return
        if self.state != S_EOC:
            b = s.read(2)
            if len(b) != 2:
                raise Fail("Stream too short")
            m = (b[0] << 8) | b[1]
            if m == EOC:
                self.tile = 0
                self.state = S_EOC
            elif m != SOT:
                if s.left() == 0:
                    self.state = S_NEOC
                    return
                raise Fail("Stream too short, expected SOT")


_HANDLERS = {SIZ: Codestream.siz, COD: Codestream.cod, COC: Codestream.coc,
             QCD: Codestream.qcd, QCC: Codestream.qcc, RGN: Codestream.rgn,
             POC: Codestream.poc, PPM: Codestream.ppm_, PPT: Codestream.ppt,
             TLM: Codestream.tlm, PLM: Codestream.plm, PLT: Codestream.plt,
             CRG: Codestream.crg, COM: Codestream.skip,
             0xFF74: Codestream.skip, 0xFF75: Codestream.skip,
             0xFF77: Codestream.skip, 0xFF78: Codestream.skip,
             0xFF50: Codestream.skip, 0xFF59: Codestream.skip}


# ------------------------------------------------------------- a tile ----
def _cdp2(a: int, b: int) -> int:
    """opj_int_ceildivpow2."""
    return (a + (1 << b) - 1) >> b


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_geometry(cs, tileno: int, tcp: dict) -> dict:
    """opj_tcd_init_tile: the tile's components, resolutions, bands,
    precincts and code-blocks (the shapes tier-2 and tier-1 work on)."""
    p, q = tileno % cs.tw, tileno // cs.tw
    tx0 = max(cs.tx0 + p * cs.tdx, cs.x0)
    ty0 = max(cs.ty0 + q * cs.tdy, cs.y0)
    tx1 = min(cs.tx0 + (p + 1) * cs.tdx, cs.x1)
    ty1 = min(cs.ty0 + (q + 1) * cs.tdy, cs.y1)
    tile = dict(x0=tx0, y0=ty0, x1=tx1, y1=ty1, comps=[])
    for img, tccp in zip(cs.comps, tcp["tccps"]):
        dx, dy = img["dx"], img["dy"]
        tc = dict(dx=dx, dy=dy, x0=_cdiv(tx0, dx), y0=_cdiv(ty0, dy),
                  x1=_cdiv(tx1, dx), y1=_cdiv(ty1, dy),
                  numres=tccp["numres"], tccp=tccp, res=[])
        for r in range(tccp["numres"]):
            level = tccp["numres"] - 1 - r
            rx0, ry0 = _cdp2(tc["x0"], level), _cdp2(tc["y0"], level)
            rx1, ry1 = _cdp2(tc["x1"], level), _cdp2(tc["y1"], level)
            pdx, pdy = tccp["prcw"][r], tccp["prch"][r]
            px0, py0 = (rx0 >> pdx) << pdx, (ry0 >> pdy) << pdy
            px1, py1 = _cdp2(rx1, pdx) << pdx, _cdp2(ry1, pdy) << pdy
            pw = 0 if rx0 == rx1 else (px1 - px0) >> pdx
            ph = 0 if ry0 == ry1 else (py1 - py0) >> pdy
            if r == 0:
                cbgx0, cbgy0, cbgw, cbgh = px0, py0, pdx, pdy
            else:
                cbgx0, cbgy0 = _cdp2(px0, 1), _cdp2(py0, 1)
                cbgw, cbgh = pdx - 1, pdy - 1
            cbw = min(tccp["cblkw"], cbgw)
            cbh = min(tccp["cblkh"], cbgh)
            res = dict(x0=rx0, y0=ry0, x1=rx1, y1=ry1, pdx=pdx, pdy=pdy,
                       pw=pw, ph=ph, bands=[])
            for bandno in ((0,) if r == 0 else (1, 2, 3)):
                if r == 0:
                    bx0, by0 = rx0, ry0
                    bx1, by1 = rx1, ry1
                else:
                    xb, yb = bandno & 1, bandno >> 1
                    bx0 = _cdp2(tc["x0"] - (xb << level), level + 1)
                    by0 = _cdp2(tc["y0"] - (yb << level), level + 1)
                    bx1 = _cdp2(tc["x1"] - (xb << level), level + 1)
                    by1 = _cdp2(tc["y1"] - (yb << level), level + 1)
                expn, mant = tccp["steps"][0 if r == 0
                                           else 3 * (r - 1) + bandno]
                band = dict(bandno=bandno, x0=bx0, y0=by0, x1=bx1, y1=by1,
                            numbps=expn + tccp["numgbits"] - 1, expn=expn,
                            mant=mant, precincts=[])
                band["empty"] = bx0 >= bx1 or by0 >= by1
                for k in range(pw * ph):
                    cx = cbgx0 + (k % pw) * (1 << cbgw)
                    cy = cbgy0 + (k // pw) * (1 << cbgh)
                    x0, y0 = max(cx, bx0), max(cy, by0)
                    x1 = min(cx + (1 << cbgw), bx1)
                    y1 = min(cy + (1 << cbgh), by1)
                    tlx, tly = (x0 >> cbw) << cbw, (y0 >> cbh) << cbh
                    brx, bry = _cdp2(x1, cbw) << cbw, _cdp2(y1, cbh) << cbh
                    cw = max(brx - tlx, 0) >> cbw
                    ch = max(bry - tly, 0) >> cbh
                    cblks = []
                    for j in range(cw * ch):
                        ox = tlx + ((j % cw) << cbw)
                        oy = tly + ((j // cw) << cbh)
                        cblks.append(dict(
                            x0=max(ox, x0), y0=max(oy, y0),
                            x1=min(ox + (1 << cbw), x1),
                            y1=min(oy + (1 << cbh), y1),
                            segs=[], numbps=0, numlenbits=0))
                    band["precincts"].append(dict(
                        cblks=cblks, incl=j2k_t2.TagTree(cw, ch),
                        imsb=j2k_t2.TagTree(cw, ch)))
                res["bands"].append(band)
            tc["res"].append(res)
        tile["comps"].append(tc)
    return tile


class _Headers:
    """Where packet headers are read from: the tile's data, or the PPM
    stream (shared by all tiles) or the tile's PPT stream."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0


def _read_packets(tile: dict, tcp: dict, data: bytes, ppm):
    """opj_t2_decode_packets: every packet of the tile into its
    code-blocks' segments."""
    hdr = ppm if ppm is not None else (
        _Headers(tcp["ppt_data"]) if tcp.get("ppt_data") is not None
        else None)
    pos = 0
    end = len(data)
    if tcp["prg"] < 0:
        raise Fail("unknown progression order")
    for lay, r, c, p in j2k_t2.packets(tile, tcp):
        comp = tile["comps"][c]
        res = comp["res"][r]
        bands = [b for b in res["bands"] if not b["empty"]]
        if lay == 0:
            for b in bands:
                if p >= len(b["precincts"]):
                    raise Fail("Invalid precinct")
                prc = b["precincts"][p]
                prc["incl"].reset()
                prc["imsb"].reset()
                for cb in prc["cblks"]:
                    cb["segs"] = []
        if tcp["csty"] & CSTY_SOP and end - pos >= 6 \
                and data[pos:pos + 2] == b"\xff\x91":
            pos += 6
        if hdr is None:
            src, hpos, hend = data, pos, end
        else:
            src, hpos, hend = hdr.data, hdr.pos, len(hdr.data)
        bio = j2k_t2.Bio(src, hpos, hend)
        present = bio.read(1)
        parts = []
        if present:
            tccp = comp["tccp"]
            try:
                parts = j2k_t2.read_header(
                    bio, bands, p, lay, tccp["cblksty"],
                    lambda band, i: (band["numbps"] + 1 - i) & 0xFFFFFFFF)
            except j2k_t2.HeaderError as e:
                raise Fail(str(e)) from None
        bio.inalign()
        hpos += bio.numbytes()
        if tcp["csty"] & CSTY_EPH:
            if src[hpos:min(hpos + 2, hend)] != b"\xff\x92":
                raise Fail("Expected EPH marker")
            hpos += 2
        if hdr is None:
            pos = hpos
        else:
            hdr.pos = hpos
        for cb, segparts in parts:
            for segno, maxp, take, length in segparts:
                if pos + length > end:
                    raise Fail("read: segment too long")
                if segno == len(cb["segs"]):
                    cb["segs"].append([maxp, 0, b""])
                seg = cb["segs"][segno]
                seg[1] += take
                seg[2] += data[pos:pos + length]
                pos += length


def _tile_blocks(cs, tileno: int, tcp: dict) -> tuple:
    """The tile's geometry with its packets read -> (tile, its
    code-blocks as tier-1 takes them)."""
    tile = tile_geometry(cs, tileno, tcp)
    _read_packets(tile, tcp, bytes(tcp["data"]), cs.ppm_stream)
    blocks = []
    for comp in tile["comps"]:
        tccp = comp["tccp"]
        for r, res in enumerate(comp["res"]):
            for band in res["bands"]:
                for prc in band["precincts"]:
                    for cb in prc["cblks"]:
                        w, h = cb["x1"] - cb["x0"], cb["y1"] - cb["y0"]
                        bpo = j2k_t1._i32(tccp["roishift"] + cb["numbps"])
                        if bpo >= 31:
                            raise Fail("unsupported bpno_plus_one")
                        blocks.append((w, h, band["bandno"],
                                       tccp["cblksty"], cb["numbps"], bpo,
                                       [(s[2], s[1]) for s in cb["segs"]]))
    if any(b[3] & CBLKSTY_HT for b in blocks):
        raise not_ported("JPEG 2000 HT code-blocks (Part 15)", "Queue 1 M9")
    return tile, blocks


def _decode_tile(cs, tileno: int, tcp: dict) -> tuple:
    """opj_tcd_decode_tile -> (the tile, each component's samples (int64,
    tile component shape), after the DC shift and the clamp)."""
    tile, blocks = _tile_blocks(cs, tileno, tcp)
    decoded = iter(j2k_t1.decode_blocks(blocks))
    out = []
    for comp, img in zip(tile["comps"], cs.comps):
        tccp = comp["tccp"]
        rev = tccp["qmfbid"] == 1
        arrays = []
        for r, res in enumerate(comp["res"]):
            bands = []
            for band in res["bands"]:
                a = np.zeros((max(band["y1"] - band["y0"], 0),
                              max(band["x1"] - band["x0"], 0)),
                             np.int32 if rev else np.float32)
                if not rev:
                    step = np.float32(np.float32(
                        (1.0 + band["mant"] / 2048.0)
                        * 2.0 ** (img["prec"] - band["expn"])) * 0.5)
                for prc in band["precincts"]:
                    for cb in prc["cblks"]:
                        v = next(decoded).astype(np.int64)
                        sh = tccp["roishift"]
                        if sh:
                            if sh >= 31:
                                v[:] = 0
                            else:
                                mag = np.abs(v)
                                big = mag >= (1 << sh)
                                v = np.where(big, np.sign(v) * (mag >> sh), v)
                        ys = slice(cb["y0"] - band["y0"],
                                   cb["y1"] - band["y0"])
                        xs = slice(cb["x0"] - band["x0"],
                                   cb["x1"] - band["x0"])
                        if rev:
                            a[ys, xs] = j2k_dwt._cdiv2(v)
                        else:
                            a[ys, xs] = v.astype(np.float32) * step
                bands.append(a)
            arrays.append((res, bands))
        ll = arrays[0][1][0]
        levels = [(b[0], b[1], b[2], res["x0"], res["y0"])
                  for res, b in arrays[1:]]
        out.append(j2k_dwt.inverse(levels, ll, rev))
    _mct(tcp, tile, out)
    for i, (comp, img) in enumerate(zip(tile["comps"], cs.comps)):
        prec, sgnd = img["prec"], img["sgnd"]
        lo, hi = (-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if sgnd \
            else (0, (1 << prec) - 1)
        shift = 0 if sgnd else 1 << (prec - 1)
        a = out[i]
        if a.dtype == np.float32:
            big, small = a > np.float32(2 ** 31), a < np.float32(-2 ** 31)
            r = np.rint(np.where(big | small | np.isnan(a), 0, a))
            v = r.astype(np.int64) + shift
            v = np.where(big, hi, np.where(small | np.isnan(a), lo, v))
        else:
            v = a.astype(np.int64) + shift
        out[i] = np.clip(v, lo, hi)
    return tile, out


def _mct(tcp: dict, tile: dict, out: list):
    """opj_tcd_mct_decode: the inverse RCT (integers) or ICT (float32)
    on the first three components."""
    if not tcp["mct"]:
        return
    comps = tile["comps"]
    if len(comps) < 3:
        return
    if any(c["numres"] != comps[0]["numres"] for c in comps[1:3]) \
            or any(out[k].shape != out[0].shape for k in (1, 2)):
        raise Fail("Tiles don't all have the same dimension")
    if comps[0]["tccp"]["qmfbid"] == 1:
        y, u, v = (out[k].astype(np.int64) for k in range(3))
        g = y - ((u + v) >> 2)
        out[0], out[1], out[2] = (v + g).astype(np.int32), \
            g.astype(np.int32), (u + g).astype(np.int32)
    else:
        y, u, v = (out[k].astype(np.float32) for k in range(3))
        out[0] = y + v * np.float32(1.402)
        out[1] = y - u * np.float32(0.34413) - v * np.float32(0.71414)
        out[2] = y + u * np.float32(1.772)


# ------------------------------------------------------------ JP2 boxes ----
def jp2_boxes(data: bytes) -> dict:
    """opj_jp2_read_header_procedure over a JP2 file -> {"start": the
    codestream's offset, "enumcs", "ihdr": (w, h)}; raises Fail where
    OpenJPEG does."""
    pos, state = 0, set()
    info = dict(enumcs=0, ihdr=None, has_colr=False, pclr=False,
                cmap=False, cdef=False)
    while True:
        if len(data) - pos < 8:
            break
        length, typ = struct.unpack_from(">I4s", data, pos)
        hdr = 8
        if length == 0:
            length = len(data) - pos
        elif length == 1:
            if len(data) - pos < 16:
                break
            xl, length = struct.unpack_from(">II", data, pos + 8)
            if xl:
                raise Fail("Cannot handle box sizes higher than 2^32")
            hdr = 16
        if typ == b"jp2c":
            if "header" not in state:
                raise Fail("bad placed jpeg codestream")
            info["start"] = pos + hdr
            break
        if length == 0:
            raise Fail("Cannot handle box of undefined sizes")
        if length < hdr:
            raise Fail("invalid box size")
        body_len = length - hdr
        body = data[pos + hdr:pos + hdr + body_len]
        top = typ in (b"jP  ", b"ftyp", b"jp2h")
        img = typ in _IMG_BOXES
        if top or img:
            if not top and "header" not in state:
                pos += length
                if pos > len(data):
                    raise Fail("Problem with skipping JPEG2000 box")
                continue
            if body_len > len(data) - pos - hdr:
                raise Fail("Invalid box size")
            if typ == b"jP  ":
                if state or body_len != 4 or body != b"\r\n\x87\n":
                    raise Fail("bad signature box")
                state.add("sig")
            elif typ == b"ftyp":
                if state != {"sig"} or body_len < 8 or (body_len - 8) % 4:
                    raise Fail("bad ftyp box")
                state.add("ftyp")
            elif typ == b"jp2h":
                if "ftyp" not in state:
                    raise Fail("The jp2h box must follow ftyp")
                _jp2h(body, info)
                state.add("header")
            else:
                _IMG_BOXES[typ](body, info)
        else:
            if "sig" not in state:
                raise Fail("first box must be JPEG 2000 signature box")
            if "ftyp" not in state:
                raise Fail("second box must be file type box")
            if pos + length > len(data):
                raise Fail("Problem with skipping JPEG2000 box")
        pos += length
    if "header" not in state:
        raise Fail("JP2H box missing. Required.")
    if info["ihdr"] is None:
        raise Fail("IHDR box missing. Required.")
    info.setdefault("start", len(data))
    return info


def _jp2h(body: bytes, info: dict):
    o, has_ihdr = 0, False
    while o < len(body):
        left = len(body) - o
        if left < 8:
            raise Fail("Cannot handle box of less than 8 bytes")
        length, typ = struct.unpack_from(">I4s", body, o)
        hdr = 8
        if length == 1:
            if left < 16:
                raise Fail("Cannot handle XL box of less than 16 bytes")
            xl, length = struct.unpack_from(">II", body, o + 8)
            if xl or length == 0:
                raise Fail("Cannot handle box sizes higher than 2^32")
            hdr = 16
        elif length == 0:
            raise Fail("Cannot handle box of undefined sizes")
        if length < hdr or length > left:
            raise Fail("box length is inconsistent")
        if typ in _IMG_BOXES:
            _IMG_BOXES[typ](body[o + hdr:o + length], info)
        has_ihdr |= typ == b"ihdr"
        o += length
    if not has_ihdr:
        raise Fail("no 'ihdr' box")


def _ihdr(b: bytes, info: dict):
    if info["ihdr"] is not None:
        return
    if len(b) != 14:
        raise Fail("Bad image header box (bad size)")
    h, w, nc, bpc = struct.unpack_from(">IIHB", b)
    if (nc - 1) & 0xFFFFFFFF >= 16384 or h < 1 or w < 1:
        raise Fail("Wrong values for ihdr")
    info.update(ihdr=(w, h), nc=nc, bpc=bpc)


def _colr(b: bytes, info: dict):
    if len(b) < 3:
        raise Fail("Bad COLR header box (bad size)")
    if info["has_colr"]:
        return
    if b[0] == 1:
        if len(b) < 7:
            raise Fail("Bad COLR header box (bad size)")
        info["enumcs"] = struct.unpack_from(">I", b, 3)[0]
        info["has_colr"] = True
    elif b[0] == 2:
        if len(b) == 3:
            raise Fail("Not enough memory to read the ICC profile")
        info["has_colr"] = True


def _bpcc(b: bytes, info: dict):
    if info["ihdr"] is None or len(b) != info["nc"]:
        raise Fail("Bad BPCC header box (bad size)")


def _pclr(b: bytes, info: dict):
    if info["pclr"] or len(b) < 3:
        raise Fail("bad PCLR box")
    ne, npc = struct.unpack_from(">HB", b)
    if ne == 0 or ne > 1024 or npc == 0 or len(b) < 3 + npc:
        raise Fail("Invalid PCLR box")
    sizes = [min(((v & 0x7F) + 1 + 7) >> 3, 4) for v in b[3:3 + npc]]
    if len(b) < 3 + npc + ne * sum(sizes):
        raise Fail("Invalid PCLR box")
    info["pclr"] = npc


def _cmap(b: bytes, info: dict):
    if not info["pclr"]:
        raise Fail("Need to read a PCLR box before the CMAP box.")
    if info["cmap"]:
        raise Fail("Only one CMAP box is allowed.")
    if len(b) < info["pclr"] * 4:
        raise Fail("Insufficient data for CMAP box.")
    info["cmap"] = True


def _cdef(b: bytes, info: dict):
    if info["cdef"] or len(b) < 2:
        raise Fail("bad CDEF box")
    n = struct.unpack_from(">H", b)[0]
    if n == 0 or len(b) < 2 + n * 6:
        raise Fail("bad CDEF box")
    info["cdef"] = True


_IMG_BOXES = {b"ihdr": _ihdr, b"colr": _colr, b"bpcc": _bpcc,
              b"pclr": _pclr, b"cmap": _cmap, b"cdef": _cdef}
_ENUMCS = {16: CS_SRGB, 17: CS_GRAY, 18: CS_SYCC, 24: CS_EYCC, 12: CS_CMYK}


# ------------------------------------------------- Pillow's unpackers ----
# Jpeg2KDecode.c's j2k_unpackers: (mode, colour space, components,
# subsampling allowed, unpacker)
_UNPACKERS = (
    ("L", CS_GRAY, 1, False, "gray_l"), ("P", CS_SRGB, 1, False, "gray_l"),
    ("PA", CS_SRGB, 2, False, "graya_la"),
    ("I;16", CS_GRAY, 1, False, "gray_i"),
    ("I;16B", CS_GRAY, 1, False, "gray_i"),
    ("LA", CS_GRAY, 2, False, "graya_la"),
    ("RGB", CS_GRAY, 1, False, "gray_rgb"),
    ("RGB", CS_GRAY, 2, False, "gray_rgb"),
    ("RGB", CS_SRGB, 3, True, "srgb_rgb"), ("RGB", CS_SYCC, 3, True, "sycc"),
    ("RGB", CS_SRGB, 4, True, "srgb_rgb"), ("RGB", CS_SYCC, 4, True, "sycc"),
    ("RGBA", CS_GRAY, 1, False, "gray_rgb"),
    ("RGBA", CS_GRAY, 2, False, "graya_la"),
    ("RGBA", CS_SRGB, 3, True, "srgb_rgb"),
    ("RGBA", CS_SYCC, 3, True, "sycc"),
    ("RGBA", CS_GRAY, 4, True, "srgba"), ("RGBA", CS_SRGB, 4, True, "srgba"),
    ("RGBA", CS_SYCC, 4, True, "sycca"),
    ("CMYK", CS_CMYK, 4, True, "srgba"))


def _csize(prec: int) -> int:
    n = (prec + 7) >> 3
    return 4 if n == 3 else n


def _tile_buffer(cs, samples) -> bytes:
    """opj_tcd_update_tile_data: each component's samples in turn, 1, 2
    or 4 little-endian bytes each."""
    parts = []
    for img, a in zip(cs.comps, samples):
        n = _csize(img["prec"])
        dt = {1: "<u1", 2: "<u2", 4: "<u4"}[n]
        parts.append((a & ((1 << (8 * n)) - 1)).astype(dt).tobytes())
    return b"".join(parts)


def _words(buf: np.ndarray, base: int, csiz: int, idx: np.ndarray):
    """Unsigned little-endian words of csiz bytes at base + csiz * idx."""
    off = base + csiz * idx
    v = np.zeros(idx.shape, np.int64)
    for k in range(csiz):
        v |= buf[off + k].astype(np.int64) << (8 * k)
    return v


def _unpack(cs, kind: str, mode: str, buf: bytes, w: int, h: int):
    """One tile through Pillow's unpacker -> (h, w) or (h, w, 4) pixels
    of the image's mode (I;16 as uint16)."""
    ncomp = len(cs.comps)
    csiz = [_csize(c["prec"]) for c in cs.comps]
    total = sum(csiz)
    tile_bytes = w * h * total
    b = np.zeros(max(len(buf), tile_bytes) + 8, np.uint8)
    b[:len(buf)] = np.frombuffer(buf, np.uint8)
    y, x = np.mgrid[0:h, 0:w]

    def chan(n, base, dx=1, dy=1, bits=8):
        c = cs.comps[n]
        shift = bits - c["prec"]
        offset = 1 << (c["prec"] - 1) if c["sgnd"] else 0
        if shift < 0:
            offset += 1 << (-shift - 1)
        word = _words(b, base, csiz[n], (y // dy) * (w // dx) + x // dx)
        v = (offset + word) & 0xFFFFFFFF
        v = v >> -shift if shift < 0 else (v << shift) & 0xFFFFFFFF
        return v & ((1 << bits) - 1)

    if kind in ("gray_l", "gray_i"):
        return chan(0, 0, bits=16 if kind == "gray_i" else 8).astype(
            np.uint16 if kind == "gray_i" else np.uint8)
    out = np.zeros((h, w, 4), np.uint8)
    out[..., 3] = 255
    if kind == "gray_rgb":
        out[..., :3] = chan(0, 0)[..., None]
    elif kind == "graya_la":
        out[..., :3] = chan(0, 0)[..., None]
        out[..., 3] = chan(1, csiz[0] * w * h)
    else:
        n_ch = 4 if kind in ("srgba", "sycca") else 3
        base = 0
        for n in range(min(ncomp, 4)):
            c = cs.comps[n]
            if n < n_ch:
                out[..., n] = chan(n, base, c["dx"], c["dy"])
            base += csiz[n] * (w // c["dx"]) * (h // c["dy"])
        if kind in ("sycc", "sycca"):
            out[..., :3] = rawmode.ycbcr_to_rgb(out[..., :3])
    return out


def committed_blocks(path: str, tiles: int = None) -> list:
    """The code-blocks of a file's first `tiles` tiles (all: None) as
    tier-2 hands them to tier-1 (the plain loop's check on the card)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data.startswith(b"\xff\x4f"):
        cs = Codestream(data, 0)
    else:
        info = jp2_boxes(data)
        cs = Codestream(data, info["start"], info["ihdr"])
    cs.read_header()
    out, n = [], 0
    while tiles is None or n < tiles:
        tileno = cs.next_tile()
        if tileno is None:
            break
        out += _tile_blocks(cs, tileno, cs.tcps[tileno])[1]
        cs.after_tile()
        n += 1
    return out


def decode(data: bytes, codec: str, mode: str, size) -> np.ndarray:
    """Jpeg2KDecode.c on the file's bytes -> the image in Pillow's mode
    (L / P (H, W) uint8, I;16 (H, W) uint16, the others (H, W, 4)
    uint8); OSError where Pillow's decoder fails."""
    try:
        return _decode(data, codec, mode, size)
    except Fail:
        raise OSError(BROKEN) from None


def _decode(data: bytes, codec: str, mode: str, size) -> np.ndarray:
    if codec == "jp2":
        info = jp2_boxes(data)
        cs = Codestream(data, info["start"], info["ihdr"])
        cs.read_header()
        space = _ENUMCS.get(info["enumcs"], CS_UNKNOWN)
    else:
        cs = Codestream(data, 0)
        cs.read_header()
        space = CS_UNSPECIFIED
    ncomp = len(cs.comps)
    if ncomp < 1 or ncomp > 4:
        raise Fail("an image Pillow cannot handle")
    # the first subsampled component: Pillow's guess at an unspecified
    # colour space (a subsampled second or third component: sYCC)
    sub = next((n for n, c in enumerate(cs.comps)
                if c["dx"] != 1 or c["dy"] != 1), -1)
    if space in (CS_UNSPECIFIED, CS_UNKNOWN):
        space = CS_GRAY if ncomp <= 2 else \
            CS_SYCC if sub in (1, 2) else CS_SRGB
    kind = next((k for m, s, n, ok, k in _UNPACKERS
                 if s == space and n == ncomp and (ok or sub < 0)
                 and m == mode), None)
    if kind is None:
        raise Fail("no unpacker")
    w, h = size
    img = np.zeros((h, w) if kind in ("gray_l", "gray_i") else (h, w, 4),
                   np.uint16 if kind == "gray_i" else np.uint8)
    while True:
        tileno = cs.next_tile()
        if tileno is None:
            break
        tile, samples = _decode_tile(cs, tileno, cs.tcps[tileno])
        x0, y0, x1, y1 = tile["x0"], tile["y0"], tile["x1"], tile["y1"]
        if x0 >= x1 or y0 >= y1 or x0 < cs.x0 or y0 < cs.y0 \
                or x1 - cs.x0 > w or y1 - cs.y0 > h:
            raise Fail("tile outside the image")
        px = _unpack(cs, kind, mode, _tile_buffer(cs, samples),
                     x1 - x0, y1 - y0)
        img[y0 - cs.y0:y1 - cs.y0, x0 - cs.x0:x1 - cs.x0] = px
        cs.after_tile()
    return img


# ------------------------------------------------------------- writing ----
COMMENT = b"Created by OpenJPEG version 2.5.4"


def encode_jpeg2000(px: np.ndarray, path: str = "") -> bytes:
    """(H, W), (H, W, 3) or (H, W, 4) uint8 -> the bytes Pillow 12.1 saves
    for Image.fromarray(px) to `path` as JPEG 2000 with its defaults."""
    a = np.asarray(px, np.uint8)
    if a.ndim == 2:
        a = a[..., None]
    h, w, nc = a.shape
    nres = 6
    while w < (1 << (nres - 1)) or h < (1 << (nres - 1)):
        nres -= 1
    levels = nres - 1
    cs = bytearray(b"\xff\x4f")
    cs += struct.pack(">HHHIIIIIIIIH", SIZ, 38 + 3 * nc, 0, w, h, 0, 0, w,
                      h, 0, 0, nc) + b"\x07\x01\x01" * nc
    cs += struct.pack(">HHBBHBBBBBB", COD, 12, 0, 0, 1, 0, levels, 4, 4, 0,
                      1)
    cs += struct.pack(">HHB", QCD, 4 + 3 * levels, 0x40)
    cs += bytes([8 << 3] + [9 << 3, 9 << 3, 10 << 3] * levels)
    cs += struct.pack(">HHH", COM, 4 + len(COMMENT), 1) + COMMENT
    body = _encode_tile(a, levels)
    cs += struct.pack(">HHHIBB", SOT, 10, 0, 14 + len(body), 0, 1)
    cs += b"\xff\x93" + body + b"\xff\xd9"
    if path.lower().endswith(".j2k"):
        return bytes(cs)
    ihdr = struct.pack(">IIHBBBB", h, w, nc, 7, 7, 0, 0)
    colr = struct.pack(">BBBI", 1, 0, 0, 17 if nc == 1 else 16)
    jp2h = _box(b"ihdr", ihdr) + _box(b"colr", colr)
    if nc == 4:
        jp2h += _box(b"cdef", struct.pack(">H", 4) + b"".join(
            struct.pack(">HHH", i, 1 if i == 3 else 0, 0 if i == 3 else i + 1)
            for i in range(4)))
    return (_box(b"jP  ", b"\r\n\x87\n")
            + _box(b"ftyp", b"jp2 \x00\x00\x00\x00jp2 ")
            + _box(b"jp2h", jp2h) + _box(b"jp2c", bytes(cs)))


def _box(typ: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + typ + body


def _encode_tile(a: np.ndarray, levels: int) -> bytes:
    """opj_tcd_encode_tile for one tile at the origin: DC shift, the 5/3
    wavelet, tier-1 on 64 x 64 code-blocks, then one layer of packets in
    LRCP order (one precinct a resolution)."""
    h, w, nc = a.shape
    comps = []
    for c in range(nc):
        origins = [(0, 0)] * (levels + 1)
        ll, details = j2k_dwt.forward_53(a[..., c].astype(np.int64) - 128,
                                         origins)
        res = [[(0, ll, 8)]] + [[(b, arr, 8 + (1 if b < 3 else 2))
                                 for b, arr in zip((1, 2, 3), d)]
                                for d in details]
        comps.append(res)
    out = bytearray()
    for r in range(levels + 1):
        for c in range(nc):
            bands = []
            for bandno, arr, expn in comps[c][r]:
                bh, bw = arr.shape
                if bh == 0 or bw == 0:
                    continue
                cw, ch = _cdiv(bw, 64), _cdiv(bh, 64)
                cblks = []
                for j in range(cw * ch):
                    x, y = (j % cw) * 64, (j // cw) * 64
                    nb, passes, data = j2k_t1.encode_block(
                        arr[y:y + 64, x:x + 64], bandno)
                    lens = [(p[0] - (passes[k - 1][0] if k else 0), p[1])
                            for k, p in enumerate(passes)]
                    cblks.append(dict(numbps=nb, data=data[:passes[-1][0]]
                                      if passes else b"",
                                      layers=[(len(passes), lens)]))
                bands.append(dict(numbps=expn + 1, precincts=[dict(
                    cblks=cblks, incl=j2k_t2.TagTree(cw, ch),
                    imsb=j2k_t2.TagTree(cw, ch))]))
            out += j2k_t2.write_header(bands, 0, 0).flush()
            for band in bands:
                for cb in band["precincts"][0]["cblks"]:
                    out += cb["data"]
    return bytes(out)
