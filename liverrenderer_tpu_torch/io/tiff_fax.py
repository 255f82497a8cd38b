"""CCITT fax strips and tiles of TIFF (compression 2, 3, 4 and 32771) as
libtiff 4.7's tif_fax3.c decodes them for Pillow.

- Compression 2 (modified Huffman, "tiff_ccitt") and 32771 (the same with
  each row word-aligned, "tiff_raw_16"): libtiff's Fax3DecodeRLE, rows of
  1-D codes, each row after the first starting at a byte (a 16-bit word)
  of the coded data.
- Compression 3 (T.4, "group3"): each row starts with an EOL (fill bits
  before it are skipped); under T4Options bit 0 a tag bit after it picks
  1-D or 2-D coding (Fax3Decode1D, Fax3Decode2D).
- Compression 4 (T.6, "group4"): 2-D rows against the row before (white
  above the first), to an EOFB or the end of the data (Fax4Decode).

The decoder is libtiff's: the 7-bit mode table and the 12- and 13-bit
white and black tables (mkg3states.c's, rebuilt here from the code
words), codes read least significant bit first from each byte after
FillOrder's bit reversal, zero bits padded past the end of the data, the
run arrays (`nruns` entries a row, two halves swapped row to row; the
reference row is the runs as the row fill clipped them), and its handling
of bad data: a bad code word, a row whose runs do not sum to its width
(CLEANUP_RUNS), an EOL inside a 2-D row, or the extension code of
uncompressed mode ends the row and decoding goes on; running out of data
fails the strip (libtiff returns -1, Pillow's "decoder error"), except
in compression 4 once a row is out, where the rows not written keep what
the strip buffer held (`strip` of `decode`).  A run array that would
overflow fails the strip.

The loop runs in C++ (csrc/fax.cpp, built at first use like
csrc/lzw.cpp; a failed build raises); `_decode_plain` is its plain
Python version with the same contract.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "fax.cpp"
_LIB = None

# TIFFFaxTabEnt states (tif_fax3.h)
(S_NULL, S_PASS, S_HORIZ, S_V0, S_VR, S_VL, S_EXT, S_TERMW, S_TERMB,
 S_MAKEUPW, S_MAKEUPB, S_MAKEUP, S_EOL) = range(13)
# the decoders
RLE, RLEW, G3_1D, G3_2D, G4 = range(5)
# Fax3CodecState's mode bit the decoder sets on G3 data without EOLs
NOEOL = 2

_TERM_W = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 "
    "001000 000011 110100 110101 101010 101011 0100111 0001100 0001000 "
    "0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 "
    "00010101 00010110 00010111 00101000 00101001 00101010 00101011 "
    "00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
    "01010011 01010100 01010101 00100100 00100101 01011000 01011001 "
    "01011010 01011011 01001010 01001011 00110010 00110011 00110100")
_MAKEUP_W = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 "
    "011011011 010011000 010011001 010011010 011000 010011011")
_TERM_B = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 "
    "0000101 0000111 00000100 00000111 000011000 0000010111 0000011000 "
    "0000001000 00001100111 00001101000 00001101100 00000110111 "
    "00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 "
    "000001101011 000011010010 000011010011 000011010100 000011010101 "
    "000011010110 000011010111 000001101100 000001101101 000011011010 "
    "000011011011 000001010100 000001010101 000001010110 000001010111 "
    "000001100100 000001100101 000001010010 000001010011 000000100100 "
    "000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 "
    "000001100111")
_MAKEUP_B = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 "
    "0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 "
    "0000001100101")
# the makeup codes of 1,792 to 2,560 pixels, shared by both colours
_MAKEUP = ("00000001000 00000001100 00000001101 000000010010 000000010011 "
           "000000010100 000000010101 000000010110 000000010111 "
           "000000011100 000000011101 000000011110 000000011111")


def _code(bits: str) -> int:
    """A code word, first bit least significant (the decoder's order)."""
    return sum(1 << i for i, b in enumerate(bits) if b == "1")


def _fill(table, size, protos, state):
    """mkg3states.c's FillTable."""
    for bits, param in protos:
        w = len(bits)
        for c in range(_code(bits), 1 << size, 1 << w):
            table[c] = (state, w, param)


def _tables():
    """(main 128, white 4096, black 8192) -> int32 arrays of (state,
    width, param) rows, as tif_fax3sm.c holds them (the C++ reads these
    too)."""
    main = np.zeros((128, 3), np.int32)
    _fill(main, 7, [("0001", 0)], S_PASS)
    _fill(main, 7, [("001", 0)], S_HORIZ)
    _fill(main, 7, [("1", 0)], S_V0)
    _fill(main, 7, [("011", 1), ("000011", 2), ("0000011", 3)], S_VR)
    _fill(main, 7, [("010", 1), ("000010", 2), ("0000010", 3)], S_VL)
    _fill(main, 7, [("0000001", 0)], S_EXT)
    _fill(main, 7, [("0000000", 0)], S_EOL)
    makeup = [(b, 1792 + 64 * i) for i, b in enumerate(_MAKEUP.split())]
    white = np.zeros((4096, 3), np.int32)
    _fill(white, 12, [(b, 64 * (i + 1))
                      for i, b in enumerate(_MAKEUP_W.split())], S_MAKEUPW)
    _fill(white, 12, makeup, S_MAKEUP)
    _fill(white, 12, [(b, i) for i, b in enumerate(_TERM_W.split())],
          S_TERMW)
    _fill(white, 12, [("00000000000", 0)], S_EOL)
    black = np.zeros((8192, 3), np.int32)
    _fill(black, 13, [(b, 64 * (i + 1))
                      for i, b in enumerate(_MAKEUP_B.split())], S_MAKEUPB)
    _fill(black, 13, makeup, S_MAKEUP)
    _fill(black, 13, [(b, i) for i, b in enumerate(_TERM_B.split())],
          S_TERMB)
    _fill(black, 13, [("00000000000", 0)], S_EOL)
    return main, white, black


MAIN, WHITE, BLACK = _tables()
# each byte with its bits in reverse order (libtiff's TIFFBitRevTable)
_REV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def library():
    """Build (once per source hash) and load csrc/fax.cpp; raises if the
    compiler fails."""
    global _LIB
    if _LIB is None:
        from ..host_build import BUILD_DIR, compile_shared
        info = compile_shared(_SRC, BUILD_DIR, "CCITT fax decode")
        lib = ctypes.CDLL(info["path"])
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.lrt_fax_decode.argtypes = [p, i64, i32, i32, i32, i32, i32, i32,
                                       p, i32, p, p, p, p, p, p]
        lib.lrt_fax_decode.restype = i32
        _LIB = lib
    return _LIB


def nruns(rowpixels: int, kind: int) -> int:
    """Fax3SetupState's run-array size of one row."""
    n = -(-(rowpixels + 1) // 32) * 32
    return 2 * n if kind in (G3_2D, G4) else n


def decoder_kind(compression: int, t4options: int) -> int:
    if compression == 2:
        return RLE
    if compression == 32771:
        return RLEW
    if compression == 4:
        return G4
    return G3_2D if t4options & 1 else G3_1D


def decode(src: bytes, kind: int, rows: int, rowpixels: int, rowbytes: int,
           lsb_first: bool, odd_start: bool, runs: np.ndarray,
           strip: np.ndarray, flags: np.ndarray) -> int:
    """One strip or tile of `rows` rows into `strip` (rows * rowbytes
    uint8, written in place) with the run arrays `runs` (2 * nruns uint32)
    and the mode bits `flags` (1 int32), both kept from strip to strip ->
    libtiff's status, 1 or -1.  `lsb_first`: FillOrder 2; `odd_start`: the
    data starts at an odd file offset (the word alignment of compression
    32771 is the pointer's)."""
    buf = np.frombuffer(src, np.uint8) if src else np.zeros(1, np.uint8)
    return library().lrt_fax_decode(
        buf.ctypes.data, len(src), kind, rows, rowpixels, rowbytes,
        int(lsb_first), int(odd_start), runs.ctypes.data, len(runs) // 2,
        strip.ctypes.data, flags.ctypes.data, MAIN.ctypes.data,
        WHITE.ctypes.data, BLACK.ctypes.data, _REV.ctypes.data)



# ------------------------------------------------------ plain version ----
def _s32(x: int) -> int:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


class _Overflow(Exception):
    """A run array would overflow: libtiff fails the strip."""


class _Eof(Exception):
    """The data ran out where libtiff jumps to its EOF label."""


def _decode_plain(src: bytes, kind: int, rows: int, rowpixels: int,
                  rowbytes: int, lsb_first: bool, odd_start: bool,
                  runs: np.ndarray, strip: np.ndarray,
                  flags: np.ndarray) -> int:
    """decode's plain Python version (runs, strip and flags written in
    place)."""
    st = _Plain(src, kind, rowpixels, lsb_first, odd_start, runs, flags)
    return st.run(rows, rowbytes, strip)


class _Plain:
    def __init__(self, src, kind, lastx, lsb_first, odd_start, runs, flags):
        self.flags = flags
        self.src, self.cp, self.ep = src, 0, len(src)
        self.bitmap = None if lsb_first else _REV
        self.odd_start = odd_start
        self.kind, self.lastx = kind, lastx
        self.runs = runs
        self.nruns = len(runs) // 2
        self.acc = self.avail = 0
        self.eolcnt = 0
        self.cur = 0
        self.ref = self.nruns
        if kind in (G3_2D, G4):                 # Fax3PreDecode
            runs[self.ref] = lastx
            runs[self.ref + 1] = 0

    # ---- bits
    def _byte(self):
        b = self.src[self.cp]
        self.cp += 1
        return int(self.bitmap[b]) if self.bitmap is not None else b

    def need8(self, n):
        if self.avail < n:
            if self.cp >= self.ep:
                if self.avail == 0:
                    raise _Eof
                self.avail = n
            else:
                self.acc |= self._byte() << self.avail
                self.avail += 8

    def need16(self, n):
        if self.avail < n:
            if self.cp >= self.ep:
                if self.avail == 0:
                    raise _Eof
                self.avail = n
            else:
                self.acc |= self._byte() << self.avail
                self.avail += 8
                if self.avail < n:
                    if self.cp >= self.ep:
                        self.avail = n
                    else:
                        self.acc |= self._byte() << self.avail
                        self.avail += 8

    def get(self, n):
        return self.acc & ((1 << n) - 1)

    def clr(self, n):
        self.avail -= n
        self.acc >>= n

    def lookup(self, wid, table, need):
        need(wid)
        ent = table[self.get(wid)]
        self.clr(int(ent[1]))
        return int(ent[0]), int(ent[2])

    # ---- runs
    def setvalue(self, x):
        if self.pa >= self.thisrun + self.nruns:
            raise _Overflow
        self.runs[self.pa] = (self.run_length + x) & 0xFFFFFFFF
        self.pa += 1
        self.a0 = _s32(self.a0 + x)
        self.run_length = 0

    def cleanup(self):
        """CLEANUP_RUNS."""
        lastx = self.lastx
        if self.run_length:
            self.setvalue(0)
        if self.a0 != lastx:
            while self.a0 > lastx and self.pa > self.thisrun:
                self.pa -= 1
                self.a0 = _s32(self.a0 - int(self.runs[self.pa]))
            if self.a0 < lastx:
                if self.a0 < 0:
                    self.a0 = 0
                if (self.pa - self.thisrun) & 1:
                    self.setvalue(0)
                self.setvalue(lastx - self.a0)
            elif self.a0 > lastx:
                self.setvalue(lastx)
                self.setvalue(0)

    def fill(self, row):
        """_TIFFFax3fillruns: white runs clear bits, black runs set them,
        each clipped to the row (in the run array too)."""
        runs, lastx = self.runs, self.lastx
        k, end = self.thisrun, self.pa
        if (end - k) & 1:
            if end < len(runs):
                runs[end] = 0
            end += 1
        bits = np.unpackbits(row)
        x = 0
        for i in range(k, end):
            run = int(runs[i]) if i < len(runs) else 0
            if x + run > lastx or run > lastx:
                run = lastx - x
                if i < len(runs):
                    runs[i] = run
            if run:
                bits[x:x + run] = (i - k) & 1
                x += run
        row[:] = np.packbits(bits)[:len(row)]

    def sync_eol(self):
        """SYNC_EOL: past the next EOL.  Data that ends after the EOL's
        zeros marks the image as coded without EOLs (FAXMODE_NOEOL, kept
        for the rest of the image) and decoding starts again at the
        strip's first byte (tryG3WithoutEOL)."""
        if self.flags[0] & NOEOL:
            return
        if self.eolcnt == 0:
            while True:
                self.need16(11)
                if self.get(11) == 0:
                    break
                self.clr(1)
        while True:
            try:
                self.need8(8)
            except _Eof:
                self.flags[0] |= NOEOL
                self.cp = self.acc = self.avail = 0
                return
            if self.get(8):
                break
            self.clr(8)
        while self.get(1) == 0:
            self.clr(1)
        self.clr(1)
        self.eolcnt = 0

    def expand1d(self):
        """EXPAND1D, its cleanup included; _Eof after its own cleanup."""
        try:
            self._expand1d()
        except _Eof:
            self.cleanup()
            raise
        self.cleanup()

    def _expand1d(self):
        lastx = self.lastx
        while True:
            if not self._horiz_run(WHITE, 12, S_TERMW, S_MAKEUPW, True):
                return
            if self.a0 >= lastx:
                return
            if not self._horiz_run(BLACK, 13, S_TERMB, S_MAKEUPB, True):
                return
            if self.a0 >= lastx:
                return
            if self.runs[self.pa - 1] == 0 and self.runs[self.pa - 2] == 0:
                self.pa -= 2

    def check_b1(self):
        if self.pa != self.thisrun:
            while self.b1 <= self.a0 and self.b1 < self.lastx:
                if self.pb + 1 >= self.ref + self.nruns:
                    raise _Overflow
                self.b1 = _s32(self.b1 + int(self.runs[self.pb])
                               + int(self.runs[self.pb + 1]))
                self.pb += 2

    def _ref(self):
        v = int(self.runs[self.pb]) if self.pb < len(self.runs) else 0
        self.pb += 1
        return v

    def _horiz_run(self, table, wid, term, makeup, eol=False):
        """One run's makeup and terminating codes -> False on a code that
        ends the row (an EOL, in 1-D coding, sets EOLcnt)."""
        while True:
            state, param = self.lookup(wid, table, self.need16)
            if eol and state == S_EOL:
                self.eolcnt = 1
                return False
            if state == term:
                self.setvalue(param)
                return True
            if state in (makeup, S_MAKEUP):
                self.a0 = _s32(self.a0 + param)
                self.run_length = _s32(self.run_length + param)
                continue
            return False

    def expand2d(self):
        """EXPAND2D, its cleanup included; _Eof after its own cleanup."""
        lastx = self.lastx
        try:
            ended = False
            while self.a0 < lastx:
                if self.pa >= self.thisrun + self.nruns:
                    raise _Overflow
                state, param = self.lookup(7, MAIN, self.need8)
                if state == S_PASS:
                    self.check_b1()
                    if self.pb + 1 >= self.ref + self.nruns:
                        raise _Overflow
                    self.b1 = _s32(self.b1 + self._ref())
                    self.run_length = _s32(self.run_length + self.b1 - self.a0)
                    self.a0 = self.b1
                    self.b1 = _s32(self.b1 + self._ref())
                elif state == S_HORIZ:
                    if (self.pa - self.thisrun) & 1:
                        ok = self._horiz_run(BLACK, 13, S_TERMB, S_MAKEUPB) \
                            and self._horiz_run(WHITE, 12, S_TERMW, S_MAKEUPW)
                    else:
                        ok = self._horiz_run(WHITE, 12, S_TERMW, S_MAKEUPW) \
                            and self._horiz_run(BLACK, 13, S_TERMB, S_MAKEUPB)
                    if not ok:
                        ended = True
                        break
                    self.check_b1()
                elif state in (S_V0, S_VR):
                    self.check_b1()
                    self.setvalue((self.b1 - self.a0 + param) & 0xFFFFFFFF)
                    if self.pb >= self.ref + self.nruns:
                        raise _Overflow
                    self.b1 = _s32(self.b1 + self._ref())
                elif state == S_VL:
                    self.check_b1()
                    if self.b1 < _s32(self.a0 + param):
                        ended = True
                        break
                    self.setvalue((self.b1 - self.a0 - param) & 0xFFFFFFFF)
                    self.pb -= 1
                    self.b1 = _s32(self.b1 - int(self.runs[self.pb]))
                elif state == S_EXT:
                    self._eol_run()
                    ended = True
                    break
                elif state == S_EOL:
                    self._eol_run()
                    self.need8(4)
                    self.clr(4)
                    self.eolcnt = 1
                    ended = True
                    break
                else:
                    ended = True
                    break
            if not ended and self.run_length:
                if _s32(self.run_length + self.a0) < lastx:
                    self.need8(1)
                    if not self.get(1):
                        ended = True
                    else:
                        self.clr(1)
                if not ended:
                    self.setvalue(0)
        except _Eof:
            self.cleanup()
            raise
        self.cleanup()

    def _eol_run(self):
        if self.pa < len(self.runs):
            self.runs[self.pa] = (self.lastx - self.a0) & 0xFFFFFFFF
        self.pa += 1

    # ---- the decoders
    def run(self, rows, rowbytes, strip):
        kind = self.kind
        out = strip[:rows * rowbytes].reshape(rows, rowbytes)
        line = 0
        try:
            while line < rows:
                self.a0 = self.run_length = 0
                self.thisrun = self.pa = self.cur
                try:
                    if kind in (G3_1D, G3_2D):
                        self.sync_eol()
                    is1d = True
                    if kind == G3_2D:
                        self.need8(1)
                        is1d = bool(self.get(1))
                        self.clr(1)
                    if kind in (G3_2D, G4):
                        self.pb = self.ref
                        self.b1 = self._ref()
                except _Eof:
                    # EOF2D / EOF1D: the cleanup, then the fill
                    self.cleanup()
                    self.fill(out[line])
                    return -1
                try:
                    if kind == G4 or (kind == G3_2D and not is1d):
                        self.expand2d()
                    else:
                        self.expand1d()
                except _Eof:
                    if kind == G4:
                        return self._g4_end(out, line)
                    self.fill(out[line])
                    return -1
                if kind == G4 and self.eolcnt:
                    return self._g4_end(out, line)
                self.fill(out[line])
                if kind in (RLE, RLEW):
                    if kind == RLE:
                        self.clr(self.avail & 7)
                    else:
                        self.clr(self.avail & 15)
                        if self.avail == 0 and \
                                (self.cp & 1) != int(self.odd_start):
                            self.cp += 1
                elif kind == G3_2D:
                    if self.pa < self.thisrun + self.nruns:
                        self.setvalue(0)
                    self.cur, self.ref = self.ref, self.cur
                elif kind == G4:
                    self.setvalue(0)
                    self.cur, self.ref = self.ref, self.cur
                line += 1
        except _Overflow:
            return -1
        return 1

    def _g4_end(self, out, line):
        """Fax4Decode's EOFG4: the EOFB's bits, the row's fill; an error
        only when no row of the strip came out."""
        try:
            self.need16(13)
        except _Eof:
            pass
        self.clr(13)
        self.fill(out[line])
        return 1 if line else -1
