"""Autodesk FLI / FLC animations read as Pillow 12.1's FliImagePlugin reads
them: the first frame, on its palette.

The opener checks the header's zero fields, reads the palette from the
first colour chunk (type 11's 6-bit levels shifted left by 2, type 4's as
they are, each channel taken modulo 256) of the first frame (after a
prefix chunk, if any), and seeks to frame 0.  The frame's tile starts at
byte 128 whatever a prefix chunk says, so a file with one fails to load,
as in Pillow.  ImageFile.load feeds the frame decoder (FliDecode.c) the
frame's size in bytes at a time until it is done; the decoder's loop is
`csrc/fli.cpp` (built by host_build.py at first use), and `_frame_plain`
is its plain version, held equal by the tests.
"""
from __future__ import annotations

import ctypes
import os
import struct
from pathlib import Path

import numpy as np

from .pil_open import _i16, _i32, _pillow_open
from .rawmode import to_rgb

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "fli.cpp"
_LIB = None
# ImageFile's messages for the decoder's errors
_ERRORS = {-1: "buffer overrun", -2: "broken data stream",
           -3: "unrecognized data stream contents"}


def library():
    """Build (once per source hash) and load csrc/fli.cpp; raises if the
    compiler fails."""
    global _LIB
    if _LIB is None:
        from ..host_build import BUILD_DIR, compile_shared
        info = compile_shared(_SRC, BUILD_DIR, "FLI frame decode")
        lib = ctypes.CDLL(info["path"])
        p = ctypes.c_void_p
        lib.lrt_fli_frame.argtypes = [p, ctypes.c_int64, p, ctypes.c_int32,
                                      ctypes.c_int32, p]
        lib.lrt_fli_frame.restype = ctypes.c_int64
        _LIB = lib
    return _LIB


def frame(buf: bytes, img: np.ndarray) -> tuple:
    """FliDecode.c on `buf` over img ((ysize, xsize) uint8, written in
    place) -> (its return value, its error code)."""
    status = np.zeros(1, np.int32)
    src = np.frombuffer(buf, np.uint8) if buf else np.zeros(1, np.uint8)
    n = library().lrt_fli_frame(src.ctypes.data, len(buf), img.ctypes.data,
                                img.shape[1], img.shape[0],
                                status.ctypes.data)
    return int(n), int(status[0])


@_pillow_open
def open_fli(fp):
    """FliImageFile._open: the header's zero fields, the first frame's
    palette chunk, then seek(0)'s frame size."""
    s = fp.read(128)
    if not (len(s) >= 16 and _i16(s, 4) in (0xAF11, 0xAF12)
            and _i16(s, 14) in (0, 3) and s[20:22] == b"\x00" * 2
            and s[42:80] == b"\x00" * 38 and s[88:] == b"\x00" * 40):
        raise SyntaxError("not an FLI/FLC file")
    n_frames = _i16(s, 6)
    size = _i16(s, 8), _i16(s, 10)
    palette = [(a, a, a) for a in range(256)]
    s = fp.read(16)
    if _i16(s, 4) == 0xF100:
        fp.seek(128 + _i32(s))
        s = fp.read(16)
    if _i16(s, 4) == 0xF1FA:
        chunk_size = None
        for _ in range(_i16(s, 6)):
            if chunk_size is not None:
                fp.seek(chunk_size - 6, os.SEEK_CUR)
            s = fp.read(6)
            kind = _i16(s, 4)
            if kind in (4, 11):
                shift = 2 if kind == 11 else 0
                i = 0
                for _ in range(_i16(fp.read(2))):
                    s = fp.read(2)
                    i = i + s[0]
                    n = s[1] or 256
                    s = fp.read(n * 3)
                    for n in range(0, len(s), 3):
                        palette[i] = ((s[n] << shift) & 255,
                                      (s[n + 1] << shift) & 255,
                                      (s[n + 2] << shift) & 255)
                        i += 1
                break
            chunk_size = _i32(s)
            if not chunk_size:
                break
    if n_frames <= 0:
        raise EOFError("attempt to seek outside sequence")
    fp.seek(128)
    s = fp.read(4)
    if not s:
        raise EOFError("missing frame size")
    framesize = _i32(s)
    data = fp.getvalue()
    pal = np.array(palette, np.uint8)
    return "P", size, lambda: to_rgb(
        decode_first_frame(data, size, framesize), "P", pal)


def decode_first_frame(data: bytes, size, framesize: int,
                       frame_fn=None) -> np.ndarray:
    """ImageFile.load of frame 0: the decoder fed `framesize` bytes at a
    time from byte 128 -> (h, w) palette indices.  frame_fn: the frame
    decoder (default the C++ one; the tests pass `_frame_plain`)."""
    frame_fn = frame_fn or frame
    w, h = size
    img = np.zeros((h, w), np.uint8)
    pos, b = 128, b""
    while True:
        s = data[pos:pos + framesize]
        pos += len(s)
        if not s:
            raise OSError("image file is truncated "
                          f"({len(b)} bytes not processed)")
        b += s
        n, err = frame_fn(b, img)
        if n < 0:
            break
        b = b[n:]
    if err < 0:
        raise OSError(f"{_ERRORS[err]} when reading image file")
    return img


# ------------------------------------------------------ plain version ----
class _Stop(Exception):
    """The decoder returns -1 with an error code."""

    def __init__(self, code):
        super().__init__(code)
        self.code = code


def _frame_plain(buf: bytes, img: np.ndarray) -> tuple:
    """csrc/fli.cpp's lrt_fli_frame in Python (same contract as
    `frame`)."""
    try:
        return _frame_body(buf, img), 0
    except _Stop as stop:
        return -1, stop.code


def _frame_body(buf: bytes, img: np.ndarray) -> int:
    ysize, xsize = img.shape
    flat = img.reshape(-1)
    nbytes = len(buf)
    if nbytes < 4:
        return 0
    if nbytes + nbytes % 2 < _i32(buf):
        return 0
    if nbytes < 8:
        raise _Stop(-1)
    if _i16(buf, 4) != 0xF1FA:
        raise _Stop(-3)
    chunks = _i16(buf, 6)
    ptr, nbytes = 16, nbytes - 16
    for _ in range(chunks):
        if nbytes < 10:
            raise _Stop(-1)
        data = ptr + 6
        end = ptr + nbytes

        def need(n):
            if data + n > end:
                raise _Stop(-1)

        kind = _i16(buf, ptr + 4)
        if kind == 7:                                   # SS2
            lines = _i16(buf, data)
            data += 2
            line = y = 0
            while line < lines and y < ysize:
                row = y * xsize
                need(2)
                packets = _i16(buf, data)
                data += 2
                while packets & 0x8000:
                    if packets & 0x4000:
                        y += 65536 - packets
                        if y >= ysize:
                            raise _Stop(-1)
                        row = y * xsize
                    else:
                        flat[row + xsize - 1] = packets & 255
                    need(2)
                    packets = _i16(buf, data)
                    data += 2
                p = x = 0
                while p < packets:
                    need(2)
                    x += buf[data]
                    if buf[data + 1] >= 128:
                        need(4)
                        i = 256 - buf[data + 1]
                        if x + i + i > xsize:
                            break
                        flat[row + x:row + x + 2 * i] = np.tile(
                            np.frombuffer(buf, np.uint8, 2, data + 2), i)
                        x += 2 * i
                        data += 4
                    else:
                        i = 2 * buf[data + 1]
                        if x + i > xsize:
                            break
                        need(2 + i)
                        flat[row + x:row + x + i] = np.frombuffer(
                            buf, np.uint8, i, data + 2)
                        data += 2 + i
                        x += i
                    p += 1
                if p < packets:
                    break
                line += 1
                y += 1
            if line < lines:
                raise _Stop(-1)
        elif kind == 12:                                # LC
            y = _i16(buf, data)
            ymax = y + _i16(buf, data + 2)
            data += 4
            while y < ymax and y < ysize:
                row = y * xsize
                need(1)
                packets = buf[data]
                data += 1
                p = x = 0
                while p < packets:
                    need(2)
                    x += buf[data]
                    if buf[data + 1] & 0x80:
                        i = 256 - buf[data + 1]
                        if x + i > xsize:
                            break
                        need(3)
                        flat[row + x:row + x + i] = buf[data + 2]
                        data += 3
                    else:
                        i = buf[data + 1]
                        if x + i > xsize:
                            break
                        need(2 + i)
                        flat[row + x:row + x + i] = np.frombuffer(
                            buf, np.uint8, i, data + 2)
                        data += i + 2
                    p += 1
                    x += i
                if p < packets:
                    break
                y += 1
            if y < ymax:
                raise _Stop(-1)
        elif kind == 13:                                # BLACK
            flat[:] = 0
        elif kind == 15:                                # BRUN
            for y in range(ysize):
                row = y * xsize
                data += 1
                x = 0
                while x < xsize:
                    need(2)
                    if buf[data] & 0x80:
                        i = 256 - buf[data]
                        if x + i > xsize:
                            break
                        need(i + 1)
                        flat[row + x:row + x + i] = np.frombuffer(
                            buf, np.uint8, i, data + 1)
                        data += i + 1
                    else:
                        i = buf[data]
                        if x + i > xsize:
                            break
                        flat[row + x:row + x + i] = buf[data + 1]
                        data += 2
                    x += i
                if x != xsize:
                    raise _Stop(-1)
        elif kind == 16:                                # COPY
            if (2 ** 31 - 1) // xsize < ysize:
                raise _Stop(-1)
            if data + xsize * ysize > end:
                return ptr
            flat[:] = np.frombuffer(buf, np.uint8, xsize * ysize, data)
        elif kind not in (4, 11, 18):
            raise _Stop(-3)
        advance = struct.unpack_from("<i", buf, ptr)[0]
        if advance == 0:
            raise _Stop(-2)
        if advance < 0 or advance > nbytes:
            raise _Stop(-1)
        ptr += advance
        nbytes -= advance
    raise _Stop(0)

