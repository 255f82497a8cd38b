"""The read side of the binary stream layer that `.serialized` meshes
need (counterpart of liverrenderer_tpu/io/stream.py): a memory-mapped
file and a zlib inflating stream over it, with typed little-endian reads
(the reference's Stream::read_* surface)."""
from __future__ import annotations

import mmap
import struct
import zlib

import numpy as np

_FMT = {"u1": "<B", "u2": "<H", "i2": "<h", "u4": "<I", "i4": "<i",
        "u8": "<Q", "i8": "<q", "f4": "<f", "f8": "<d"}


class Stream:
    """A readable binary stream with typed little-endian reads."""

    def read(self, n: int) -> bytes:
        raise NotImplementedError

    def read_value(self, kind: str):
        fmt = _FMT[kind]
        return struct.unpack(fmt, self.read(struct.calcsize(fmt)))[0]

    def read_array(self, kind: str, count: int) -> np.ndarray:
        nbytes = np.dtype(kind).itemsize * count
        return np.frombuffer(self.read(nbytes), "<" + kind, count)

    def read_string(self) -> str:
        """A null-terminated string."""
        out = bytearray()
        while True:
            c = self.read(1)
            if not c or c == b"\0":
                return out.decode("utf-8", errors="replace")
            out += c


class MemoryMappedFile(Stream):
    """A read-only memory-mapped file; `data()` is the mapping as a
    buffer."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        try:
            self._m = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        except (OSError, ValueError):
            self._f.close()
            raise
        self._pos = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def data(self):
        return memoryview(self._m)

    def size(self) -> int:
        return len(self._m)

    def seek(self, pos: int):
        self._pos = pos

    def read(self, n: int) -> bytes:
        out = self._m[self._pos:self._pos + n]
        self._pos += len(out)
        return out

    def close(self):
        try:
            self._m.close()
        except BufferError:
            # numpy views of data() are still alive: the mapping lives
            # until they are collected
            pass
        self._f.close()


class ZStream(Stream):
    """zlib inflation, in chunks, of an inner stream from its current
    position."""

    CHUNK = 1 << 16

    def __init__(self, inner: Stream):
        self._inner = inner
        self._z = zlib.decompressobj()
        self._buf = bytearray()

    def read(self, n: int) -> bytes:
        while len(self._buf) < n:
            raw = self._inner.read(self.CHUNK)
            if not raw:
                self._buf += self._z.flush()
                break
            self._buf += self._z.decompress(raw)
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out
