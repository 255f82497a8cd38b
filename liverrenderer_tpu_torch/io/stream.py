"""The binary stream layer (counterpart of liverrenderer_tpu/io/stream.py;
the reference's Stream, FileStream, MemoryStream, ZStream,
MemoryMappedFile and FileResolver, src/core/{stream,fstream,mstream,
zstream,mmap,fresolver}.cpp): typed little-endian reads and writes over a
file, a growable buffer or a memory mapping, zlib inflation and deflation
over an inner stream, and search-path file resolution.  `.serialized`
meshes (scene/meshio.py) read through it.
"""
from __future__ import annotations

import mmap
import os
import struct
import zlib

import numpy as np

_FMT = {"u1": "<B", "u2": "<H", "i2": "<h", "u4": "<I", "i4": "<i",
        "u8": "<Q", "i8": "<q", "f4": "<f", "f8": "<d"}


class Stream:
    """A seekable binary stream with typed little-endian reads and
    writes."""

    def read(self, n: int) -> bytes:
        raise NotImplementedError

    def write(self, data: bytes) -> int:
        raise NotImplementedError

    def seek(self, pos: int) -> None:
        raise NotImplementedError

    def tell(self) -> int:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass

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

    def write_value(self, kind: str, v) -> None:
        self.write(struct.pack(_FMT[kind], v))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FileStream(Stream):
    """A buffered random-access file (fstream.cpp); `mode` as open()'s."""

    def __init__(self, path: str, mode: str = "rb"):
        self._f = open(path, mode)
        self.path = path

    def read(self, n):
        return self._f.read(n)

    def write(self, data):
        return self._f.write(data)

    def seek(self, pos):
        self._f.seek(pos)

    def tell(self):
        return self._f.tell()

    def size(self):
        self._f.flush()
        return os.fstat(self._f.fileno()).st_size

    def close(self):
        self._f.close()


class MemoryStream(Stream):
    """A growable in-memory stream (mstream.cpp)."""

    def __init__(self, data: bytes = b""):
        self._buf = bytearray(data)
        self._pos = 0

    def read(self, n):
        out = bytes(self._buf[self._pos:self._pos + n])
        self._pos += len(out)
        return out

    def write(self, data):
        end = self._pos + len(data)
        if end > len(self._buf):
            self._buf.extend(b"\0" * (end - len(self._buf)))
        self._buf[self._pos:end] = data
        self._pos = end
        return len(data)

    def seek(self, pos):
        self._pos = pos

    def tell(self):
        return self._pos

    def size(self):
        return len(self._buf)

    def getvalue(self) -> bytes:
        return bytes(self._buf)


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
        self.path = path

    def data(self):
        return memoryview(self._m)

    def size(self) -> int:
        return len(self._m)

    def seek(self, pos: int):
        self._pos = pos

    def tell(self):
        return self._pos

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
    """zlib over an inner stream (zstream.cpp): mode "r" inflates in
    chunks from the inner stream's current position and seeks forward
    only; mode "w" deflates each write and flushes the rest on close."""

    CHUNK = 1 << 16

    def __init__(self, inner: Stream, mode: str = "r"):
        if mode not in ("r", "w"):
            raise ValueError(f"ZStream mode {mode!r}: 'r' or 'w'")
        self._inner = inner
        self._mode = mode
        if mode == "r":
            self._z = zlib.decompressobj()
            self._buf = bytearray()
        else:
            self._z = zlib.compressobj()
        self._pos = 0

    def read(self, n: int) -> bytes:
        while len(self._buf) < n:
            raw = self._inner.read(self.CHUNK)
            if not raw:
                self._buf += self._z.flush()
                break
            self._buf += self._z.decompress(raw)
        out = bytes(self._buf[:n])
        del self._buf[:n]
        self._pos += len(out)
        return out

    def write(self, data):
        self._inner.write(self._z.compress(bytes(data)))
        self._pos += len(data)
        return len(data)

    def tell(self):
        return self._pos

    def seek(self, pos):
        if self._mode == "r" and pos >= self._pos:
            self.read(pos - self._pos)
            return
        raise ValueError("ZStream seeks forward only")

    def size(self):
        raise ValueError("ZStream has no size until fully inflated")

    def close(self):
        if self._mode == "w":
            self._inner.write(self._z.flush())


class FileResolver:
    """Ordered search-path file resolution (fresolver.cpp)."""

    def __init__(self, paths=()):
        self.paths = [os.path.abspath(p) for p in paths] or [os.getcwd()]

    def append(self, path: str):
        self.paths.append(os.path.abspath(path))

    def prepend(self, path: str):
        self.paths.insert(0, os.path.abspath(path))

    def resolve(self, name: str) -> str:
        if os.path.isabs(name) and os.path.exists(name):
            return name
        for p in self.paths:
            cand = os.path.join(p, name)
            if os.path.exists(cand):
                return cand
        return name
