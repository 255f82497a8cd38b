"""The rest of the stream layer (the write side of
liverrenderer_tpu_torch/io/stream.py), the spline and the quadrature
rules on the CPU: tests/test_stream.py's write cases and
tests/test_spline_quad.py's cases through the port, each held against
the JAX package on the same inputs.

Tolerances: streams byte for byte; the spline's values, integrals and
samples within 1e-6 of the JAX package's (the same float32 Hermite
arithmetic, rounded by other kernels); quadrature equal (the same
float64 numpy).
"""
import os
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liverrenderer_tpu.core import quad as jquad
from liverrenderer_tpu.core import spline as jspline
from liverrenderer_tpu.io import stream as jstream
from liverrenderer_tpu_torch.core.quad import (composite_simpson,
                                               gauss_legendre, integrate)
from liverrenderer_tpu_torch.core.spline import (eval_1d, integrate_1d,
                                                 sample_1d)
from liverrenderer_tpu_torch.io.stream import (FileResolver, FileStream,
                                               MemoryMappedFile,
                                               MemoryStream, ZStream)
from liverrenderer_tpu_torch.scene.meshio import load_mesh
from torch_threads import torch_threads_per_worker  # noqa: F401

SPLINE_ATOL = 1e-6


def _typed(ms):
    ms.write_value("u4", 0x041C)
    ms.write_value("f4", 2.5)
    ms.write(b"name\0")
    ms.write_value("u8", 123456789)
    ms.write_value("i2", -3)
    ms.write_value("f8", 1.0 / 3.0)
    return ms


def test_memory_stream_typed_roundtrip():
    ms = _typed(MemoryStream())
    assert ms.getvalue() == _typed(jstream.MemoryStream()).getvalue()
    ms.seek(0)
    assert ms.read_value("u4") == 0x041C
    assert abs(ms.read_value("f4") - 2.5) < 1e-7
    assert ms.read_string() == "name"
    assert ms.read_value("u8") == 123456789
    assert ms.read_value("i2") == -3
    assert ms.read_value("f8") == 1.0 / 3.0
    assert ms.size() == ms.tell() == 4 + 4 + 5 + 8 + 2 + 8
    ms.seek(2)                              # an overwrite inside
    ms.write(b"\xff")
    assert ms.getvalue()[:4] == b"\x1c\x04\xff\x00"


def test_file_stream_and_mmap(tmp_path):
    p = str(tmp_path / "blob.bin")
    arr = np.arange(1000, dtype="<f4")
    with FileStream(p, "wb") as fs:
        fs.write_value("u4", 7)
        fs.write(arr.tobytes())
        assert fs.tell() == 4 + 4000
    with jstream.FileStream(str(tmp_path / "j.bin"), "wb") as fs:
        fs.write_value("u4", 7)
        fs.write(arr.tobytes())
    assert open(p, "rb").read() == open(tmp_path / "j.bin", "rb").read()
    with FileStream(p) as fs:
        assert fs.size() == 4 + 4000
        assert fs.read_value("u4") == 7
        np.testing.assert_array_equal(fs.read_array("f4", 1000), arr)
    with MemoryMappedFile(p) as mf:
        assert mf.size() == 4 + 4000
        view = np.frombuffer(mf.data(), "<f4", 1000, 4)
        np.testing.assert_array_equal(view, arr)
        mf.seek(4)
        np.testing.assert_array_equal(mf.read_array("f4", 10), arr[:10])
        assert mf.tell() == 44


def test_zstream_read_write_roundtrip(tmp_path):
    payload = np.random.default_rng(2).bytes(1000) + b"\0" * 100000
    p = str(tmp_path / "z.bin")
    with FileStream(p, "wb") as fs:
        zs = ZStream(fs, "w")
        zs.write(payload[:512])
        zs.write(payload[512:])
        assert zs.tell() == len(payload)
        zs.close()
    ms = jstream.MemoryStream()
    jz = jstream.ZStream(ms, "w")
    jz.write(payload[:512])
    jz.write(payload[512:])
    jz.close()
    assert open(p, "rb").read() == ms.getvalue()   # the same deflate
    assert os.path.getsize(p) < len(payload)
    with FileStream(p) as fs:
        zs = ZStream(fs, "r")
        head = zs.read(256)
        zs.seek(512)
        tail = zs.read(len(payload) - 512)
        assert head == payload[:256]
        assert tail == payload[512:]
        with pytest.raises(ValueError, match="forward only"):
            zs.seek(0)


def test_zstream_matches_zlib_one_shot():
    blob = zlib.compress(b"abc" * 50000)
    zs = ZStream(MemoryStream(blob), "r")
    assert zs.read(150000) == b"abc" * 50000
    with pytest.raises(ValueError, match="mode"):
        ZStream(MemoryStream(), "a")


def test_file_resolver(tmp_path):
    sub = tmp_path / "a"
    sub.mkdir()
    (sub / "x.obj").write_text("o")
    for resolver in (FileResolver, jstream.FileResolver):
        r = resolver([str(tmp_path)])
        assert r.resolve("missing.obj") == "missing.obj"
        r.append(str(sub))
        assert r.resolve("x.obj") == str(sub / "x.obj")
        assert r.resolve(str(sub / "x.obj")) == str(sub / "x.obj")
        r.prepend(str(tmp_path))
        assert r.paths[0] == str(tmp_path)


def test_serialized_mesh_through_streams(tmp_path):
    """A 2-mesh v4 serialized container written through the port's
    streams, byte for byte the JAX package's, read back by the port's
    mesh loader (serialized.cpp's container layout)."""
    def container(ns):
        def mesh_blob(name, verts, faces, uvs=None):
            ms = ns.MemoryStream()
            ms.write_value("u2", 0x041C)
            ms.write_value("u2", 4)
            zs = ns.ZStream(ms, "w")
            zs.write_value("u4", 0x0002 if uvs is not None else 0)
            zs.write(name.encode() + b"\0")
            zs.write_value("u8", len(verts))
            zs.write_value("u8", len(faces))
            zs.write(np.asarray(verts, "<f4").tobytes())
            if uvs is not None:
                zs.write(np.asarray(uvs, "<f4").tobytes())
            zs.write(np.asarray(faces, "<u4").tobytes())
            zs.close()
            return ms.getvalue()

        out = ns.MemoryStream()
        out.write(mesh_blob("m0", V0, F0))
        off1 = out.tell()
        out.write(mesh_blob("m1", V1, F1, UV1))
        out.write_value("u8", 0)
        out.write_value("u8", off1)
        out.write_value("u4", 2)
        return out.getvalue()

    blob = container(_PORT)
    assert blob == container(jstream)
    p = str(tmp_path / "two.serialized")
    with open(p, "wb") as f:
        f.write(blob)
    m = load_mesh(p, shape_index=1)
    np.testing.assert_allclose(m.vertices, np.asarray(V1, np.float32))
    np.testing.assert_array_equal(m.faces, np.asarray(F1, np.int32))
    assert m.uvs is not None and m.uvs.shape == (4, 2)
    assert load_mesh(p, shape_index=0).vertices.shape == (3, 3)


class _PORT:
    """The port's stream classes in the JAX module's namespace shape."""
    MemoryStream = MemoryStream
    ZStream = ZStream


V0 = [[0, 0, 0], [1, 0, 0], [0, 1, 0]]
V1 = [[0, 0, 1], [2, 0, 1], [0, 2, 1], [2, 2, 1]]
F0 = [[0, 1, 2]]
F1 = [[0, 1, 2], [1, 3, 2]]
UV1 = [[0, 0], [1, 0], [0, 1], [1, 1]]


# ---------------------------------------------------------------- spline

def _spline_close(got, ref):
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=SPLINE_ATOL)


def test_spline_interpolates_nodes():
    vals = [0.0, 1.0, 0.5, 2.0, 1.0]
    xs = np.linspace(0.0, 1.0, 5, dtype=np.float32)
    out = eval_1d(torch.as_tensor(xs), vals)
    np.testing.assert_allclose(out.numpy(), vals, atol=1e-6)
    _spline_close(out, jspline.eval_1d(jnp.asarray(xs), jnp.asarray(vals)))


def test_spline_reproduces_cubic():
    xs_n = np.linspace(0.0, 1.0, 9)
    vals = (3 * xs_n ** 2 - 2 * xs_n + 0.5).astype(np.float32)
    xq = (np.random.default_rng(0).random(100) * 0.999).astype(np.float32)
    out = eval_1d(torch.as_tensor(xq), torch.as_tensor(vals))
    np.testing.assert_allclose(out.numpy(), 3 * xq ** 2 - 2 * xq + 0.5,
                               atol=2e-2)
    _spline_close(out, jspline.eval_1d(jnp.asarray(xq), jnp.asarray(vals)))
    # clamped outside the domain, on another interval
    xo = np.float32([-1.0, 2.0, 3.5, 0.25])
    _spline_close(eval_1d(torch.as_tensor(xo), vals, 2.0, 3.0),
                  jspline.eval_1d(jnp.asarray(xo), jnp.asarray(vals), 2.0,
                                  3.0))


def test_spline_integral_matches_quadrature():
    xs_n = np.linspace(0.0, 1.0, 17)
    vals = (np.sin(3 * xs_n) + 1.5).astype(np.float32)
    cdf = integrate_1d(torch.as_tensor(vals))
    ref = integrate(lambda x: np.sin(3 * x) + 1.5, 0.0, 1.0, 32)
    assert abs(float(cdf[-1]) - ref) < 1e-3
    _spline_close(cdf, jspline.integrate_1d(jnp.asarray(vals)))
    _spline_close(integrate_1d(vals, -1.0, 2.0),
                  jspline.integrate_1d(jnp.asarray(vals), -1.0, 2.0))


def test_spline_sampling_histogram():
    xs_n = np.linspace(0.0, 1.0, 17)
    vals = (0.2 + xs_n ** 2).astype(np.float32)
    u = np.random.default_rng(1).random(100_000).astype(np.float32)
    x = sample_1d(torch.as_tensor(u), torch.as_tensor(vals))
    hist, edges = np.histogram(x.numpy(), bins=16, range=(0, 1),
                               density=True)
    centers = 0.5 * (edges[:-1] + edges[1:])
    dens = (0.2 + centers ** 2)
    dens /= dens.mean()
    np.testing.assert_allclose(hist / hist.mean(), dens, rtol=0.08)
    _spline_close(x[:4096], jspline.sample_1d(jnp.asarray(u[:4096]),
                                              jnp.asarray(vals)))


def test_gauss_legendre_exact_for_polys():
    val = integrate(lambda x: x ** 7 - 2 * x ** 3 + x, 0.0, 2.0, 4)
    ref = 2 ** 8 / 8 - 2 * 2 ** 4 / 4 + 2 ** 2 / 2
    assert abs(val - ref) < 1e-9
    for n in (1, 4, 17):
        for a, b in zip(gauss_legendre(n), jquad.gauss_legendre(n)):
            np.testing.assert_array_equal(a, b)


def test_composite_simpson():
    val = integrate(lambda x: np.exp(x), 0.0, 1.0, 65, composite_simpson)
    assert abs(val - (np.e - 1.0)) < 1e-8
    assert val == jquad.integrate(lambda x: np.exp(x), 0.0, 1.0, 65,
                                  jquad.composite_simpson)
    with pytest.raises(ValueError, match="odd"):
        composite_simpson(4)
