"""The port's file readers and writers against the JAX package's (and
PIL's) on files the tests write themselves: EXR, PFM and PNG images, and
OBJ, PLY and Mitsuba `.serialized` meshes.

Every read must equal the reference exactly: pixels, vertices, normals,
uvs and indices (the same bytes decoded, the same float32 operations).
The JAX package reads EXR and OBJ files through its native library when
it is built (read_exr_any keeps alpha; its OBJ reader differs from its
Python one), and the port follows that library: those comparisons call
the JAX package with the library, the others hold both of its paths.
"""
import os
import struct
import time
import zlib

import numpy as np
import pytest
from PIL import Image

import liverrenderer_tpu._native as jnative
from liverrenderer_tpu.io import exr as jexr
from liverrenderer_tpu.io import image as jimage
from liverrenderer_tpu.io.stream import MemoryStream, ZStream
from liverrenderer_tpu.scene import meshio as jmeshio
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.io import exr as texr
from liverrenderer_tpu_torch.io import png as tpng
from liverrenderer_tpu_torch.scene import meshio as tmeshio
from torch_threads import torch_threads_per_worker  # noqa: F401


def _need_native():
    if not jnative.available():
        pytest.skip("the JAX package's native library is not built")


def _hdr_image(rng, h, w, c):
    """Values over several octaves, negatives and zeros included."""
    img = rng.lognormal(0.0, 2.0, (h, w, c)).astype(np.float32)
    img[rng.uniform(size=img.shape) < 0.05] = 0.0
    img[rng.uniform(size=img.shape) < 0.05] *= -1.0
    return img


# ---------------------------------------------------------------- EXR ----

@pytest.mark.parametrize("writer", ["jax_half", "jax_float", "native",
                                    "port_half"])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_exr_reads_match_jax(tmp_path, np_rng, writer, c):
    """Files from the JAX package's writer (half and float, ZIP), its
    native (OpenEXR) writer and the port's: the port's read_exr equals
    JAX read_exr (R, G, B, alpha dropped), and read_image equals JAX
    read_exr_any with the native library (R, G, B, A, alpha kept)."""
    img = _hdr_image(np_rng, 37, 23, c)        # 37 rows: a ragged block
    p = str(tmp_path / "a.exr")
    if writer == "native":
        _need_native()
        jnative.exr_write(p, img)
    elif writer == "port_half":
        texr.write_exr(p, img)
    else:
        jexr.write_exr(p, img, half=writer == "jax_half")
    np.testing.assert_array_equal(texr.read_exr(p), jexr.read_exr(p))
    _need_native()
    ref = jimage.read_exr_any(p)
    got = lrt.read_image(p)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    # the pixels themselves, through half precision where written so
    want = img.astype(np.float16).astype(np.float32) \
        if writer in ("jax_half", "port_half") else img
    np.testing.assert_array_equal(got[..., :c], want if c > 1 else
                                  np.repeat(want, 3, -1)[..., :1])


def test_exr_writer_float_round_trip(tmp_path, np_rng):
    img = _hdr_image(np_rng, 20, 17, 3)
    p = str(tmp_path / "f.exr")
    lrt.write_image(p, img)                    # float channels
    np.testing.assert_array_equal(lrt.read_image(p), img)
    np.testing.assert_array_equal(jexr.read_exr(p), img)


@pytest.mark.parametrize("what", ["DWAA", "DWAB", "deep", "subsampled"])
def test_exr_codecs_it_lacks_raise(tmp_path, np_rng, what):
    """Files forged to claim DWA compression, deep data or a subsampled
    channel (which the reader no longer lacks: tests/test_torch_exr_dwa.py
    has the real ones) are read, or refused with OSError, as the JAX
    package's native reader reads or refuses them."""
    _need_native()
    p = str(tmp_path / "c.exr")
    jexr.write_exr(p, _hdr_image(np_rng, 4, 4, 3))
    buf = bytearray(open(p, "rb").read())
    if what == "deep":
        struct.pack_into("<i", buf, 4, 2 | 0x800)
    elif what == "subsampled":
        at = buf.index(b"B\x00") + 2 + 8      # B's xSampling
        struct.pack_into("<i", buf, at, 2)
    else:
        at = buf.index(b"compression\x00compression\x00") + 28
        buf[at] = {"DWAA": 8, "DWAB": 9}[what]
    open(p, "wb").write(bytes(buf))
    try:
        ref = jimage.read_image(p)
    except OSError:
        with pytest.raises(OSError):
            lrt.read_image(p)
    else:
        np.testing.assert_array_equal(lrt.read_image(p), ref)


# ---------------------------------------------------------------- PFM ----

@pytest.mark.parametrize("color", [True, False])
def test_pfm_round_trips_match_jax(tmp_path, np_rng, color):
    img = _hdr_image(np_rng, 9, 14, 3 if color else 1)
    a, b = str(tmp_path / "a.pfm"), str(tmp_path / "b.pfm")
    lrt.write_image(a, img)
    jimage.write_image(b, img)
    assert open(a, "rb").read() == open(b, "rb").read()
    for p in (a, b):
        np.testing.assert_array_equal(lrt.read_image(p),
                                      jimage.read_image(p))
    np.testing.assert_array_equal(lrt.read_image(a), img)


# ---------------------------------------------------------------- PNG ----

def _filter_rows(px, ftype, bpp):
    """The five PNG row filters, the specification's loops (the reference
    for the port's decoder)."""
    h, stride = px.shape
    out = np.zeros((h, stride + 1), np.uint8)
    for y in range(h):
        ft = ftype[y]
        out[y, 0] = ft
        for x in range(stride):
            a = int(px[y, x - bpp]) if x >= bpp else 0
            b = int(px[y - 1, x]) if y else 0
            c = int(px[y - 1, x - bpp]) if x >= bpp and y else 0
            if ft == 0:
                pred = 0
            elif ft == 1:
                pred = a
            elif ft == 2:
                pred = b
            elif ft == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
            out[y, 1 + x] = (int(px[y, x]) - pred) & 0xFF
    return out


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _write_png(path, px, ctype, ftype, palette=None, depth=8, interlace=0):
    h, w = px.shape[:2]
    bpp = px.shape[2] if px.ndim == 3 else 1
    rows = _filter_rows(px.reshape(h, -1), ftype, bpp)
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                       interlace))
    if palette is not None:
        body += _chunk(b"PLTE", palette.tobytes())
    body += _chunk(b"IDAT", zlib.compress(rows.tobytes()))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + body + _chunk(b"IEND", b""))


_CTYPES = {"L": (0, 1), "LA": (4, 2), "RGB": (2, 3), "RGBA": (6, 4),
           "P": (3, 1)}


@pytest.mark.parametrize("mode", sorted(_CTYPES))
@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
def test_png_decode_matches_pil(tmp_path, np_rng, mode, filt):
    """Every colour type with every row filter (and all five mixed row by
    row): the port's pixels equal PIL's convert("RGB"), and read_image
    equals the JAX package's (PIL, / 255, the sRGB curve) bit for bit."""
    ctype, bpp = _CTYPES[mode]
    h, w = 11, 13
    # smooth ramps plus noise, so every predictor branch is taken
    base = np.add.outer(np.arange(h) * 9, np.arange(w) * 5)[..., None] \
        + np.arange(bpp) * 40 + np_rng.integers(0, 60, (h, w, bpp))
    px = (base % 256).astype(np.uint8)
    palette = None
    if mode == "P":
        palette = np_rng.integers(0, 256, (256, 3)).astype(np.uint8)
    ftype = [y % 5 for y in range(h)] if filt == "mixed" else [filt] * h
    p = str(tmp_path / "a.png")
    _write_png(p, px[..., 0] if bpp == 1 else px, ctype, ftype, palette)
    ref = np.asarray(Image.open(p).convert("RGB"))
    np.testing.assert_array_equal(tpng.read_png(p), ref)
    for lin in (True, False):
        np.testing.assert_array_equal(lrt.read_image(p, lin),
                                      jimage.read_image(p, lin))


def test_png_paeth_decode_at_height_map_size(tmp_path):
    """A 1,024^2 grey image, every row Paeth-filtered (the port's writer):
    the byte-serial decode's pixels equal PIL's; its seconds are printed
    (pytest -s)."""
    from liverrenderer_tpu_torch.scene.liver_proxy import height_map
    px = np.round(height_map(1024, 0) * 255).astype(np.uint8)
    p = str(tmp_path / "h.png")
    tpng.write_png(p, px)
    t0 = time.perf_counter()
    got = tpng.read_png(p)
    secs = time.perf_counter() - t0
    np.testing.assert_array_equal(got, np.asarray(Image.open(p)
                                                  .convert("RGB")))
    np.testing.assert_array_equal(got[..., 0], px)
    print(f"1024^2 Paeth PNG decode: {secs:.3f} s")


@pytest.mark.parametrize("shape", [(9, 14, 3), (8, 8, 4)])
def test_write_image_png_matches_jax(tmp_path, np_rng, shape):
    """The 8-bit write (sRGB curve, ordered dither, quantisation): PIL
    reads back the JAX package's pixels."""
    img = np_rng.uniform(-0.2, 1.4, shape).astype(np.float32)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    lrt.write_image(a, img)
    jimage.write_image(b, img)
    np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                  np.asarray(Image.open(b)))


def test_png_and_image_files_it_lacks_raise(tmp_path, np_rng):
    """A JPEG (which raised before this reader had its decoder), a 16-bit
    grey and an interlaced PNG read as the JAX package reads them
    (tests/test_torch_png_more.py and tests/test_torch_jpeg.py have the
    rest)."""
    p16 = str(tmp_path / "g16.png")
    Image.fromarray(np_rng.integers(0, 65535, (4, 4)).astype(np.uint16)) \
        .save(p16)
    assert Image.open(p16).mode.startswith("I")
    np.testing.assert_array_equal(lrt.read_image(p16),
                                  jimage.read_image(p16))
    pint = str(tmp_path / "i.png")
    from test_torch_png_more import encode_png
    encode_png(pint, np_rng.integers(0, 256, (5, 6, 3)), 8, 2,
               interlace=True)
    np.testing.assert_array_equal(lrt.read_image(pint),
                                  jimage.read_image(pint))
    pjpg = str(tmp_path / "a.jpg")
    Image.fromarray(np_rng.integers(0, 256, (4, 4, 3)).astype(np.uint8)) \
        .save(pjpg)
    np.testing.assert_array_equal(lrt.read_image(pjpg),
                                  jimage.read_image(pjpg))


# ------------------------------------------------------------- meshes ----

def _assert_mesh_equal(t, j):
    for k in ("vertices", "faces", "normals", "uvs"):
        a, b = getattr(t, k), getattr(j, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)


_OBJ_V = """v 0 0 0
v 1 0 0.25
v 1 1 0
v 0 1 -0.5
v 0.5 1.5 0.125
"""
OBJ = {
    # shared vertices: positions only, a quad and a pentagon (fans)
    "shared_ngon": _OBJ_V + "f 1 2 3 4\nf 1 2 3 4 5\n",
    # split vertices: every corner its own (v, vt, vn)
    "split": _OBJ_V + "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
    "vn 0 0 1\nvn 0 0.6 0.8\n"
    "f 1/1/1 2/2/1 3/3/2\nf 1/1/1 3/3/2 4/4/2 5/2/1\n",
    # negative (relative) indices and a comment after the face
    "negative": _OBJ_V + "vt 0.25 0.75\nvt 0.5 0.5\nvn 1 0 0\n"
    "f -5/-2/-1 -4/-1/-1 -3/-2/-1 # tail\n",
    # no normals: uvs only (v/vt), so the builder computes them
    "missing_normals": _OBJ_V + "vt 0 0\nvt 1 0\nvt 1 1\n"
    "f 1/1 2/2 3/3\nf 1/1 3/3 4/2\n",
    # v//vn, one zero normal (replaced by the computed vertex normal)
    "zero_normal": _OBJ_V + "vn 0 0 1\nvn 0 0 0\n"
    "f 1//1 2//2 3//1\nf 1//1 3//1 4//2\n",
}


@pytest.mark.parametrize("case", sorted(OBJ))
@pytest.mark.parametrize("face_normals", [False, True])
def test_obj_matches_jax(tmp_path, case, face_normals):
    p = str(tmp_path / f"{case}.obj")
    open(p, "w").write(OBJ[case])
    t = tmeshio.load_mesh(p, face_normals=face_normals)
    _assert_mesh_equal(t, jmeshio.load_mesh(p, face_normals=face_normals))
    assert t.faces.shape[0] == {"shared_ngon": 5, "split": 3,
                                "negative": 1, "missing_normals": 2,
                                "zero_normal": 2}[case]
    if case == "zero_normal" and not face_normals:
        assert (np.linalg.norm(t.normals, axis=-1) > 0.5).all()


def test_obj_corner_without_uv_follows_the_native_reader(tmp_path):
    """A face mixing corners with and without a texture index: the JAX
    package's native reader (which the port follows) gives the bare
    corner uv (0, 0), its Python reader (0, 1) (ROADMAP Queue 3)."""
    p = str(tmp_path / "mixed.obj")
    open(p, "w").write(_OBJ_V + "vt 0.25 0.5\nf 1/1 2 3/1\n")
    t = tmeshio.load_mesh(p)
    np.testing.assert_array_equal(t.uvs, [[0.25, 0.5], [0, 0], [0.25, 0.5]])
    np.testing.assert_array_equal(jmeshio._load_obj(p).uvs[1], [0, 1])
    _need_native()
    _assert_mesh_equal(t, jmeshio.load_mesh(p))


def _ply(path, fmt, uv_names=("u", "v"), normals=True, quads=False):
    rng = np.random.default_rng(7)
    v = rng.uniform(-1, 1, (9, 3)).astype(np.float32)
    n = rng.normal(size=(9, 3)).astype(np.float32)
    uv = rng.uniform(size=(9, 2)).astype(np.float32)
    faces = [[0, 1, 2], [2, 3, 4, 5] if quads else [2, 3, 4],
             [5, 6, 7], [7, 8, 0]]
    props = ["x", "y", "z"] + (["nx", "ny", "nz"] if normals else []) \
        + list(uv_names)
    cols = np.concatenate([v] + ([n] if normals else []) + [uv], 1)
    hdr = ["ply", f"format {fmt} 1.0", "element vertex 9"] \
        + [f"property float {p}" for p in props] \
        + [f"element face {len(faces)}",
           "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(hdr) + "\n").encode())
        if fmt == "ascii":
            for row in cols:
                f.write((" ".join(repr(float(x)) for x in row) + "\n")
                        .encode())
            for fc in faces:
                f.write((" ".join(map(str, [len(fc)] + fc)) + "\n")
                        .encode())
        else:
            e = "<" if "little" in fmt else ">"
            f.write(cols.astype(e + "f4").tobytes())
            for fc in faces:
                f.write(struct.pack(f"{e}B{len(fc)}i", len(fc), *fc))


@pytest.mark.parametrize("fmt,uv,normals,quads", [
    ("ascii", ("u", "v"), True, True),
    ("ascii", ("s", "t"), False, False),
    ("binary_little_endian", ("u", "v"), True, False),
    ("binary_little_endian", ("s", "t"), True, True),
    ("binary_big_endian", ("u", "v"), False, False)])
def test_ply_matches_jax(tmp_path, fmt, uv, normals, quads):
    p = str(tmp_path / "m.ply")
    _ply(p, fmt, uv, normals, quads)
    t = tmeshio.load_mesh(p)
    _assert_mesh_equal(t, jmeshio.load_mesh(p))
    assert t.faces.shape == (5 if quads else 4, 3)


def _serialized(path, version, meshes):
    """A Mitsuba .serialized container (as tests/test_stream.py writes
    one): per mesh its magic, version, and a zlib stream of flags, (name,)
    counts, float data and indices; then the offset dictionary."""
    out = MemoryStream()
    offs = []
    for flags, verts, faces, nrm, uv, col in meshes:
        offs.append(out.tell())
        out.write_value("u2", 0x041C)
        out.write_value("u2", version)
        zs = ZStream(out, "w")
        zs.write_value("u4", flags)
        if version >= 4:
            zs.write(f"mesh{len(offs)}".encode() + b"\0")
        zs.write_value("u8", len(verts))
        zs.write_value("u8", len(faces))
        fdt = "<f8" if flags & 0x2000 else "<f4"
        for arr in (verts, nrm, uv, col):
            if arr is not None:
                zs.write(np.asarray(arr, fdt).tobytes())
        zs.write(np.asarray(faces, "<u4").tobytes())
        zs.close()
    for o in offs:
        out.write_value("u8" if version >= 4 else "u4", o)
    out.write_value("u4", len(offs))
    with open(path, "wb") as f:
        f.write(out.getvalue())


@pytest.mark.parametrize("version", [3, 4])
def test_serialized_matches_jax(tmp_path, np_rng, version):
    """Two meshes: f4 data with normals and uvs; f8 data with normals,
    vertex colours (skipped) and the face-normals flag (normals
    dropped)."""
    v0 = np_rng.uniform(-1, 1, (5, 3))
    v1 = np_rng.uniform(-1, 1, (6, 3))
    f0 = [[0, 1, 2], [2, 3, 4]]
    f1 = [[0, 1, 2], [3, 4, 5], [1, 3, 5]]
    meshes = [(0x0001 | 0x0002, v0, f0, np_rng.normal(size=(5, 3)),
               np_rng.uniform(size=(5, 2)), None),
              (0x2000 | 0x0001 | 0x0008 | 0x0010, v1, f1,
               np_rng.normal(size=(6, 3)), None,
               np_rng.uniform(size=(6, 3)))]
    p = str(tmp_path / "two.serialized")
    _serialized(p, version, meshes)
    for idx in (0, 1):
        t = tmeshio.load_mesh(p, shape_index=idx)
        _assert_mesh_equal(t, jmeshio.load_mesh(p, shape_index=idx))
        assert t.faces.shape == (len(meshes[idx][2]), 3)
    assert tmeshio.load_mesh(p, shape_index=1).normals is None
    np.testing.assert_array_equal(tmeshio.load_mesh(p).vertices,
                                  v0.astype(np.float32))
    assert os.path.getsize(p) > 0
