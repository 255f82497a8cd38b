"""Mesh files: OBJ, PLY (ascii, binary little- and big-endian) and Mitsuba
`.serialized` (counterpart of liverrenderer_tpu/scene/meshio.py), host
numpy.

OBJ files go through the port's C++ reader (csrc/mesh_load.cpp, its copy
of the JAX package's native/mesh_load.cpp, built at first use by
host_build.compile_shared; a failed build raises) and return what the JAX
package returns with its native library built: a corner without a texture
index gets uv (0, 0) (the JAX package's Python reader gives (0, 1)), and
zero normals are replaced by the computed vertex normals.  `_load_obj` is
the reader's plain Python version, which the tests hold it to.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from . import geometry as geo

# PLY property types
_PLY_T = {"float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
          "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
          "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
          "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4"}
# serialized-format flags
_S_NORMALS, _S_UVS, _S_COLORS, _S_FACE_NORMALS, _S_DOUBLE = \
    0x0001, 0x0002, 0x0008, 0x0010, 0x2000

_OBJ_SRC = Path(__file__).resolve().parent.parent / "csrc" / "mesh_load.cpp"
_OBJ_LIB = None


def load_mesh(path: str, face_normals: bool = False,
              shape_index: int = 0) -> geo.MeshData:
    """A mesh file -> MeshData (normals None when face normals are asked
    for, so the builder computes vertex normals)."""
    low = path.lower()
    if low.endswith(".serialized"):
        mesh = _load_serialized(path, shape_index)
    elif low.endswith(".obj"):
        mesh = load_obj_native(path)
    elif low.endswith(".ply"):
        mesh = _load_ply(path)
    else:
        raise ValueError(f"unsupported mesh format: {path}")
    if face_normals:
        mesh.normals = None
    return mesh


def _corner(tok: bytes):
    """(v, vt, vn) indices of one face corner, 0 where absent."""
    parts = tok.split(b"/")
    ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
    return int(parts[0]), ti, ni


def _float3(toks, k):
    out = []
    for t in toks[1:1 + k]:
        try:
            out.append(np.float32(float(t)))
        except ValueError:
            out.append(np.float32(0.0))
    return out + [np.float32(0.0)] * (k - len(out))


def obj_library():
    """Build (once per source hash) and load csrc/mesh_load.cpp; raises if
    the compiler fails."""
    global _OBJ_LIB
    if _OBJ_LIB is None:
        from ..host_build import BUILD_DIR, compile_shared
        info = compile_shared(_OBJ_SRC, BUILD_DIR, "OBJ reader")
        lib = ctypes.CDLL(info["path"])
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.lrt_obj_load.argtypes = [ctypes.c_char_p, i64p, i64p, i64p, i32p,
                                     i32p]
        lib.lrt_obj_load.restype = ctypes.c_int
        p = ctypes.c_void_p
        lib.lrt_obj_fetch.argtypes = [ctypes.c_int64, p, p, p, p]
        lib.lrt_obj_fetch.restype = ctypes.c_int
        _OBJ_LIB = lib
    return _OBJ_LIB


def load_obj_native(path: str) -> geo.MeshData:
    """An OBJ file through the C++ reader, zero normals repaired."""
    lib = obj_library()
    handle, nv, nt = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    has_uv, has_n = ctypes.c_int32(), ctypes.c_int32()
    if lib.lrt_obj_load(str(path).encode(), ctypes.byref(handle),
                        ctypes.byref(nv), ctypes.byref(nt),
                        ctypes.byref(has_uv), ctypes.byref(has_n)) != 0:
        raise OSError(f"OBJ load failed: {path}")
    verts = np.empty((nv.value, 3), np.float32)
    faces = np.empty((nt.value, 3), np.int32)
    nrms = np.empty((nv.value, 3), np.float32) if has_n.value else None
    uvs = np.empty((nv.value, 2), np.float32) if has_uv.value else None
    lib.lrt_obj_fetch(handle.value, verts.ctypes.data, faces.ctypes.data,
                      None if nrms is None else nrms.ctypes.data,
                      None if uvs is None else uvs.ctypes.data)
    return geo.MeshData(verts, faces, _repair_normals(verts, faces, nrms),
                        uvs)


def _repair_normals(verts, faces, nrms):
    """Zero normals (a corner without a normal index) -> the computed
    vertex normals, as the JAX package repairs its native reader's."""
    if nrms is not None:
        bad = np.linalg.norm(nrms, axis=-1) < 1e-8
        if bad.any():
            nrms[bad] = geo.compute_vertex_normals(verts, faces)[bad]
    return nrms


def _load_obj(path: str) -> geo.MeshData:
    """Fan-triangulated polygons; vertices split by unique (v, vt, vn)
    corner; uv.y = 1 - t (Mitsuba's obj.cpp)."""
    v, vt, vn, tris = [], [], [], []
    with open(path, "rb") as f:
        for line in f:
            line = line.split(b"#", 1)[0] if line.lstrip()[:1] == b"f" \
                else line
            toks = line.split()
            if not toks:
                continue
            head = toks[0]
            if head == b"v":
                v.append(_float3(toks, 3))
            elif head == b"vt":
                vt.append(_float3(toks, 2))
            elif head == b"vn":
                vn.append(_float3(toks, 3))
            elif head == b"f":
                poly = [_corner(t) for t in toks[1:]]
                for k in range(1, len(poly) - 1):
                    tris.append((poly[0], poly[k], poly[k + 1]))
    v = np.asarray(v, np.float32).reshape(-1, 3)
    nv, nt, nn = len(v), len(vt), len(vn)

    def fix(i, n):
        return i - 1 if i > 0 else n + i

    has_uv = nt > 0 and any(c[1] for tri in tris for c in tri)
    has_n = nn > 0 and any(c[2] for tri in tris for c in tri)
    if not has_uv and not has_n:
        faces = np.asarray([[fix(c[0], nv) for c in tri] for tri in tris],
                           np.int32).reshape(-1, 3)
        return geo.MeshData(v, faces)
    vt = np.asarray(vt, np.float32).reshape(-1, 2)
    vn = np.asarray(vn, np.float32).reshape(-1, 3)
    corner_map = {}
    vi_src, uvs, nrms, faces = [], [], [], []
    for tri in tris:
        for c in tri:
            idx = corner_map.get(c)
            if idx is None:
                idx = corner_map[c] = len(vi_src)
                vi_src.append(fix(c[0], nv))
                if has_uv:
                    if c[1]:
                        t = vt[fix(c[1], nt)]
                        uvs.append((t[0], np.float32(1.0) - t[1]))
                    else:
                        uvs.append((0.0, 0.0))
                if has_n:
                    nrms.append(vn[fix(c[2], nn)] if c[2] else (0.0, 0.0,
                                                                 0.0))
            faces.append(idx)
    verts = v[np.asarray(vi_src, np.int64)]
    faces = np.asarray(faces, np.int32).reshape(-1, 3)
    uvs = np.asarray(uvs, np.float32) if has_uv else None
    nrms = np.asarray(nrms, np.float32) if has_n else None
    return geo.MeshData(verts, faces, _repair_normals(verts, faces, nrms),
                        uvs)


def _load_serialized(path: str, shape_index: int = 0) -> geo.MeshData:
    """Mitsuba's `.serialized` container (serialized.cpp): a 0x041C magic
    and version, one zlib stream per mesh, and a dictionary of mesh
    offsets at the end of the file.  Only the chosen mesh is inflated."""
    from ..io.stream import MemoryMappedFile, ZStream

    with MemoryMappedFile(path) as mf:
        data = mf.data()
        n_total = mf.size()
        magic, version = np.frombuffer(data, "<u2", 2, 0)
        if magic != 0x041C:
            raise ValueError(f"not a serialized mesh: {path}")
        count = int(np.frombuffer(data, "<u4", 1, n_total - 4)[0])
        if version >= 4:
            offs = np.frombuffer(data, "<u8", count, n_total - 4 - 8 * count)
        else:
            offs = np.frombuffer(data, "<u4", count,
                                 n_total - 4 - 4 * count).astype(np.uint64)
        if not 0 <= shape_index < count:
            raise ValueError(f"{path}: shape_index {shape_index} of {count}")
        mf.seek(int(offs[shape_index]) + 4)     # the mesh's magic, version
        zs = ZStream(mf)
        flags = int(zs.read_value("u4"))
        if version >= 4:
            zs.read_string()                    # the mesh's name
        n_v = int(zs.read_value("u8"))
        n_t = int(zs.read_value("u8"))
        fdt = "f8" if flags & _S_DOUBLE else "f4"
        verts = zs.read_array(fdt, n_v * 3).reshape(n_v, 3) \
            .astype(np.float32)
        normals = uvs = None
        if flags & _S_NORMALS:
            normals = zs.read_array(fdt, n_v * 3).reshape(n_v, 3) \
                .astype(np.float32)
        if flags & _S_UVS:
            uvs = zs.read_array(fdt, n_v * 2).reshape(n_v, 2) \
                .astype(np.float32)
        if flags & _S_COLORS:
            zs.read_array(fdt, n_v * 3)
        idt = "u8" if n_v > 0xFFFFFFFF else "u4"
        faces = zs.read_array(idt, n_t * 3).reshape(n_t, 3).astype(np.int32)
    if flags & _S_FACE_NORMALS:
        normals = None
    return geo.MeshData(verts, faces, normals, uvs)


def _ply_header(data: bytes):
    """(format, [(name, count, props)], offset of the body)."""
    hdr_end = data.index(b"end_header\n") + len(b"end_header\n")
    fmt, elements, cur = "ascii", [], None
    for line in data[:hdr_end].decode("ascii", errors="replace") \
            .splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = (parts[1], int(parts[2]), [])
            elements.append(cur)
        elif parts[0] == "property" and cur is not None:
            if parts[1] == "list":
                cur[2].append(("list", parts[2], parts[3], parts[4]))
            else:
                cur[2].append((parts[1], parts[2]))
    return fmt, elements, hdr_end


def _ply_columns(get, names):
    """(vertices, normals or None, uvs or None) from named columns."""
    verts = np.stack([get("x"), get("y"), get("z")], -1).astype(np.float32)
    nrms = uvs = None
    if "nx" in names:
        nrms = np.stack([get("nx"), get("ny"), get("nz")],
                        -1).astype(np.float32)
    for u, v in (("u", "v"), ("s", "t")):
        if u in names:
            uvs = np.stack([get(u), get(v)], -1).astype(np.float32)
            break
    return verts, nrms, uvs


def _load_ply(path: str) -> geo.MeshData:
    """Vertices with optional normals (nx ny nz) and uvs (u v or s t), and
    fan-triangulated faces."""
    with open(path, "rb") as f:
        data = f.read()
    fmt, elements, off = _ply_header(data)
    verts = nrms = uvs = None
    faces = []
    if fmt == "ascii":
        body = data[off:].decode("ascii", errors="replace").split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                ncols = len(props)
                arr = np.asarray(body[pos:pos + count * ncols],
                                 np.float32).reshape(count, ncols)
                pos += count * ncols
                cols = [p[1] for p in props]
                verts, nrms, uvs = _ply_columns(
                    lambda c: arr[:, cols.index(c)], cols)
            elif name == "face":
                for _ in range(count):
                    n = int(body[pos])
                    idx = [int(x) for x in body[pos + 1:pos + 1 + n]]
                    pos += 1 + n
                    faces += [[idx[0], idx[k], idx[k + 1]]
                              for k in range(1, n - 1)]
    else:
        endian = "<" if "little" in fmt else ">"
        for name, count, props in elements:
            if name == "vertex":
                dt = np.dtype([(p[1], endian + _PLY_T[p[0]]) for p in props])
                arr = np.frombuffer(data, dt, count, off)
                off += dt.itemsize * count
                verts, nrms, uvs = _ply_columns(lambda c: arr[c], dt.names)
            elif name == "face":
                faces, off = _ply_binary_faces(data, off, count, props[0],
                                               endian)
    faces = np.asarray(faces, np.int32).reshape(-1, 3)
    return geo.MeshData(verts, faces, nrms, uvs)


def _ply_binary_faces(data: bytes, off: int, count: int, prop, endian):
    """Fan-triangulated binary face lists -> (faces, offset after them)."""
    cnt_t = np.dtype(endian + _PLY_T[prop[1]])
    idx_t = np.dtype(endian + _PLY_T[prop[2]])
    faces = []
    for _ in range(count):
        n = int(np.frombuffer(data, cnt_t, 1, off)[0])
        off += cnt_t.itemsize
        idx = np.frombuffer(data, idx_t, n, off)
        off += idx_t.itemsize * n
        faces += [[int(idx[0]), int(idx[k]), int(idx[k + 1])]
                  for k in range(1, n - 1)]
    return faces, off
