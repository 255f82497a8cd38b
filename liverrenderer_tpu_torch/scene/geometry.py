"""Canonical shape meshes + mesh utilities (host-side numpy).

Replaces the reference's analytic shape plugins (src/shapes/{rectangle,cube,
disk,cylinder}.cpp) with triangle tessellation at scene-build time: on TPU a
single homogeneous triangle stream beats per-type intersection dispatch
(branch divergence kills the VPU).  Spheres stay analytic (scene/ir.py) since
the liver scenes use large smooth spheres where tessellation is visible.
"""
from __future__ import annotations

import numpy as np


class MeshData:
    """Host-side mesh: vertices (V,3), faces (F,3), normals (V,3) or None,
    uvs (V,2) or None."""

    def __init__(self, vertices, faces, normals=None, uvs=None):
        self.vertices = np.asarray(vertices, np.float32)
        self.faces = np.asarray(faces, np.int32)
        self.normals = None if normals is None else np.asarray(normals, np.float32)
        self.uvs = None if uvs is None else np.asarray(uvs, np.float32)

    def transformed(self, trafo):
        v = trafo.apply_points(self.vertices).astype(np.float32)
        n = None
        if self.normals is not None:
            n = trafo.apply_normals(self.normals).astype(np.float32)
        return MeshData(v, self.faces, n, self.uvs)

    @property
    def face_areas(self):
        v0 = self.vertices[self.faces[:, 0]]
        v1 = self.vertices[self.faces[:, 1]]
        v2 = self.vertices[self.faces[:, 2]]
        return 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)


def rectangle() -> MeshData:
    """Canonical rectangle: [-1,1]^2 in z=0 plane, normal +z
    (reference src/shapes/rectangle.cpp semantics)."""
    v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    n = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return MeshData(v, f, n, uv)


def cube() -> MeshData:
    """Canonical cube [-1,1]^3 with outward per-face normals
    (src/shapes/cube.cpp)."""
    verts, faces, normals, uvs = [], [], [], []
    axes = [(0, 1, 2), (0, 1, 2), (0, 2, 1), (0, 2, 1), (1, 2, 0), (1, 2, 0)]
    signs = [1, -1, 1, -1, 1, -1]
    for (a, b, c), s in zip(axes, signs):
        base = len(verts)
        for (ua, ub) in [(-1, -1), (1, -1), (1, 1), (-1, 1)]:
            p = np.zeros(3)
            p[a], p[b], p[c] = ua, ub, s
            verts.append(p)
            n = np.zeros(3)
            n[c] = s
            normals.append(n)
            uvs.append([(ua + 1) / 2, (ub + 1) / 2])
        if s > 0:
            faces += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
        else:
            faces += [[base, base + 2, base + 1], [base, base + 3, base + 2]]
    return MeshData(np.array(verts, np.float32), np.array(faces, np.int32),
                    np.array(normals, np.float32), np.array(uvs, np.float32))


def disk(segments: int = 64) -> MeshData:
    """Unit disk in z=0 tessellated as a fan (src/shapes/disk.cpp capability;
    analytic disk deferred)."""
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    rim = np.stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)], -1)
    v = np.concatenate([[[0, 0, 0]], rim]).astype(np.float32)
    f = np.array([[0, 1 + i, 1 + (i + 1) % segments] for i in range(segments)],
                 np.int32)
    n = np.tile(np.array([[0, 0, 1]], np.float32), (len(v), 1))
    uv = (v[:, :2] + 1) / 2
    return MeshData(v, f, n, uv.astype(np.float32))


def cylinder(segments: int = 64, p0_z: float = 0.0,
             p1_z: float = 1.0, radius: float = 1.0) -> MeshData:
    """Open cylinder along +z (src/shapes/cylinder.cpp capability;
    tessellated with smooth normals — the analytic quadric is deferred)."""
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ring = np.stack([radius * np.cos(ang), radius * np.sin(ang)], -1)
    v0 = np.concatenate([ring, np.full((segments, 1), p0_z)], -1)
    v1 = np.concatenate([ring, np.full((segments, 1), p1_z)], -1)
    v = np.concatenate([v0, v1]).astype(np.float32)
    f = []
    for i in range(segments):
        j = (i + 1) % segments
        f.append([i, j, segments + i])
        f.append([j, segments + j, segments + i])
    nrm = np.concatenate([np.stack([np.cos(ang), np.sin(ang),
                                    np.zeros_like(ang)], -1)] * 2)
    uv = np.stack([np.concatenate([ang, ang]) / (2 * np.pi),
                   np.concatenate([np.zeros(segments),
                                   np.ones(segments)])], -1)
    return MeshData(v, np.asarray(f, np.int32), nrm.astype(np.float32),
                    uv.astype(np.float32))


def sphere_mesh(subdiv: int = 3) -> MeshData:
    """Icosphere tessellation of the unit sphere (fallback when an analytic
    sphere cannot be used, e.g. inside shapegroups)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdiv):
        edge_mid = {}
        verts = list(v)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                p = (verts[a] + verts[b]) / 2
                p = p / np.linalg.norm(p)
                edge_mid[key] = len(verts)
                verts.append(p)
            return edge_mid[key]

        nf = []
        for (a, b, c) in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.array(verts)
        f = np.array(nf, np.int64)
    n = v.copy()
    theta = np.arccos(np.clip(v[:, 2], -1, 1))
    phi = np.arctan2(v[:, 1], v[:, 0])
    uv = np.stack([(phi + np.pi) / (2 * np.pi), theta / np.pi], -1)
    return MeshData(v.astype(np.float32), f.astype(np.int32),
                    n.astype(np.float32), uv.astype(np.float32))


def compute_vertex_normals(vertices, faces):
    """Area-weighted vertex normals (reference mesh.cpp recompute_vertex_normals)."""
    v0 = vertices[faces[:, 0]]
    v1 = vertices[faces[:, 1]]
    v2 = vertices[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)  # area-weighted
    n = np.zeros_like(vertices)
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(ln, 1e-20)).astype(np.float32)


def icosphere(subdiv: int = 1) -> MeshData:
    """Unit icosphere (ellipsoid instancing base, scene/builder.py
    ellipsoids shapes)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int32)
    for _ in range(subdiv):
        mid = {}
        nv = list(v)
        nf = []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = v[a] + v[b]
                m /= np.linalg.norm(m)
                mid[key] = len(nv)
                nv.append(m)
            return mid[key]

        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(nv)
        f = np.asarray(nf, np.int32)
    return MeshData(v.astype(np.float32), f, v.astype(np.float32),
                    np.zeros((len(v), 2), np.float32))


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """(x, y, z, w) quaternions (N,4) -> rotation matrices (N,3,3)."""
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3), np.float32)
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - z * w)
    R[..., 0, 2] = 2 * (x * z + y * w)
    R[..., 1, 0] = 2 * (x * y + z * w)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - x * w)
    R[..., 2, 0] = 2 * (x * z - y * w)
    R[..., 2, 1] = 2 * (y * z + x * w)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R
