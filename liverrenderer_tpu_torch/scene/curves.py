"""Curve shapes (reference src/shapes/{linearcurve,bsplinecurve}.cpp;
counterpart of liverrenderer_tpu/scene/curves.py, the same numpy
operations, so the tessellation is bit-equal).

Curves are tessellated at build time into triangle tubes with per-vertex
radial normals and fiber tangents: the tubes ride the closest-hit sweep
kernel like any other mesh, and the fiber tangent that the hair BSDF's
shading frame needs is carried as a per-vertex attribute
(Scene.tangents, read by accel/intersect.compute_si).

File format matches linearcurve.cpp:186-246: one "x y z radius" control
point per line, blank lines separate curves.
"""
from __future__ import annotations

import numpy as np

from .geometry import MeshData


def load_curve_file(path: str):
    """Returns a list of (points (N,3) float32, radii (N,) float32)."""
    curves = []
    pts, rad = [], []
    with open(path) as f:
        for line in f:
            s = line.split()
            if not s:
                if len(pts) >= 2:
                    curves.append((np.asarray(pts, np.float32),
                                   np.asarray(rad, np.float32)))
                pts, rad = [], []
                continue
            x, y, z, r = (float(v) for v in s[:4])
            pts.append((x, y, z))
            rad.append(r)
    if len(pts) >= 2:
        curves.append((np.asarray(pts, np.float32),
                       np.asarray(rad, np.float32)))
    if not curves:
        raise ValueError(f"empty curve file {path}")
    return curves


def bspline_to_polyline(pts, radii, subdiv: int = 4):
    """Uniform cubic B-spline through control points -> polyline samples
    (bsplinecurve.cpp evaluates segments of 4 consecutive control points;
    n-3 segments)."""
    pts = np.asarray(pts, np.float64)
    radii = np.asarray(radii, np.float64)
    n = len(pts)
    if n < 4:
        return pts.astype(np.float32), radii.astype(np.float32)
    out_p, out_r = [], []
    for seg in range(n - 3):
        p = pts[seg:seg + 4]
        r = radii[seg:seg + 4]
        ts = np.linspace(0.0, 1.0, subdiv, endpoint=False) \
            if seg < n - 4 else np.linspace(0.0, 1.0, subdiv + 1)
        for t in ts:
            b0 = (1 - t) ** 3 / 6.0
            b1 = (3 * t ** 3 - 6 * t ** 2 + 4) / 6.0
            b2 = (-3 * t ** 3 + 3 * t ** 2 + 3 * t + 1) / 6.0
            b3 = t ** 3 / 6.0
            out_p.append(b0 * p[0] + b1 * p[1] + b2 * p[2] + b3 * p[3])
            out_r.append(b0 * r[0] + b1 * r[1] + b2 * r[2] + b3 * r[3])
    return np.asarray(out_p, np.float32), np.asarray(out_r, np.float32)


def tube_mesh(pts, radii, n_sides: int = 8):
    """Tessellate a polyline with per-point radii into an open tube.

    Returns (MeshData, tangents (V,3)).  Frames are parallel-transported
    along the polyline so the tube does not twist; uv = (arc-position,
    circumferential angle / 2pi).
    """
    pts = np.asarray(pts, np.float64)
    radii = np.asarray(radii, np.float64)
    n = len(pts)
    # per-point tangents (central differences)
    tg = np.empty_like(pts)
    tg[0] = pts[1] - pts[0]
    tg[-1] = pts[-1] - pts[-2]
    tg[1:-1] = pts[2:] - pts[:-2]
    tg /= np.maximum(np.linalg.norm(tg, axis=1, keepdims=True), 1e-12)

    # parallel-transport an initial normal
    ref = np.array([0.0, 1.0, 0.0]) if abs(tg[0][1]) < 0.9 \
        else np.array([1.0, 0.0, 0.0])
    N = np.cross(tg[0], ref)
    N /= np.linalg.norm(N)
    normals = [N]
    for i in range(1, n):
        axis = np.cross(tg[i - 1], tg[i])
        s = np.linalg.norm(axis)
        c = float(np.clip(np.dot(tg[i - 1], tg[i]), -1.0, 1.0))
        if s < 1e-12:
            normals.append(normals[-1])
            continue
        axis = axis / s
        ang = np.arctan2(s, c)
        v = normals[-1]
        # Rodrigues rotation
        v = v * np.cos(ang) + np.cross(axis, v) * np.sin(ang) \
            + axis * np.dot(axis, v) * (1.0 - np.cos(ang))
        v -= tg[i] * np.dot(v, tg[i])
        v /= np.maximum(np.linalg.norm(v), 1e-12)
        normals.append(v)
    normals = np.asarray(normals)
    binorm = np.cross(tg, normals)

    arc = np.concatenate([[0.0], np.cumsum(
        np.linalg.norm(np.diff(pts, axis=0), axis=1))])
    arc /= max(arc[-1], 1e-12)

    theta = np.arange(n_sides) * (2.0 * np.pi / n_sides)
    ct, st = np.cos(theta), np.sin(theta)
    # rings: (n, n_sides, 3)
    radial = (normals[:, None, :] * ct[None, :, None]
              + binorm[:, None, :] * st[None, :, None])
    verts = pts[:, None, :] + radial * radii[:, None, None]
    vn = radial
    vt = np.broadcast_to(tg[:, None, :], verts.shape)
    uv = np.stack(np.broadcast_arrays(arc[:, None], theta[None, :]
                                      / (2.0 * np.pi)), -1)

    V = verts.reshape(-1, 3)
    VN = vn.reshape(-1, 3)
    VT = vt.reshape(-1, 3).copy()
    UV = uv.reshape(-1, 2)

    faces = []
    for i in range(n - 1):
        for j in range(n_sides):
            a = i * n_sides + j
            b = i * n_sides + (j + 1) % n_sides
            c = (i + 1) * n_sides + j
            d = (i + 1) * n_sides + (j + 1) % n_sides
            faces.append((a, c, b))
            faces.append((b, c, d))
    F = np.asarray(faces, np.int32)
    return MeshData(V, F, VN, UV), VT.astype(np.float32)


def curve_mesh(d: dict, base_dir: str, to_world, default_subdiv: int = 4,
               n_sides: int = 8):
    """Build the tessellated world-space mesh for a (b-spline|linear)curve
    plugin dict.  Control points are transformed BEFORE tessellation so
    radial normals/tangents need no further transform."""
    import os
    if "filename" in d:
        path = d["filename"] if os.path.isabs(d["filename"]) \
            else os.path.join(base_dir, d["filename"])
        curves = load_curve_file(path)
    else:
        pts = np.asarray(d["points"], np.float32)
        r = d.get("radius", 0.1)
        rad = np.full(len(pts), float(r), np.float32) \
            if np.isscalar(r) else np.asarray(r, np.float32)
        curves = [(pts, rad)]

    scale = float(np.cbrt(abs(np.linalg.det(
        to_world.apply_vectors(np.eye(3))))))
    meshes, tangents = [], []
    for pts, rad in curves:
        pts = to_world.apply_points(pts).astype(np.float32)
        rad = rad * scale
        if d["type"] == "bsplinecurve":
            pts, rad = bspline_to_polyline(pts, rad,
                                           int(d.get("subdiv",
                                                     default_subdiv)))
        mesh, tg = tube_mesh(pts, rad, n_sides=int(d.get("sides", n_sides)))
        meshes.append(mesh)
        tangents.append(tg)

    # concatenate all curves of the file into one shape
    off = 0
    V, F, N, U, T = [], [], [], [], []
    for mesh, tg in zip(meshes, tangents):
        V.append(mesh.vertices)
        F.append(mesh.faces + off)
        N.append(mesh.normals)
        U.append(mesh.uvs)
        T.append(tg)
        off += len(mesh.vertices)
    out = MeshData(np.concatenate(V), np.concatenate(F),
                   np.concatenate(N), np.concatenate(U))
    return out, np.concatenate(T)
