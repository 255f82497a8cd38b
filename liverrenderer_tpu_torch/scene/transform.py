"""Host-side 4x4 affine transforms (numpy).

Analog of the reference ScalarTransform4f (include/mitsuba/core/transform.h):
scene construction happens host-side in numpy; transforms are baked into the
world-space SoA buffers before anything reaches the device.
"""
from __future__ import annotations

import numpy as np


class Transform:
    """Immutable 4x4 transform with chained constructors mirroring
    mi.ScalarTransform4f usage in scene dicts (util.py:567+ cornell_box)."""

    def __init__(self, m=None):
        self.m = np.eye(4, dtype=np.float64) if m is None else np.asarray(m, np.float64)

    # chained constructors -------------------------------------------------
    def translate(self, v):
        t = np.eye(4)
        t[:3, 3] = v
        return Transform(self.m @ t)

    def scale(self, v):
        v = np.atleast_1d(np.asarray(v, np.float64))
        if v.size == 1:
            v = np.repeat(v, 3)
        s = np.diag([v[0], v[1], v[2], 1.0])
        return Transform(self.m @ s)

    def rotate(self, axis, angle_deg):
        a = np.asarray(axis, np.float64)
        a = a / np.linalg.norm(a)
        th = np.deg2rad(angle_deg)
        c, s = np.cos(th), np.sin(th)
        x, y, z = a
        r = np.array([
            [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s, 0],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s, 0],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c), 0],
            [0, 0, 0, 1]])
        return Transform(self.m @ r)

    def look_at(self, origin, target, up):
        """Camera-to-world: +z forward, +x right-handed per Mitsuba convention
        (transform.h look_at: left-handed camera space, x=left cross)."""
        origin = np.asarray(origin, np.float64)
        target = np.asarray(target, np.float64)
        up = np.asarray(up, np.float64)
        dir_ = target - origin
        dir_ = dir_ / np.linalg.norm(dir_)
        left = np.cross(up / np.linalg.norm(up), dir_)
        left = left / np.linalg.norm(left)
        new_up = np.cross(dir_, left)
        m = np.eye(4)
        m[:3, 0] = left
        m[:3, 1] = new_up
        m[:3, 2] = dir_
        m[:3, 3] = origin
        return Transform(self.m @ m)

    def matmul(self, other: "Transform"):
        return Transform(self.m @ other.m)

    def __matmul__(self, other):
        return self.matmul(other)

    # application ----------------------------------------------------------
    def apply_points(self, p):
        p = np.asarray(p, np.float64)
        return (p @ self.m[:3, :3].T) + self.m[:3, 3]

    def apply_vectors(self, v):
        v = np.asarray(v, np.float64)
        return v @ self.m[:3, :3].T

    def apply_normals(self, n):
        n = np.asarray(n, np.float64)
        inv_t = np.linalg.inv(self.m[:3, :3]).T
        out = n @ inv_t.T
        ln = np.linalg.norm(out, axis=-1, keepdims=True)
        return out / np.maximum(ln, 1e-20)

    @property
    def matrix(self):
        return self.m


def from_any(x) -> Transform:
    """Accept Transform, 4x4 array-like, or dict-free passthrough."""
    if isinstance(x, Transform):
        return x
    return Transform(np.asarray(x, np.float64).reshape(4, 4))
