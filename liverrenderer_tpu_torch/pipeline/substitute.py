"""Substitute geometry for stripped reference assets (counterpart of
liverrenderer_tpu/pipeline/substitute.py).

The learned-SSS golden scene (scenes/SphereLiverPoint/sss/scene.xml, the
reference vaescatter.cpp's demo) references `soap_fine.obj`, which the
reference checkout lacks.  A rounded-box stand-in, fitted to the golden's
object silhouette (mask IoU ~0.89; soap_substitute.json, the port's copy
of the JAX package's fit), takes its place at evaluation time, so
full-frame metrics against that golden are silhouette-limited; the
evaluation also reports background-only metrics and the object region's
mean radiance.  numpy, as in the JAX package.
"""
from __future__ import annotations

import json
import os

import numpy as np

_HERE = os.path.dirname(__file__)
SOAP_JSON = os.path.join(_HERE, "soap_substitute.json")


def rounded_box_mesh(subdiv: int = 3, round_r: float = 0.18):
    """Unit rounded box (half-extent 1, corner radius round_r) by mapping
    icosphere directions onto the SDF zero set (bisection)."""
    from ..scene import geometry as geo
    base = geo.icosphere(subdiv)
    dirs = np.asarray(base.vertices, np.float64)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    h = 1.0 - round_r

    def sdf(p):
        q = np.abs(p) - h
        outer = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
        inner = np.minimum(q.max(-1), 0.0)
        return outer + inner - round_r

    lo = np.zeros(len(dirs))
    hi = np.full(len(dirs), 2.0)
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        m = sdf(mid[:, None] * dirs) < 0
        lo = np.where(m, mid, lo)
        hi = np.where(m, hi, mid)
    v = (0.5 * (lo + hi))[:, None] * dirs
    return v.astype(np.float32), np.asarray(base.faces, np.int32)


def _euler(rx, ry, rz):
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def transformed(v, p):
    """Apply the 9-vector fit (scale3, euler3, translate3) to vertices."""
    sx, sy, sz, rx, ry, rz, tx, ty, tz = p
    R = _euler(rx, ry, rz)
    return (v * np.array([sx, sy, sz], np.float32)) \
        @ R.T.astype(np.float32) + np.array([tx, ty, tz], np.float32)


def soap_mesh():
    """(vertices, faces, fit_metadata) of the fitted soap substitute."""
    with open(SOAP_JSON) as f:
        fit = json.load(f)
    v, faces = rounded_box_mesh(fit.get("subdiv", 3),
                                fit.get("round_r", 0.18))
    return transformed(v, fit["params"]), faces, fit
