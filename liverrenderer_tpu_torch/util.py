"""Scene parameter traversal for inverse rendering (counterpart of
liverrenderer_tpu/util.py).

The Scene is a tree of dataclasses of tensors, so "traversal" selects
differentiable leaves by key and `apply_params` substitutes them with
`dataclasses.replace`, copying no buffer: a leaf that requires grad stays
the same tensor inside the new Scene, so autograd follows it through a
render.  `SceneParameters` gives the reference's dict-of-parameters UX
(keys, getitem, update) on top of it.

Keys: media.params, bsdfs.params, emitters.params (the constant
environment's radiance, the envmap's scale, an area light's radiance, a
point light's position and intensity), textures.data (the texture rows: a
constant's rgb, a checkerboard's colours, uv transforms) and
textures.bitmaps (the bitmap stack; its bilinear taps read it only when
the scene packs no quads, so with quads its gradient is zero, as in the
JAX package), media.grids (the heterogeneous media's density grids),
vertices (`refresh_vertex_geometry`), and volprims.opacity and
volprims.sh (the radiance field's splats).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .accel.cuda_intersect import TILE_T
from .core.math import sqrt
from .scene.ir import Scene

Tensor = torch.Tensor


def _smooth_normals(verts: Tensor, F: Tensor) -> Tensor:
    """Area-weighted vertex normals; zero where no face contributes (the
    squared norm is clamped, so the gradient stays finite there)."""
    p0, p1, p2 = verts[F[:, 0]], verts[F[:, 1]], verts[F[:, 2]]
    fn = torch.linalg.cross(p1 - p0, p2 - p0)
    acc = torch.zeros_like(verts)
    for k in range(3):
        acc = acc.index_add(0, F[:, k], fn)
    ln2 = torch.sum(acc * acc, -1, keepdim=True)
    return torch.where(ln2 > 1e-24,
                       acc / sqrt(torch.clamp(ln2, min=1e-24)), 0.0)


def bw_rows(v0: Tensor, v1: Tensor, v2: Tensor):
    """Baldwin-Weber rows (n, dn, r1, d1, r2, d2) in float32, in the
    operation order of the JAX package's bw_rows(..., xp=jnp): the
    refresh's re-pack equals the JAX package's bit for bit (the build's
    accel/cuda_intersect.bw_rows works in float64 numpy)."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = torch.linalg.cross(e1, e2)
    nn = torch.sum(n * n, -1)
    # degenerate or overflowing |n|^2: zero n too, so |n.d| > 1e-12 rejects
    ok = (nn > 0) & torch.isfinite(nn)
    n = torch.where(ok[:, None], n, 0.0)
    dn = torch.sum(n * v0, -1)
    inv_nn = torch.where(ok, 1.0 / torch.where(ok, nn, 1.0), 0.0)
    r1 = torch.linalg.cross(e2, n) * inv_nn[:, None]
    d1 = -torch.sum(r1 * v0, -1)
    r2 = torch.linalg.cross(n, e1) * inv_nn[:, None]
    d2 = -torch.sum(r2 * v0, -1)
    return n, dn, r1, d1, r2, d2


def _repack(scene: Scene, Vd: Tensor):
    """(tri_buf, tri_boxes, tri_center) of the moved vertices Vd: the
    kernel's buffers re-packed in the stored BVH-leaf order, in a fresh
    local frame (the AABB midpoint of all moved vertices), columns 13:16
    of tri_buf and 6:8 of tri_boxes kept."""
    F = scene.faces
    kperm = scene.tri_kperm
    valid = kperm >= 0
    fo = F[torch.clamp(kperm, min=0)]
    c = 0.5 * (torch.amin(Vd, 0) + torch.amax(Vd, 0))[None]
    b0, b1, b2 = Vd[fo[:, 0]] - c, Vd[fo[:, 1]] - c, Vd[fo[:, 2]] - c
    vm = valid[:, None]
    n_r, dn, r1, d1, r2, d2 = bw_rows(b0, b1, b2)
    tri_buf = torch.cat([
        torch.where(vm, n_r, 0.0), torch.where(valid, dn, 0.0)[:, None],
        torch.where(vm, r1, 0.0), torch.where(valid, d1, 0.0)[:, None],
        torch.where(vm, r2, 0.0), torch.where(valid, d2, 0.0)[:, None],
        torch.where(valid, kperm.to(torch.float32), 0.0)[:, None],
        scene.tri_buf[:, 13:16]], -1)
    n_chunks = tri_buf.shape[0] // TILE_T
    pts = torch.stack([b0, b1, b2], 1)            # (Tpad, 3 points, 3)
    lo = torch.where(vm[:, None], pts, float("inf")).reshape(
        n_chunks, TILE_T * 3, 3).amin(1)
    hi = torch.where(vm[:, None], pts, float("-inf")).reshape(
        n_chunks, TILE_T * 3, 3).amax(1)
    tri_boxes = torch.cat([lo, hi, scene.tri_boxes[:, 6:8]], -1)
    return tri_buf, tri_boxes, c[0]


# the last re-pack and a copy of the vertices it was made from: the replay
# walk applies the same vertices on every bounce.  The pack is reused only
# when the vertices are equal by value (a tensor written in place, or one
# sharing a numpy array's memory, keeps its data pointer and version).
_LAST_PACK: list = []


def _repack_once(scene: Scene, Vd: Tensor):
    if _LAST_PACK:
        V0, buf0, kp0, out = _LAST_PACK
        if (kp0 is scene.tri_kperm and buf0 is scene.tri_buf
                and V0.shape == Vd.shape and V0.device == Vd.device
                and torch.equal(V0, Vd)):
            return out
    out = _repack(scene, Vd)
    _LAST_PACK[:] = [Vd.clone(), scene.tri_buf, scene.tri_kperm, out]
    return out


def refresh_vertex_geometry(scene: Scene, V: Tensor) -> Scene:
    """The vertices V moved into every buffer derived from them (the
    reference's Mesh::parameters_changed): smooth normals where the stored
    normal was the smooth normal of the original geometry, the tri_si rows
    rebuilt from V with its gradient (compute_si carries the interior
    derivative), and the kernel's buffers re-packed detached (finding a
    hit is not differentiated).  tri_area_cdf, shape_area and the BVH are
    not refreshed, as in the JAX package."""
    if scene.n_tris == 0:
        return scene.replace(vertices=V)
    F = scene.faces
    old_smooth = _smooth_normals(scene.vertices.detach(), F)
    was_smooth = torch.sum(old_smooth * scene.normals, -1,
                           keepdim=True) > 0.999
    normals = torch.where(was_smooth, _smooth_normals(V, F), scene.normals)
    v0, v1, v2 = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    tri_si = torch.cat([v0, v1 - v0, v2 - v0, normals[F[:, 0]],
                        normals[F[:, 1]], normals[F[:, 2]],
                        scene.tri_si[:, 18:]], -1)
    tri_buf, tri_boxes, center = _repack_once(scene, V.detach())
    return scene.replace(vertices=V, normals=normals, tri_si=tri_si,
                         tri_buf=tri_buf, tri_boxes=tri_boxes,
                         tri_center=center)

# leaf key -> (getter, setter)
_LEAVES: Dict[str, tuple] = {
    "bsdfs.params": (lambda s: s.bsdfs.params,
                     lambda s, v: s.replace(bsdfs=s.bsdfs.replace(params=v))),
    "emitters.params": (lambda s: s.emitters.params,
                        lambda s, v: s.replace(
                            emitters=s.emitters.replace(params=v))),
    "media.params": (lambda s: s.media.params,
                     lambda s, v: s.replace(media=s.media.replace(params=v))),
    "textures.data": (lambda s: s.textures.data,
                      lambda s, v: s.replace(
                          textures=s.textures.replace(data=v))),
    "textures.bitmaps": (lambda s: s.textures.bitmaps,
                         lambda s, v: s.replace(
                             textures=s.textures.replace(bitmaps=v))),
    "media.grids": (lambda s: s.media.grids,
                    lambda s, v: s.replace(media=s.media.replace(grids=v))),
    "vertices": (lambda s: s.vertices, refresh_vertex_geometry),
    "volprims.opacity": (lambda s: s.volprims.opacity,
                         lambda s, v: s.replace(
                             volprims=s.volprims.replace(opacity=v))),
    "volprims.sh": (lambda s: s.volprims.sh,
                    lambda s, v: s.replace(
                        volprims=s.volprims.replace(sh=v))),
}


def _leaf(key: str) -> tuple:
    if key in _LEAVES:
        return _LEAVES[key]
    raise KeyError(f"unknown scene parameter {key!r}")


def _as_leaf(scene: Scene, v) -> torch.Tensor:
    """float32 on the scene's device; a tensor already so is returned as
    it is (no copy, its autograd history kept)."""
    return torch.as_tensor(v, dtype=torch.float32, device=scene.device)


def apply_params(scene: Scene, params: Dict[str, Any]) -> Scene:
    """Functional parameter substitution: new Scene with leaves replaced."""
    for k, v in params.items():
        scene = _leaf(k)[1](scene, _as_leaf(scene, v))
    return scene


class SceneParameters:
    """Mutable dict-like view over a Scene's differentiable leaves
    (mi.SceneParameters analog).  Call .scene() to materialize."""

    def __init__(self, scene: Scene, keys=None):
        self._scene = scene
        self._data = {k: _leaf(k)[0](scene)
                      for k in (keys or _LEAVES.keys())}

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def __getitem__(self, k):
        return self._data[k]

    def __setitem__(self, k, v):
        _leaf(k)
        self._data[k] = _as_leaf(self._scene, v)

    def __contains__(self, k):
        return k in self._data

    def update(self, other: Dict[str, Any] | None = None):
        """Apply pending values (reference params.update() semantics)."""
        if other:
            for k, v in other.items():
                self[k] = v
        self._scene = apply_params(self._scene, self._data)
        return self._scene

    def scene(self) -> Scene:
        return apply_params(self._scene, self._data)

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return dict(self._data)


def traverse(scene: Scene, keys=None) -> SceneParameters:
    return SceneParameters(scene, keys)
