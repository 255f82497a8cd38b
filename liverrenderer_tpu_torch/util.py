"""Scene parameter traversal for inverse rendering (counterpart of
liverrenderer_tpu/util.py).

The Scene is a tree of dataclasses of tensors, so "traversal" selects
differentiable leaves by key and `apply_params` substitutes them with
`dataclasses.replace`, copying no buffer: a leaf that requires grad stays
the same tensor inside the new Scene, so autograd follows it through a
render.  `SceneParameters` gives the reference's dict-of-parameters UX
(keys, getitem, update) on top of it.

Keys the port carries: media.params, bsdfs.params, emitters.params (the
constant environment's radiance, the envmap's scale, an area light's
radiance, a point light's position and intensity), textures.data (the
texture rows: a constant's rgb, a checkerboard's colours, uv transforms)
and textures.bitmaps (the bitmap stack; its bilinear taps read it only
when the scene packs no quads, so with quads its gradient is zero, as in
the JAX package), media.grids (the heterogeneous media's density
grids), and volprims.opacity and volprims.sh (the radiance field's
splats).  The JAX package's other key, vertices, raises `not_ported`
naming its ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .errors import not_ported
from .scene.ir import Scene

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
    "volprims.opacity": (lambda s: s.volprims.opacity,
                         lambda s, v: s.replace(
                             volprims=s.volprims.replace(opacity=v))),
    "volprims.sh": (lambda s: s.volprims.sh,
                    lambda s, v: s.replace(
                        volprims=s.volprims.replace(sh=v))),
}

# the JAX package's keys whose modules the port does not carry yet
_NOT_PORTED = {
    "vertices": ("vertex gradients (projective boundary terms)",
                 "Queue 1 M10"),
}


def _leaf(key: str) -> tuple:
    if key in _LEAVES:
        return _LEAVES[key]
    if key in _NOT_PORTED:
        raise not_ported(*_NOT_PORTED[key])
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
