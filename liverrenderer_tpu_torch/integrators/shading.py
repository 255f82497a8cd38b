"""Shading-frame post-processing (counterpart of
liverrenderer_tpu/integrators/shading.py).  The slice renders meshes
without bump or normal maps, so the frame passes through unchanged."""
from __future__ import annotations

from ..core.types import SurfaceInteraction
from ..errors import not_ported
from ..scene.ir import Scene


def shading_frame_with_bump(scene: Scene, si: SurfaceInteraction, ray):
    if scene.has_bump:
        raise not_ported("bump and normal mapping",
                         "Queue 1 (bumpmap + envmap)")
    return si
