"""Emitter evaluation (counterpart of liverrenderer_tpu/emitter/dispatch.py)
for the slice's constant environment.  Emitter sampling belongs to the NEE
walk, which comes with the diffuse/point/area emitters (ROADMAP)."""
from __future__ import annotations

import torch

from ..errors import not_ported
from ..scene.ir import EMITTER_AREA, EMITTER_CONSTANT, EMITTER_ENVMAP, Scene


def eval_emitter_hit(scene: Scene, si, d):
    """Radiance of the emitter attached to the hit shape, seen from -d ->
    (radiance, emitter_idx).  Only area emitters attach to shapes."""
    em = scene.emitters
    n = si.t.shape[0]
    if em.count and EMITTER_AREA in em.types_present:
        raise not_ported("area emitters", "Queue 1 (emitters with NEE)")
    return si.p.new_zeros((n, 3)), \
        torch.full((n,), -1, dtype=torch.int64, device=si.p.device)


def eval_environment(scene: Scene, d):
    """Environment radiance for escaped rays."""
    em = scene.emitters
    n = d.shape[0]
    if em.env_index < 0:
        return d.new_zeros((n, 3))
    if EMITTER_ENVMAP in em.types_present:
        raise not_ported("the envmap emitter", "Queue 1 (bumpmap + envmap)")
    rad = torch.where(em.etype[em.env_index] == EMITTER_CONSTANT,
                      em.params[em.env_index, 0:3], 0.0)
    return torch.broadcast_to(rad, (n, 3))
