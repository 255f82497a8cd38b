"""Shading-frame post-processing: bump and normal mapping (counterpart of
liverrenderer_tpu/integrators/shading.py).

The perturbation texture is stored per shape (scene/builder.py folds the
bumpmap and normalmap wrappers into the shape table), so the frame is
perturbed once per interaction, before any BSDF dispatch.  The height
gradient is the analytic derivative of one bilinear tap
(texture/eval.py eval_texture_grad_mono), as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import math as m
from ..core.types import SurfaceInteraction
from ..scene.ir import Scene
from ..texture.eval import eval_texture, eval_texture_grad_mono


def shading_frame_with_bump(scene: Scene, si: SurfaceInteraction, ray):
    """si with its shading frame perturbed by the shape's bump or normal
    map (if any), and wi re-expressed in the new frame."""
    if not scene.has_bump:
        return si
    shape = torch.clamp(si.shape, min=0)
    btex = m.table_lookup(scene.shape_bump_tex, shape)
    bscale = m.table_lookup(scene.shape_bump_scale, shape)
    has_bump = (btex >= 0) & si.valid & (bscale > 0)
    has_nmap = (btex >= 0) & si.valid & (bscale < 0)

    frame = si.sh_frame
    n = frame.n
    new_n = n
    if scene.has_heightmap:
        _, dhdu, dhdv = eval_texture_grad_mono(scene.textures, btex, si.uv)
        dhdu = dhdu * torch.abs(bscale)
        dhdv = dhdv * torch.abs(bscale)
        n_bump = m.normalize(n - dhdu[:, None] * frame.s
                             - dhdv[:, None] * frame.t)
        new_n = torch.where(has_bump[:, None], n_bump, new_n)
    if scene.has_normalmap:
        rgb = eval_texture(scene.textures, btex, si.uv)
        tn = m.normalize(2.0 * rgb - 1.0)
        n_nmap = m.normalize(tn[:, 0:1] * frame.s + tn[:, 1:2] * frame.t
                             + tn[:, 2:3] * n)
        new_n = torch.where(has_nmap[:, None], n_nmap, new_n)

    wi_local = m.make_frame(new_n).to_local(-ray.d)
    use = (has_bump | has_nmap)[:, None]
    return dataclasses.replace(
        si, sh_frame=m.make_frame(torch.where(use, new_n, n)),
        wi=torch.where(use, wi_local, si.wi))
