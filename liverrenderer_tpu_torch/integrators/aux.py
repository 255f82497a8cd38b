"""Auxiliary integrators: depth, aov, moment, direct (counterpart of
liverrenderer_tpu/integrators/aux.py; the reference's
src/integrators/{depth,aov,moment,direct}.cpp).

`depth` and `aov` read the first hit of one ray through each pixel centre;
`moment` keeps the second sample moment beside the mean (the variance
images of the reference's z-test goldens); `direct` is the path
integrator cut at one bounce (the same emitter-hit and NEE MIS pair).
"""
from __future__ import annotations

import torch

from .. import film as film_mod
from ..accel.intersect import ray_intersect
from ..bsdf.dispatch import bsdf_albedo
from ..core import math as m
from ..emitter.dispatch import eval_emitter_hit
from ..scene.ir import Scene
from ..sensor.perspective import sample_ray
from .shading import shading_frame_with_bump


def _primary_si(scene: Scene):
    """The first interaction of a ray through each pixel's centre."""
    w, h = scene.film_w, scene.film_h
    pix = torch.arange(w * h, device=scene.device)
    px = (pix % w).to(torch.float32) + 0.5
    py = (pix // w).to(torch.float32) + 0.5
    ray = sample_ray(scene, torch.stack([px, py], -1))
    si = ray_intersect(scene, ray)
    return shading_frame_with_bump(scene, si, ray), ray


@torch.no_grad()
def render_depth(scene: Scene, seed: int = 0):
    """Distance to the first hit, 0 on a miss -> (h, w).  seed: unused,
    as in the JAX package (one ray through each pixel centre)."""
    si, _ = _primary_si(scene)
    return torch.where(si.valid, si.t, 0.0).view(scene.film_h,
                                                  scene.film_w)


@torch.no_grad()
def render_aovs(scene: Scene, aovs=("depth", "position", "sh_normal",
                                    "geo_normal", "albedo"), seed: int = 0):
    """{name: (h, w) or (h, w, c)} of the named AOVs: depth (dd.y),
    position (p), sh_normal (nn), geo_normal (ng), uv, albedo, emission,
    prim_index, shape_index; 0 on a miss."""
    si, ray = _primary_si(scene)
    w, h = scene.film_w, scene.film_h
    valid = si.valid[:, None]
    out = {}
    for name in aovs:
        if name in ("depth", "dd.y"):
            out[name] = torch.where(si.valid, si.t, 0.0).view(h, w)
        elif name in ("position", "p"):
            out[name] = torch.where(valid, si.p, 0.0).view(h, w, 3)
        elif name in ("sh_normal", "nn"):
            out[name] = torch.where(valid, si.sh_frame.n, 0.0).view(h, w, 3)
        elif name in ("geo_normal", "ng"):
            out[name] = torch.where(valid, si.ng, 0.0).view(h, w, 3)
        elif name == "uv":
            out[name] = torch.where(valid, si.uv, 0.0).view(h, w, 2)
        elif name == "albedo":
            alb = bsdf_albedo(scene, si, m.table_lookup(
                scene.shape_bsdf, torch.clamp(si.shape, min=0)))
            out[name] = torch.where(valid, alb, 0.0).view(h, w, 3)
        elif name == "emission":
            em, eidx = eval_emitter_hit(scene, si, ray.d)
            out[name] = torch.where(((eidx >= 0) & si.valid)[:, None], em,
                                    0.0).view(h, w, 3)
        elif name == "prim_index":
            out[name] = si.prim.to(torch.float32).view(h, w)
        elif name == "shape_index":
            out[name] = si.shape.to(torch.float32).view(h, w)
        else:
            raise ValueError(f"unknown AOV {name}")
    return out


@torch.no_grad()
def render_moments(scene: Scene, spp: int | None = None, seed: int = 0):
    """(mean, second moment), each (h, w, 3), of the scene's integrator's
    radiance per pixel, from one pass of one sample per pixel for each of
    the spp samples."""
    from .common import render_pass
    spp = spp or scene.spp
    acc = torch.zeros((scene.film_h, scene.film_w, 4), device=scene.device)
    acc2 = torch.zeros_like(acc)
    for i in range(spp):
        a = render_pass(scene, seed, 1, i, "primal")
        wch = a[..., 3:4]
        acc += a
        acc2 += torch.cat([a[..., 0:3] * a[..., 0:3]
                           / torch.clamp(wch, min=1e-12), wch], -1)
    return film_mod.develop(acc), film_mod.develop(acc2)


def render_direct(scene: Scene, spp: int | None = None, seed: int = 0):
    """Direct illumination: the path integrator cut at one bounce."""
    from .common import render
    return render(scene.replace(integrator="path", max_depth=2), spp=spp,
                  seed=seed)
