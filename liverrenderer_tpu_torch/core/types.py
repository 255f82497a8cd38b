"""Core record types for the wavefront renderer (counterpart of
liverrenderer_tpu/core/types.py).

Plain dataclasses of lane-shaped tensors: every field has leading dimension
N (the wavefront size).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .ieee_sqrt import sqrt

Tensor = torch.Tensor

# Epsilon used when spawning rays off surfaces (reference math::RayEpsilon).
RAY_EPS = 1e-4
INF = float("inf")


@dataclass
class Ray:
    """A bundle of rays: origins/directions (N,3), extents (N,)."""
    o: Tensor
    d: Tensor
    maxt: Tensor

    def at(self, t: Tensor) -> Tensor:
        return self.o + self.d * t[..., None]


@dataclass
class Frame:
    """Orthonormal shading frame (s, t, n), each (N, 3)."""
    s: Tensor
    t: Tensor
    n: Tensor

    def to_local(self, v: Tensor) -> Tensor:
        return torch.stack([
            torch.sum(v * self.s, -1),
            torch.sum(v * self.t, -1),
            torch.sum(v * self.n, -1),
        ], -1)

    def to_world(self, v: Tensor) -> Tensor:
        return (v[..., 0:1] * self.s + v[..., 1:2] * self.t
                + v[..., 2:3] * self.n)


@dataclass
class SurfaceInteraction:
    t: Tensor           # (N,) hit distance; inf => no hit
    p: Tensor           # (N,3)
    ng: Tensor          # (N,3) geometric normal
    sh_frame: Frame
    uv: Tensor          # (N,2)
    wi: Tensor          # (N,3) incident dir in the local shading frame
    prim: Tensor        # (N,) triangle / sphere index
    shape: Tensor       # (N,) shape index, -1 when invalid
    # (N,3) interpolated vertex attribute (mesh_attribute textures), None
    # when the scene carries none
    attr: Optional[Tensor] = None

    @property
    def valid(self) -> Tensor:
        return torch.isfinite(self.t)

    def to_local(self, v):
        return self.sh_frame.to_local(v)

    def to_world(self, v):
        return self.sh_frame.to_world(v)

    def spawn_ray(self, d: Tensor) -> Ray:
        o = offset_p(self.p, self.ng, d)
        return Ray(o=o, d=d, maxt=torch.full_like(self.t, INF))

    def spawn_ray_to(self, p2: Tensor) -> Ray:
        """A ray toward p2 that stops just short of it (shadow rays)."""
        o = offset_p(self.p, self.ng, p2 - self.p)
        d = p2 - o
        dist = sqrt(torch.sum(d * d, -1))
        d = d / torch.clamp(dist, min=1e-20)[..., None]
        return Ray(o=o, d=d, maxt=dist * (1.0 - 1e-3))


def offset_p(p: Tensor, ng: Tensor, d: Tensor) -> Tensor:
    """Offset a spawn origin along the geometric normal to avoid self-hits."""
    mag = (1.0 + torch.amax(torch.abs(p), dim=-1)) * RAY_EPS
    sgn = torch.where(torch.sum(ng * d, -1) >= 0.0, 1.0, -1.0)
    return p + (sgn * mag)[..., None] * ng


@dataclass
class MediumInteraction:
    t: Tensor                    # (N,) sampled distance, inf => escaped
    p: Tensor                    # (N,3)
    sigma_s: Tensor              # (N,3)
    sigma_n: Tensor              # (N,3)
    sigma_t: Tensor              # (N,3)
    combined_extinction: Tensor  # (N,3) majorant
    transmittance: Tensor        # (N,3) bio media: one-hot channel mask / 0
    log_p: Tensor                # (N,) bio media: differentiable log-density
    #                              of the sampled free-flight event (0 else)

    @property
    def valid(self) -> Tensor:
        return torch.isfinite(self.t)


@dataclass
class BSDFSample:
    wo: Tensor            # (N,3) local frame
    pdf: Tensor           # (N,)
    eta: Tensor           # (N,)
    sampled_type: Tensor  # (N,) int64 BSDF flag bits of the sampled lobe
    weight: Tensor        # (N,3) f * cos / pdf


@dataclass
class DirectionSample:
    """Emitter direction sample (next-event estimation)."""
    p: Tensor        # (N,3) point on the emitter
    n: Tensor        # (N,3) emitter normal there
    d: Tensor        # (N,3) unit direction reference point -> emitter
    dist: Tensor     # (N,)
    pdf: Tensor      # (N,) solid-angle density (times the selection pdf)
    delta: Tensor    # (N,) bool: a Dirac emitter (point)
    emitter: Tensor  # (N,) emitter index
