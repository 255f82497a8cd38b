"""Counter-based per-lane RNG + the independent sampler (counterpart of
liverrenderer_tpu/core/rng.py).

The JAX package hashes uint32 lanes with pcg4d.  PyTorch has no full
uint32 arithmetic, so every value here is a uint32 held in an int64 tensor
and masked with `& 0xFFFFFFFF` after each multiply, add and shift.  A
product of two uint32 values can pass 2^63 and wrap in int64, but the low
32 bits of a two's-complement wrap are the uint32 product's, so the mask
restores it.  The streams are bit-exact with the JAX package: every
per-pixel comparison between the two packages rests on that.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..errors import not_ported

M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _pcg4d(v: torch.Tensor) -> torch.Tensor:
    """pcg4d hash: (..., 4) uint32-in-int64 -> (..., 4)."""
    v = (v * 1664525 + 1013904223) & M32
    x, y, z, w = v.unbind(-1)
    x = (x + ((y * w) & M32)) & M32
    y = (y + ((z * x) & M32)) & M32
    z = (z + ((x * y) & M32)) & M32
    w = (w + ((y * z) & M32)) & M32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = (x + ((y * w) & M32)) & M32
    y = (y + ((z * x) & M32)) & M32
    z = (z + ((x * y) & M32)) & M32
    w = (w + ((y * z) & M32)) & M32
    return torch.stack([x, y, z, w], -1)


def _to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 in [0, 1) from the top 24 bits (exact in fp32)."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _hash4(a, b, c, d) -> torch.Tensor:
    return _pcg4d(torch.stack(torch.broadcast_tensors(a, b, c, d), -1))


@dataclass
class Sampler:
    """Per-lane sampler state: (seed, dim counter, sample index, pixel id).
    Every next_1d/next_2d advances `dim`, so a pass that repeats the draws
    in the same order replays the same numbers."""
    seed: torch.Tensor   # (N,) hash of (pixel, sample, global seed)
    dim: torch.Tensor    # (N,)
    samp: torch.Tensor   # (N,) sample index within the pixel
    pix: torch.Tensor    # (N,) pixel / lane id

    def _bump(self, k: int) -> "Sampler":
        return dataclasses.replace(self, dim=(self.dim + k) & M32)

    def next_1d(self):
        h = _hash4(self.seed, self.dim, torch.zeros_like(self.seed),
                   torch.full_like(self.seed, _GOLDEN))
        return _to_unit_float(h[..., 0]), self._bump(1)

    def next_2d(self):
        h = _hash4(self.seed, self.dim, torch.ones_like(self.seed),
                   torch.full_like(self.seed, _GOLDEN))
        u = torch.stack([_to_unit_float(h[..., 0]),
                         _to_unit_float(h[..., 1])], -1)
        return u, self._bump(2)

    def next_nd(self, k: int):
        """k uniforms per lane in ceil(k/4) hashes -> ((N, k), sampler)."""
        cols = []
        for j in range((k + 3) // 4):
            h = _hash4(self.seed, (self.dim + j) & M32,
                       torch.full_like(self.seed, 2),
                       torch.full_like(self.seed, _GOLDEN))
            cols += [_to_unit_float(h[..., c]) for c in range(4)]
        return torch.stack(cols[:k], -1), self._bump(k)


def make_sampler(lane_id, sample_idx, seed=0,
                 kind: str = "independent") -> Sampler:
    """Seed a wavefront sampler: lane_id (N,) int tensor; sample_idx and
    seed ints or (N,) int tensors.  Every (pixel, sample, seed) triple gets
    its own stream.  Only the independent kind is ported."""
    if kind != "independent":
        raise not_ported(f"the {kind!r} sampler", "Queue 1 M2")
    lane = torch.as_tensor(lane_id).to(torch.int64) & M32
    samp = torch.broadcast_to(
        torch.as_tensor(sample_idx, device=lane.device).to(torch.int64),
        lane.shape) & M32
    base = torch.broadcast_to(
        torch.as_tensor(seed, device=lane.device).to(torch.int64),
        lane.shape) & M32
    h = _hash4(lane, samp, base, torch.full_like(lane, 0x85EBCA6B))
    return Sampler(seed=h[..., 0], dim=torch.zeros_like(lane), samp=samp,
                   pix=lane)


def hash_u32(*parts) -> torch.Tensor:
    """uint32 hash of up to 4 integer tensors (broadcast)."""
    arrs = [torch.as_tensor(p).to(torch.int64) & M32 for p in parts]
    arrs = list(torch.broadcast_tensors(*arrs))
    while len(arrs) < 4:
        arrs.append(torch.full_like(arrs[0], 0x27D4EB2F))
    return _pcg4d(torch.stack(arrs[:4], -1))[..., 0]
