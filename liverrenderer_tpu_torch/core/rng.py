"""Counter-based per-lane RNG and the samplers (counterpart of
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


def _bit_reverse(v: torch.Tensor) -> torch.Tensor:
    """Reverse the 32 bits of each uint32 word."""
    v = ((v >> 16) | (v << 16)) & M32
    v = ((v & 0x00FF00FF) << 8) | ((v & 0xFF00FF00) >> 8)
    v = ((v & 0x0F0F0F0F) << 4) | ((v & 0xF0F0F0F0) >> 4)
    v = ((v & 0x33333333) << 2) | ((v & 0xCCCCCCCC) >> 2)
    return ((v & 0x55555555) << 1) | ((v & 0xAAAAAAAA) >> 1)


def _sobol2(i: torch.Tensor, scramble: torch.Tensor) -> torch.Tensor:
    """Second dimension of the scrambled (0,2)-sequence (ldsampler)."""
    v = 1 << 31
    r = scramble
    for bit in range(32):
        r = r ^ (((i >> bit) & 1) * v)
        v ^= v >> 1
    return r


def _pow2_mask(n: int) -> int:
    w = 1
    while w < n:
        w <<= 1
    return w - 1


def _kensler_permute(i: torch.Tensor, n: int, p: torch.Tensor,
                     rounds: int = 10) -> torch.Tensor:
    """Stateless keyed permutation of [0, n) (Kensler 2013, "Correlated
    Multi-Jittered Sampling", listing 5): a cycle walk of a keyed
    bijection of the next power-of-two domain, `rounds` masked steps, a
    modulo for the rare lane still outside.  Every multiply wraps mod
    2^32, so each is masked."""
    if n <= 1:
        return torch.zeros_like(i)
    w = _pow2_mask(n)

    def h(i):
        i = i ^ p
        i = (i * 0xE170893D) & M32
        i = i ^ (p >> 16)
        i = i ^ ((i & w) >> 4)
        i = i ^ (p >> 8)
        i = (i * 0x0929EB3F) & M32
        i = i ^ (p >> 23)
        i = i ^ ((i & w) >> 1)
        i = (i * (1 | (p >> 27))) & M32
        i = (i * 0x6935FA69) & M32
        i = i ^ ((i & w) >> 11)
        i = (i * 0x74DCCA25) & M32
        i = i ^ (p >> 2)
        i = (i * 0x9E501CC3) & M32
        i = i ^ ((i & w) >> 2)
        i = (i * 0xC860A3DF) & M32
        i = i & w
        return i ^ (i >> 5)

    cur = i
    out = torch.zeros_like(cur)
    ok = torch.zeros(cur.shape, dtype=torch.bool, device=cur.device)
    for _ in range(rounds):
        cur = h(cur)
        accept = ~ok & (cur < n)
        out = torch.where(accept, cur, out)
        ok = ok | accept
    out = torch.where(ok, out, cur % n)
    return ((out + p) & M32) % n


def _smallest_prime_ge(n: int) -> int:
    def is_prime(k):
        return k >= 2 and all(k % d for d in range(2, int(k ** 0.5) + 1))
    while not is_prime(n):
        n += 1
    return n


def _cmj_factor(spp: int):
    """m x n = spp with m as close to sqrt(spp) as divisibility allows."""
    m = max(1, int(round(spp ** 0.5)))
    while spp % m:
        m -= 1
    return m, spp // m


# sampler plugins: independent, then the pattern kinds, each keyed per
# pixel with the sample index separate
KINDS = ("independent", "stratified", "multijitter", "orthogonal",
         "ldsampler")


@dataclass
class Sampler:
    """Per-lane sampler state: (seed, dim counter, sample index, pixel id).
    Every next_1d/next_2d advances `dim`, so a pass that repeats the draws
    in the same order replays the same numbers.

    `kind` selects the pattern (the reference's independent, stratified,
    multijitter, orthogonal and ldsampler plugins), all counter-based:
      independent   the pcg4d stream
      stratified    per-dimension strata, decorrelated by cyclic shifts,
                    plus jitter
      multijitter   correlated multi-jittered 2-D patterns on an m x n
                    grid (Kensler 2013)
      orthogonal    Bose orthogonal arrays of strength 2 (2-D); 1-D draws
                    as multijitter
      ldsampler     the scrambled (0,2)-sequence: van der Corput and
                    Sobol' per dimension pair
    The pattern kinds stratify the `spp` samples of one pixel."""
    seed: torch.Tensor   # (N,) hash of (pixel, sample, global seed)
    dim: torch.Tensor    # (N,)
    samp: torch.Tensor   # (N,) sample index within the pixel
    pix: torch.Tensor    # (N,) pixel / lane id
    kind: str = "independent"
    spp: int = 1

    def _bump(self, k: int) -> "Sampler":
        return dataclasses.replace(self, dim=(self.dim + k) & M32)

    def _hash(self, z: int, dim=None) -> torch.Tensor:
        return _hash4(self.seed, self.dim if dim is None else dim,
                      torch.full_like(self.seed, z),
                      torch.full_like(self.seed, _GOLDEN))

    def _strat_1d(self, h, extra_rot):
        """(shifted stratum + jitter from h) / spp."""
        spp = max(self.spp, 1)
        stratum = ((self.samp + extra_rot % spp) & M32) % spp
        return (stratum.to(torch.float32) + _to_unit_float(h)) / spp

    def _jitter(self, key):
        return _hash4(key, self.samp, torch.full_like(key, 7),
                      torch.full_like(key, _GOLDEN))

    def _cmj_2d(self, h):
        """The spp samples of a pixel fall one per cell of the m x n grid
        and one per stratum in both 1-D projections."""
        spp = max(self.spp, 1)
        m_, n_ = _cmj_factor(spp)
        key = h[..., 3]
        s = _kensler_permute(self.samp, spp, (key * 0x51633E2D) & M32)
        sx = _kensler_permute(s % m_, m_, (key * 0x68BC21EB) & M32)
        sy = _kensler_permute(s // m_, n_, (key * 0x02E5BE93) & M32)
        hj = self._jitter(key)
        jx, jy = _to_unit_float(hj[..., 0]), _to_unit_float(hj[..., 1])
        sxf, syf = sx.to(torch.float32), sy.to(torch.float32)
        return (sxf + (syf + jx) / n_) / m_, (syf + (sxf + jy) / m_) / n_

    def _cmj_1d(self, h):
        spp = max(self.spp, 1)
        key = h[..., 3]
        s = _kensler_permute(self.samp, spp, (key * 0x51633E2D) & M32)
        return (s.to(torch.float32)
                + _to_unit_float(self._jitter(key)[..., 0])) / spp

    @staticmethod
    def _oa_coord(a_main, a_sub, p_: int, key, jit):
        """Major stratum: the permuted OA symbol; minor offset: the
        permuted companion symbol plus jitter."""
        pm = _kensler_permute(a_main, p_, (key * 0x68BC21EB) & M32)
        ps = _kensler_permute(a_sub, p_, (key * 0x02E5BE93) & M32)
        return (pm.to(torch.float32)
                + (ps.to(torch.float32) + jit) / p_) / p_

    def _oa_2d(self, h):
        """Bose orthogonal array of strength 2 on the p x p grid (p the
        smallest prime >= sqrt(spp)): sample i's row is (i % p, i // p)
        after a per-pixel shuffle, and dimension pair d reads columns 2d
        and 2d + 1, (a1 + j a2) % p."""
        spp = max(self.spp, 1)
        p_ = _smallest_prime_ge(max(2, int(spp ** 0.5 + 0.9999)))
        key = h[..., 3]
        # the row shuffle is keyed per pixel only, so sample k keeps its
        # row in every dimension
        pix_key = _hash4(self.seed, torch.full_like(self.seed, 3),
                         torch.zeros_like(self.seed),
                         torch.full_like(self.seed, _GOLDEN))[..., 0]
        i = _kensler_permute(self.samp, spp, (pix_key * 0x51633E2D) & M32)
        a1, a2 = i % p_, i // p_
        jx = ((self.dim * 2) & M32) % p_
        jy = ((self.dim * 2 + 1) & M32) % p_
        cx = (a1 + jx * a2) % p_
        cy = (a1 + jy * a2) % p_
        hj = self._jitter(key)
        x = self._oa_coord(cx, cy, p_, key ^ _GOLDEN,
                           _to_unit_float(hj[..., 0]))
        y = self._oa_coord(cy, cx, p_, key ^ 0x85EBCA6B,
                           _to_unit_float(hj[..., 1]))
        return x, y

    def next_1d(self):
        h = self._hash(0)
        if self.kind == "stratified":
            u = self._strat_1d(h[..., 0], h[..., 1])
        elif self.kind in ("multijitter", "orthogonal"):
            u = self._cmj_1d(h)
        elif self.kind == "ldsampler":
            u = _to_unit_float(_bit_reverse(self.samp) ^ h[..., 0])
        else:
            u = _to_unit_float(h[..., 0])
        return u, self._bump(1)

    def next_2d(self):
        h = self._hash(1)
        if self.kind == "stratified":
            x = self._strat_1d(h[..., 0], h[..., 2])
            y = self._strat_1d(h[..., 1], h[..., 3])
        elif self.kind == "multijitter":
            x, y = self._cmj_2d(h)
        elif self.kind == "orthogonal":
            x, y = self._oa_2d(h)
        elif self.kind == "ldsampler":
            x = _to_unit_float(_bit_reverse(self.samp) ^ h[..., 0])
            y = _to_unit_float(_sobol2(self.samp, h[..., 1]))
        else:
            x, y = _to_unit_float(h[..., 0]), _to_unit_float(h[..., 1])
        return torch.stack([x, y], -1), self._bump(2)

    def next_nd(self, k: int):
        """k uniforms per lane in ceil(k/4) hashes -> ((N, k), sampler),
        independent draws for every kind."""
        cols = []
        for j in range((k + 3) // 4):
            h = self._hash(2, (self.dim + j) & M32)
            cols += [_to_unit_float(h[..., c]) for c in range(4)]
        return torch.stack(cols[:k], -1), self._bump(k)


def make_sampler(lane_id, sample_idx, seed=0, kind: str = "independent",
                 spp: int = 1) -> Sampler:
    """Seed a wavefront sampler: lane_id (N,) int tensor; sample_idx and
    seed ints or (N,) int tensors.  Every (pixel, sample, seed) triple of
    the independent kind gets its own stream; the pattern kinds key the
    stream on (pixel, seed) and stratify the `spp` samples of a pixel."""
    if kind not in KINDS:
        raise ValueError(f"unknown sampler {kind!r}")
    lane = torch.as_tensor(lane_id).to(torch.int64) & M32
    samp = torch.broadcast_to(
        torch.as_tensor(sample_idx, device=lane.device).to(torch.int64),
        lane.shape) & M32
    base = torch.broadcast_to(
        torch.as_tensor(seed, device=lane.device).to(torch.int64),
        lane.shape) & M32
    h = _hash4(lane, samp if kind == "independent" else torch.zeros_like(
        lane), base, torch.full_like(lane, 0x85EBCA6B))
    return Sampler(seed=h[..., 0], dim=torch.zeros_like(lane), samp=samp,
                   pix=lane, kind=kind, spp=spp)


def hash_u32(*parts) -> torch.Tensor:
    """uint32 hash of up to 4 integer tensors (broadcast)."""
    arrs = [torch.as_tensor(p).to(torch.int64) & M32 for p in parts]
    arrs = list(torch.broadcast_tensors(*arrs))
    while len(arrs) < 4:
        arrs.append(torch.full_like(arrs[0], 0x27D4EB2F))
    return _pcg4d(torch.stack(arrs[:4], -1))[..., 0]
