"""Wavefront path regeneration: keep the lanes full (counterpart of
liverrenderer_tpu/integrators/regen.py) for the volpath family.

A wavefront of W lanes bounces until every sample of the pool has been
walked: a lane whose path ends is splatted into the film inside the loop
and re-seeded with the next (pixel, sample) id.  The accumulator contract
is the JAX package's: the same sample ids, keyed the same way into the
counter RNG, splatted into the same (h, w, 4) film.

Dropped on purpose: the JAX package's host schedule (probe-timed,
power-of-two spp chunks per device execution, `render_regen_host`) exists
only to keep single executions under the TPU runtime watchdog.  Here the
host loop drives every iteration; its one host synchronisation per
iteration is the `any(active)` test.  CUDA graphs come later.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.rng import make_sampler
from ..emitter.dispatch import eval_environment
from ..errors import not_ported
from ..scene.ir import (FILTER_BOX, FILTER_TENT, SENSOR_IRRADIANCEMETER,
                        SENSOR_THINLENS, Scene)
from ..sensor.perspective import sample_ray
from . import volpath as vp

# lanes kept in flight
REGEN_WAVEFRONT = 1 << 16
# pixels per regen tile: larger films render tile by tile
TILE_PIX = 1 << 18


def _lane_cap(scene: Scene) -> int:
    """Per-lane iteration budget: the fixed wavefront's loop cap, so both
    renderers compute the same per-sample estimate."""
    return scene.max_depth * 4


def _finalize_L(scene: Scene, st):
    """Radiance at lane death: the deferred environment term folded in."""
    return st.L + st.env_weight * eval_environment(scene, st.ray_d)


def _make_lanes(scene: Scene, sample_ids, seed, spp: int, pix0: int = 0,
                tile_pix: int | None = None, samp0: int = 0):
    """Seed path states for sample ids (pixel-minor order, so the first
    iterations cover the whole film).  The counter RNG keys on the global
    (pixel, sample) pair, so any partition of the budget walks the same
    paths."""
    w = scene.film_w
    n_pix = tile_pix if tile_pix is not None else w * scene.film_h
    pix = sample_ids % n_pix + pix0
    samp = sample_ids // n_pix + samp0
    sampler = make_sampler(pix, samp, seed, kind=scene.sampler_kind)
    px = (pix % w).to(torch.float32)
    py = (pix // w).to(torch.float32)
    uf, sampler = sampler.next_2d()
    pos = torch.stack([px, py], -1) + uf
    return vp.init_state(sample_ray(scene, pos), sampler, scene), pos


def _select_state(mask, new, old):
    """Lane-wise where over every tensor of a (nested) state dataclass."""
    kw = {}
    for f in dataclasses.fields(old):
        a, b = getattr(new, f.name), getattr(old, f.name)
        if isinstance(b, torch.Tensor):
            kw[f.name] = torch.where(
                mask.view(mask.shape + (1,) * (b.dim() - 1)), a, b)
        elif dataclasses.is_dataclass(b):
            kw[f.name] = _select_state(mask, a, b)
    return dataclasses.replace(old, **kw)


def _splat_died(scene: Scene, film, pos, L, died, in_range, pix0: int):
    """Splat finished lanes into the tile's (tile_pix, 4) film."""
    w, h = scene.film_w, scene.film_h
    tile_pix = film.shape[0]
    ones = torch.ones_like(L[:, :1])
    if scene.rfilter == FILTER_TENT:
        ix0 = torch.floor(pos[:, 0] - 0.5).to(torch.int64)
        iy0 = torch.floor(pos[:, 1] - 0.5).to(torch.int64)
        for dy in (0, 1):
            for dx in (0, 1):
                ix = ix0 + dx
                iy = iy0 + dy
                fw = torch.clamp(1.0 - torch.abs(pos[:, 0] - (ix + 0.5)),
                                 min=0.0) \
                    * torch.clamp(1.0 - torch.abs(pos[:, 1] - (iy + 0.5)),
                                  min=0.0)
                tap = iy * w + ix - pix0
                # taps off the film or outside this tile are dropped
                ok = died & in_range & (ix >= 0) & (ix < w) & (iy >= 0) \
                    & (iy < h) & (tap >= 0) & (tap < tile_pix)
                data = torch.cat([L * fw[:, None], fw[:, None]], -1)
                film.index_add_(0, torch.where(ok, tap, 0),
                                torch.where(ok[:, None], data, 0.0))
        return
    px = torch.clamp(pos[:, 0].to(torch.int64), 0, w - 1)
    py = torch.clamp(pos[:, 1].to(torch.int64), 0, h - 1)
    data = torch.cat([L, ones], -1)
    film.index_add_(0, py * w + px - pix0,
                    torch.where((died & in_range)[:, None], data, 0.0))


def _render_regen_tile(scene: Scene, seed, spp: int, pix0: int,
                       tile_pix: int, samp0: int = 0):
    """One regenerating wavefront over a pixel tile -> (tile_pix, 4)."""
    h = scene.film_h
    dev = scene.device
    budget = tile_pix * spp
    W = min(REGEN_WAVEFRONT, budget)
    st, pos = _make_lanes(scene, torch.arange(W, device=dev), seed, spp,
                          pix0, tile_pix, samp0)
    film = torch.zeros((tile_pix, 4), device=dev)
    refills = (budget + W - 1) // W
    lane_cap = _lane_cap(scene)
    max_iters = lane_cap * (refills + 2)     # runaway backstop only
    age = torch.zeros((W,), dtype=torch.int64, device=dev)
    next_s = torch.tensor(W, dtype=torch.int64, device=dev)

    for _ in range(max_iters):
        if not bool(st.active.any()):        # the one host sync
            break
        was_active = st.active
        st = vp.bounce(scene, st)
        age = age + 1
        st = dataclasses.replace(st, active=st.active & (age < lane_cap))
        died = was_active & ~st.active

        L = _finalize_L(scene, st)
        L = torch.where(torch.isfinite(L), L, 0.0)
        # lanes of a padded last tile carry pixel ids past the film
        _splat_died(scene, film, pos, L, died, pos[:, 1] < h, pix0)

        # regenerate from the pool
        ranks = torch.cumsum(died.to(torch.int64), 0) - 1
        new_ids = next_s + ranks
        take = died & (new_ids < budget)
        new_st, new_pos = _make_lanes(scene, torch.where(take, new_ids, 0),
                                      seed, spp, pix0, tile_pix, samp0)
        st = _select_state(take, new_st, st)
        pos = torch.where(take[:, None], new_pos, pos)
        age = torch.where(take, 0, age)
        next_s = torch.clamp(next_s + died.sum(), max=budget)
    return film


def render_regen(scene: Scene, seed, spp: int):
    """Full-frame render with lane regeneration -> (h, w, 4) accumulator."""
    w, h = scene.film_w, scene.film_h
    n_pix = w * h
    if n_pix <= TILE_PIX:
        return _render_regen_tile(scene, seed, spp, 0, n_pix).view(h, w, 4)
    tiles = [_render_regen_tile(scene, seed, spp, t0, TILE_PIX)
             for t0 in range(0, n_pix, TILE_PIX)]
    return torch.cat(tiles)[:n_pix].view(h, w, 4)


def render_regen_host(scene: Scene, seed, spp: int, control=None):
    """The JAX package's host-scheduled entry point; on a GPU the whole
    render is one host-driven loop, so this is render_regen."""
    if control is not None:
        raise not_ported("RenderControl (cancel / timeout / progress)",
                         "Queue 1 M12")
    return render_regen(scene, seed, spp)


def regen_applicable(scene: Scene, mode: str) -> bool:
    return (mode == "primal"
            and scene.integrator in ("volpath", "biovolpath", "biovolpath06")
            and scene.rfilter in (FILTER_BOX, FILTER_TENT)
            and scene.sensor.stype not in (SENSOR_THINLENS,
                                           SENSOR_IRRADIANCEMETER))
