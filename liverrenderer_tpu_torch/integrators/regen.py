"""Wavefront path regeneration: keep the lanes full (counterpart of
liverrenderer_tpu/integrators/regen.py) for the volpath family and the
surface family (`path`, `direct`).

A wavefront of W lanes bounces until every sample of the pool has been
walked: a lane whose path ends is splatted into the film inside the loop
and re-seeded with the next (pixel, sample) id.  The accumulator contract
is the JAX package's: the same sample ids, keyed the same way into the
counter RNG, splatted into the same (h, w, 4) film.

With `store_paths` the walk also writes every finished path's radiance
into a flat (budget, 3) pool indexed by sample id: the residual the PRB
replay adjoint (prb_replay.py) reads.  Each sample dies once, so the pool
is written by index_copy_ (a set, deterministic on the card) into a pool
with one spare row, which takes the writes of the lanes that did not die.
The JAX package's fused and packed pool layouts tune XLA scatters on a
TPU; one layout serves here.

Dropped on purpose: the JAX package's probe-timed schedule of
power-of-two spp chunks per device execution (`render_regen_host` without
a control, its `_RATE_CACHE`) exists only to keep single executions under
the TPU runtime watchdog.  Here the host loop drives every iteration; its
one host synchronisation per iteration is the `any(active)` test.  A
RenderControl still partitions the render, so that it can stop between
the parts.  CUDA graphs come later.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from .. import film as film_mod
from ..core import spectrum as spec
from ..core.rng import make_sampler
from ..emitter.dispatch import eval_environment
from ..scene.ir import FILTER_BOX, FILTER_TENT, Scene
from ..sensor.perspective import APERTURE_SENSORS, sample_ray
from . import path as path_mod
from . import volpath as vp

# lanes kept in flight
REGEN_WAVEFRONT = 1 << 16
# pixels per regen tile: larger films render tile by tile
TILE_PIX = 1 << 18

# integrators walked by the surface family's bounce (path.py); the rest of
# the regen-able set runs the volpath bounce
_SURFACE = ("path", "direct")


def _family(scene: Scene):
    """The module whose init_state / bounce walk this scene's lanes."""
    return path_mod if scene.integrator in _SURFACE else vp


def _lane_cap(scene: Scene) -> int:
    """Per-lane iteration budget: each family's fixed-wavefront loop cap,
    so both renderers compute the same per-sample estimate (null
    collisions do not advance a volpath lane's depth; a surface lane dies
    by its depth gate)."""
    return scene.max_depth * (1 if scene.integrator in _SURFACE else 4)


def pool_channels(scene: Scene) -> int:
    """Channel count of the stored-path pool: the spectral variant pools
    the wavelength packet (the replay adjoint's suffix weights live in
    packet space), RGB otherwise."""
    return spec.N_SPEC if scene.spectral else 3


def _finalize_L2(scene: Scene, st):
    """(film_rgb, pool_vec) at lane death: the volpath family's deferred
    environment term folded in (the surface family folds it into L inside
    its bounce).  A spectral lane gives the film the CIE estimate of its
    packet and the pool the packet itself; an RGB lane gives both its
    radiance."""
    L = st.L
    if hasattr(st, "env_weight"):
        env = eval_environment(scene, st.ray_d)
        if scene.spectral:
            env = spec.smits_upsample_illum(env, st.lam)
        L = L + st.env_weight * env
    if scene.spectral:
        return spec.spec_to_rgb_estimate(L, st.lam), L
    return L, L


def _finalize_L(scene: Scene, st):
    return _finalize_L2(scene, st)[0]


def _lane_sampler(scene: Scene, sample_ids, seed, spp: int, pix0: int,
                  tile_pix: int | None, samp0: int):
    """(film position, sampler after the camera jitter) of sample ids; the
    pattern samplers stratify the render's `spp` samples of a pixel."""
    w = scene.film_w
    n_pix = tile_pix if tile_pix is not None else w * scene.film_h
    pix = sample_ids % n_pix + pix0
    samp = sample_ids // n_pix + samp0
    sampler = make_sampler(pix, samp, seed, kind=scene.sampler_kind,
                           spp=spp)
    px = (pix % w).to(torch.float32)
    py = (pix // w).to(torch.float32)
    uf, sampler = sampler.next_2d()
    return torch.stack([px, py], -1) + uf, sampler


def _make_lanes(scene: Scene, sample_ids, seed, spp: int, pix0: int = 0,
                tile_pix: int | None = None, samp0: int = 0):
    """Seed path states for sample ids (pixel-minor order, so the first
    iterations cover the whole film).  The counter RNG keys on the global
    (pixel, sample) pair, so any partition of the budget walks the same
    paths."""
    pos, sampler = _lane_sampler(scene, sample_ids, seed, spp, pix0,
                                 tile_pix, samp0)
    return _family(scene).init_state(sample_ray(scene, pos), sampler,
                                     scene), pos


def lane_pos(scene: Scene, sample_ids, seed, spp: int, pix0: int = 0,
             tile_pix: int | None = None, samp0: int = 0):
    """Film position of each sample id without building its path state:
    the same draw as _make_lanes, so the replay adjoint can compute each
    sample's filter cotangent before its walk."""
    return _lane_sampler(scene, sample_ids, seed, spp, pix0, tile_pix,
                         samp0)[0]


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
    idx = py * w + px - pix0
    # a jittered position can round up into the next pixel, which may lie
    # in the next tile: that sample is dropped, as the JAX package's
    # scatter drops an out-of-bounds update
    ok = died & in_range & (idx >= 0) & (idx < tile_pix)
    data = torch.cat([L, ones], -1)
    film.index_add_(0, torch.where(ok, idx, 0),
                    torch.where(ok[:, None], data, 0.0))


def _render_regen_tile(scene: Scene, seed, spp: int, pix0: int,
                       tile_pix: int, samp0: int = 0,
                       store_paths: bool = False,
                       spp_chunk: int | None = None):
    """One regenerating wavefront over a pixel tile -> (tile_pix, 4).

    samp0/spp_chunk: walk only samples [samp0, samp0 + spp_chunk) of each
    pixel (the replay adjoint's spp-chunked schedule).  store_paths: also
    return the (tile_pix * spp_chunk, 3) pool of each finished path's
    radiance, indexed by sample id."""
    h = scene.film_h
    dev = scene.device
    budget = tile_pix * (spp if spp_chunk is None else spp_chunk)
    W = min(REGEN_WAVEFRONT, budget)
    sid = torch.arange(W, device=dev)
    st, pos = _make_lanes(scene, sid, seed, spp, pix0, tile_pix, samp0)
    film = torch.zeros((tile_pix, 4), device=dev)
    if store_paths:
        pool = torch.zeros((budget + 1, pool_channels(scene)), device=dev)
    refills = (budget + W - 1) // W
    lane_cap = _lane_cap(scene)
    max_iters = lane_cap * (refills + 2)     # runaway backstop only
    fam = _family(scene)
    age = torch.zeros((W,), dtype=torch.int64, device=dev)
    next_s = torch.tensor(W, dtype=torch.int64, device=dev)

    for _ in range(max_iters):
        if not bool(st.active.any()):        # the one host sync
            break
        was_active = st.active
        # the primal and the stored forward walk volpath's NEE shadow paths
        # unbounded (the third argument: bounded_nee, or the surface
        # bounce's ad)
        st = fam.bounce(scene, st, False)
        age = age + 1
        st = dataclasses.replace(st, active=st.active & (age < lane_cap))
        died = was_active & ~st.active

        L, Lpool = _finalize_L2(scene, st)
        L = torch.where(torch.isfinite(L), L, 0.0)
        # lanes of a padded last tile carry pixel ids past the film
        _splat_died(scene, film, pos, L, died, pos[:, 1] < h, pix0)
        if store_paths:
            # lanes still walking write the spare row `budget`
            pool.index_copy_(0, torch.where(died, sid, budget),
                             torch.where(torch.isfinite(Lpool), Lpool, 0.0))

        # regenerate from the pool
        ranks = torch.cumsum(died.to(torch.int64), 0) - 1
        new_ids = next_s + ranks
        take = died & (new_ids < budget)
        new_st, new_pos = _make_lanes(scene, torch.where(take, new_ids, 0),
                                      seed, spp, pix0, tile_pix, samp0)
        st = _select_state(take, new_st, st)
        pos = torch.where(take[:, None], new_pos, pos)
        sid = torch.where(take, new_ids, sid)
        age = torch.where(take, 0, age)
        next_s = torch.clamp(next_s + died.sum(), max=budget)
    if store_paths:
        return film, pool[:budget]
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


class RenderControl:
    """Cooperative cancel, wall-clock timeout and progress of a regen
    render (the JAX package's RenderControl; the reference's
    Integrator::cancel / should_stop / m_timeout), checked between the
    (pixel tile, spp chunk) parts of the render, so one part is the
    response time.  On a stop the partial film develops as it is: filter
    weights stay consistent, and the pixels not rendered yet have zero
    weight (black).

    timeout: seconds of wall clock (0: none), counted from the start of
    each render.  on_progress: an optional callable(fraction done).
    stopped: set when a render stopped early.  frame(): the developed
    partial image (h, w, 3) at any moment, None before the first part."""

    def __init__(self, timeout: float = 0.0, on_progress=None):
        self.timeout = timeout
        self.on_progress = on_progress
        self.stopped = False
        self._cancel = False
        self._t0 = time.monotonic()
        self._film = None         # the (tiles * tile_pix, 4) accumulator
        self._shape = None

    def cancel(self) -> None:
        self._cancel = True

    def _arm(self) -> None:
        """At the start of a render: restart the timeout clock and clear
        a previous render's stop, so that one control drives several
        renders in turn.  A cancel() sticks: cancelling between renders
        cancels the next one too."""
        self._t0 = time.monotonic()
        self.stopped = False

    def should_stop(self) -> bool:
        return self._cancel or (
            self.timeout > 0 and time.monotonic() - self._t0 > self.timeout)

    def frame(self):
        if self._film is None:
            return None
        h, w = self._shape
        return film_mod.develop(self._film[:h * w].view(h, w, 4))

    def _update(self, film, shape, frac) -> None:
        self._film, self._shape = film, shape
        if self.on_progress is not None:
            self.on_progress(frac)


def render_regen_host(scene: Scene, seed, spp: int,
                      control: RenderControl | None = None):
    """render_regen, or with a control the same (pixel, sample) set in
    parts: pixel tiles of TILE_PIX, each in power-of-two spp chunks of at
    most a quarter of the spp (the JAX package's cap with a control),
    with control.should_stop() checked before each part.  The JAX
    package sizes its chunks by a timed probe to keep each device
    execution under the TPU's watchdog; the card has no such limit, so
    the chunk is fixed."""
    if control is None:
        return render_regen(scene, seed, spp)
    control._arm()
    w, h = scene.film_w, scene.film_h
    n_pix = w * h
    tile_pix = min(TILE_PIX, n_pix)
    n_tiles = (n_pix + tile_pix - 1) // tile_pix
    chunk = max(1, spp // 4)
    chunk = 1 << (chunk.bit_length() - 1)
    film = torch.zeros((n_tiles * tile_pix, 4), device=scene.device)
    for t in range(n_tiles):
        s0 = 0
        while s0 < spp:
            if control.should_stop():
                control.stopped = True
                return film[:n_pix].view(h, w, 4)
            c = min(chunk, 1 << ((spp - s0).bit_length() - 1))
            film[t * tile_pix:(t + 1) * tile_pix] += _render_regen_tile(
                scene, seed, spp, t * tile_pix, tile_pix, samp0=s0,
                spp_chunk=c)
            s0 += c
            control._update(film, (h, w), (t * spp + s0) / (n_tiles * spp))
    return film[:n_pix].view(h, w, 4)


def regen_applicable(scene: Scene, mode: str) -> bool:
    # an RGB volpathmis scene runs its own module (integrators/
    # volpathmis.py), which the regen wavefront does not carry; a
    # spectral one runs the volpath bounce (integrators/common.py)
    names = ("volpath", "biovolpath", "biovolpath06") + _SURFACE \
        + (("volpathmis",) if scene.spectral else ())
    return (mode == "primal"
            and scene.integrator in names
            and scene.rfilter in (FILTER_BOX, FILTER_TENT)
            # the thinlens's and irradiancemeter's second 2-D sample is
            # not drawn by the lane set-up
            and scene.sensor.stype not in APERTURE_SENSORS)
