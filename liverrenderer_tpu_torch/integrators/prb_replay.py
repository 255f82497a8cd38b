"""PRB replay adjoint: gradients at about the cost of two walks
(counterpart of liverrenderer_tpu/integrators/prb_replay.py).

The reference's radiative-backprop two-pass replay, on the regenerating
wavefront:

  forward  - the stock regen render (integrators/regen.py), which also
             stores every finished path's radiance `L_total` into a pool
             indexed by sample id (the counter RNG makes the walk exactly
             replayable, core/rng.py).
  backward - one more regen walk with the same seed.  Each bounce is
             recomputed from a detached lane state with fresh parameter
             leaves, so `torch.autograd.grad` of that one bounce captures
             exactly its local parameter dependence; the chain-rule factor
             for everything downstream of the bounce enters analytically
             as the cotangent of the outgoing throughput:

                 suffix_{k+1} = (L_total - L_{k+1} - env_w_{k+1} * E)
                                / throughput_{k+1}

             (d/dtheta of the rest of the path = suffix * d(throughput)/
             dtheta, because sampling densities are detached).  Cotangents:
                 L_out          <- delta (the path's filter-weighted dL/dI)
                 throughput_out <- delta * suffix
                 env_weight_out <- delta * E(ray_d)   (E detached)

The surface family (path, direct) folds the environment into L inside its
bounce, so its walk has no env_weight: the cotangents are those of L and
the throughput only, and an environment parameter's gradient arrives
through the L cotangent.

Spectral scenes walk in packet space: the pool holds each path's
wavelength-packet radiance, the environment radiance E is lifted to the
lane's packet, and the path's RGB loss cotangent becomes a packet
cotangent once per lane life through the weights of the (linear) CIE
estimate at lane death (`_to_packet_ct`).

Schedules: one stored forward + one walk (`_RenderAcc`, a
torch.autograd.Function) when the film fits one regen tile and its sample
budget fits the path pool; otherwise the tiled schedule, in which every
(pixel tile, spp chunk) pair is walked on its own, the counter RNG
guaranteeing that every partition walks the same paths.  Per-path filter
cotangents (box: one tap; tent: the 2x2 splat neighbourhood) are computed
into an auxiliary pool before the walk.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .. import film as film_mod
from ..core import spectrum as spec
from ..emitter.dispatch import eval_environment
from ..scene.ir import FILTER_TENT, Scene
from ..util import _as_leaf, apply_params
from . import regen as regen_mod
from .regen import (_make_lanes, _render_regen_tile, _select_state,
                    lane_pos, pool_channels, regen_applicable)

Tensor = torch.Tensor

# per-walk path-pool cap (paths): larger budgets run the tiled schedule
MAX_STORE_PATHS = 8 * (1 << 18)
# total bytes of retained path pools for the keep-pools tiled schedule
# (one stored forward + one walk per partition); past it the low-memory
# schedule renders the primal once and re-runs each partition's forward
POOL_BYTES_CAP = 2 << 30

# parameter keys whose leaves reach eval_environment: when one is
# differentiated, the environment is evaluated inside the per-bounce
# gradient so its own cotangent carries the deferred env term
_ENV_KEYS = ("emitters.params", "textures.data", "textures.bitmaps")


def replay_applicable(scene: Scene, params: Dict[str, Tensor], spp: int) \
        -> bool:
    """The replay adjoint covers every regen-able configuration (box or
    tent filter, any film size and spp) but a surface-family scene with a
    subsurface shape, which keeps the scan adjoint, as in the JAX package
    (the VAE event's sampling geometry is not validated under the
    per-bounce VJP).  (The JAX package also sends sensor parameters to the
    scan adjoint; the port has no sensor keys.)"""
    return (regen_applicable(scene, "primal")
            and not (scene.ssub.enabled
                     and scene.integrator in regen_mod._SURFACE))


def _detach(obj):
    """A dataclass tree with every tensor detached (views, no copy)."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            kw[f.name] = v.detach()
        elif dataclasses.is_dataclass(v):
            kw[f.name] = _detach(v)
    return dataclasses.replace(obj, **kw)


def _leaves(scene: Scene, params) -> tuple:
    """(keys, detached float32 values on the scene's device)."""
    keys = tuple(params)
    return keys, [_as_leaf(scene, params[k]).detach() for k in keys]


def _delta_from_pos(scene: Scene, g_rgb: Tensor, pos: Tensor) -> Tensor:
    """Per-path loss cotangent from its film position: the adjoint of the
    regen splat (regen._splat_died).  g_rgb is d loss / d accumulated rgb
    per pixel, (film_w * film_h, 3).  Lanes of a padded last tile
    (pos_y >= film_h, the splat's in_range mask) get zero."""
    w, h = scene.film_w, scene.film_h
    in_range = pos[:, 1] < h
    if scene.rfilter == FILTER_TENT:
        cx, cy = pos[:, 0], pos[:, 1]
        ix0 = torch.floor(cx - 0.5).to(torch.int64)
        iy0 = torch.floor(cy - 0.5).to(torch.int64)
        d = torch.zeros(pos.shape[:-1] + (3,), device=pos.device)
        for dy in (0, 1):
            for dx in (0, 1):
                ix = ix0 + dx
                iy = iy0 + dy
                fw = torch.clamp(1.0 - torch.abs(cx - (ix + 0.5)), min=0.0) \
                    * torch.clamp(1.0 - torch.abs(cy - (iy + 0.5)), min=0.0)
                ok = in_range & (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
                idx = torch.clamp(iy, 0, h - 1) * w \
                    + torch.clamp(ix, 0, w - 1)
                d = d + torch.where(ok[:, None], g_rgb[idx] * fw[:, None],
                                    0.0)
        return d
    px = torch.clamp(pos[:, 0].to(torch.int64), 0, w - 1)
    py = torch.clamp(pos[:, 1].to(torch.int64), 0, h - 1)
    return torch.where(in_range[:, None], g_rgb[py * w + px], 0.0)


def _aux_pool(scene: Scene, g_rgb, pool_L, seed, spp_total: int, pix0: int,
              tile_pix: int, samp0: int, budget: int) -> Tensor:
    """Per-sample [delta_rgb | L_total] rows, (budget, 3 + C): the walk's
    lane rebirth reads both with one gather."""
    CH = min(1 << 20, budget)
    deltas = []
    for c0 in range(0, budget, CH):
        ids = torch.arange(c0, min(c0 + CH, budget), device=pool_L.device)
        pos = lane_pos(scene, ids, seed, spp_total, pix0, tile_pix, samp0)
        deltas.append(_delta_from_pos(scene, g_rgb, pos))
    return torch.cat([torch.cat(deltas), pool_L], -1)


def _to_packet_ct(scene: Scene, delta_rgb, lam):
    """A path's RGB loss cotangent (N, 3) -> its wavelength-packet
    cotangent (N, N_SPEC) through the CIE estimate's weights at lam, in
    the spectral variant; the RGB cotangent itself otherwise."""
    if not scene.spectral:
        return delta_rgb
    return (spec.rgb_estimate_weights(lam) @ delta_rgb[:, :, None])[..., 0]


def _lift_env(scene: Scene, E, lam):
    """Environment radiance lifted to the lanes' packet (spectral)."""
    return spec.smits_upsample_illum(E, lam) if scene.spectral else E


def _replay_walk(scene: Scene, params, seed, spp_total: int, aux_pool,
                 pix0: int, tile_pix: int, samp0: int, spp_chunk: int,
                 on_death=None) -> Dict[str, Tensor]:
    """The backward regen walk over one (pixel tile, spp chunk): replays
    the forward's paths (same sample ids, wavefront, lane cap and counter
    RNG) and sums the parameter gradients bounce by bounce.

    on_death(R2, Ltot, died), when given, sees every iteration's
    recomputed radiance, the stored radiance and the lanes that died
    (tests hold R2 of the dying lanes equal to the pool)."""
    keys, values = _leaves(scene, params)
    sc_det = _detach(apply_params(scene, dict(zip(keys, values))))
    dev = scene.device
    budget = tile_pix * spp_chunk
    W = min(regen_mod.REGEN_WAVEFRONT, budget)
    C = pool_channels(scene)
    fam = regen_mod._family(scene)
    has_envw = scene.integrator not in regen_mod._SURFACE
    diff_env = has_envw and any(k in _ENV_KEYS for k in keys)

    st, _ = _make_lanes(sc_det, torch.arange(W, device=dev), seed,
                        spp_total, pix0, tile_pix, samp0)
    delta = _to_packet_ct(scene, aux_pool[:W, 0:3], st.lam)
    Ltot = aux_pool[:W, 3:3 + C]
    grads = [torch.zeros_like(v) for v in values]
    refills = (budget + W - 1) // W
    lane_cap = regen_mod._lane_cap(scene)
    max_iters = lane_cap * (refills + 2)
    age = torch.zeros((W,), dtype=torch.int64, device=dev)
    next_s = torch.tensor(W, dtype=torch.int64, device=dev)

    for _ in range(max_iters):
        if not bool(st.active.any()):        # the one host sync
            break
        was_active = st.active
        # fresh leaves: this bounce's graph is freed after its gradient
        leaves = [v.requires_grad_() for v in (x.detach() for x in values)]
        with torch.enable_grad():
            sc = apply_params(scene, dict(zip(keys, leaves)))
            # the recorded bounce: volpath walks NEE shadow paths a fixed
            # max_depth steps, as the JAX replay does (the stored forward
            # walks them unbounded: a lane whose walk needs more steps does
            # not rebuild its stored radiance exactly); the surface bounce
            # detaches its continuation ray
            st2 = fam.bounce(sc, st, True)
            outs = [st2.L, st2.throughput]
            if has_envw:
                outs.append(st2.env_weight)
            if diff_env:
                # the env radiance along the post-bounce ray both closes
                # the suffix identity and, through its own cotangent at
                # lane death, carries the deferred env-parameter gradient
                outs.append(_lift_env(scene, eval_environment(sc, st2.ray_d),
                                      st2.lam))
        L2d, tp2d = outs[0].detach(), outs[1].detach()
        if not has_envw:
            R2 = L2d
        else:
            if diff_env:
                E_det = outs[3].detach()
            else:
                E_det = _lift_env(scene, eval_environment(
                    sc_det, st2.ray_d.detach()), st2.lam)
            ew2d = outs[2].detach()
            R2 = L2d + ew2d * E_det
        big = torch.abs(tp2d) > 1e-12
        suffix = torch.where(big, (Ltot - R2) / torch.where(big, tp2d, 1.0),
                             0.0)
        # suffix radiance is non-negative; clamp fp cancellation noise
        suffix = torch.clamp(suffix, 0.0, 1e6)

        age = age + 1
        still = st2.active & (age < lane_cap)
        died = was_active & ~still
        if on_death is not None:
            on_death(R2, Ltot, died)

        msk = was_active[:, None]
        cts = [torch.where(msk, delta, 0.0),
               torch.where(msk, delta * suffix, 0.0)]
        if has_envw:
            cts.append(torch.where(msk, delta * E_det, 0.0))
        if diff_env:
            cts.append(torch.where(died[:, None], delta * ew2d, 0.0))
        used = [i for i, o in enumerate(outs) if o.requires_grad]
        if used:
            gs = torch.autograd.grad([outs[i] for i in used], leaves,
                                     grad_outputs=[cts[i] for i in used],
                                     allow_unused=True)
            grads = [g if gi is None else g + gi for g, gi in zip(grads, gs)]

        st = _detach(dataclasses.replace(st2, active=still))
        ranks = torch.cumsum(died.to(torch.int64), 0) - 1
        new_ids = next_s + ranks
        take = died & (new_ids < budget)
        safe_ids = torch.where(take, new_ids, 0)
        new_st, _ = _make_lanes(sc_det, safe_ids, seed, spp_total, pix0,
                                tile_pix, samp0)
        st = _select_state(take, new_st, st)
        rows = aux_pool[safe_ids]
        delta = torch.where(take[:, None],
                            _to_packet_ct(scene, rows[:, 0:3], new_st.lam),
                            delta)
        Ltot = torch.where(take[:, None], rows[:, 3:3 + C], Ltot)
        age = torch.where(take, 0, age)
        next_s = torch.clamp(next_s + died.sum(), max=budget)
    return dict(zip(keys, grads))


# ---------------------------------------------------------------------------
# single-walk schedule: the film fits one regen tile and its budget fits
# the pool
# ---------------------------------------------------------------------------

class _RenderAcc(torch.autograd.Function):
    """(h*w, 4) film accumulator of the stored-path render; its backward
    is the replay walk."""

    @staticmethod
    def forward(ctx, scene, keys, seed, spp, *values):
        sc = apply_params(scene, dict(zip(keys, values)))
        film, pool_L = _render_regen_tile(sc, seed, spp, 0,
                                          sc.film_w * sc.film_h,
                                          store_paths=True)
        ctx.scene, ctx.keys, ctx.seed, ctx.spp = scene, keys, seed, spp
        ctx.save_for_backward(pool_L, *values)
        return film

    @staticmethod
    def backward(ctx, g_film):
        pool_L, *values = ctx.saved_tensors
        scene, keys, seed, spp = ctx.scene, ctx.keys, ctx.seed, ctx.spp
        n_pix = scene.film_w * scene.film_h
        aux = _aux_pool(scene, g_film[:, 0:3], pool_L, seed, spp, 0, n_pix,
                        0, n_pix * spp)
        grads = _replay_walk(scene, dict(zip(keys, values)), seed, spp, aux,
                             0, n_pix, 0, spp)
        return (None, None, None, None) + tuple(grads[k] for k in keys)


def _grad_replay_single(scene: Scene, params, seed, spp: int, loss_fn):
    keys, values = _leaves(scene, params)
    leaves = [v.requires_grad_() for v in values]
    with torch.enable_grad():
        acc = _RenderAcc.apply(scene, keys, seed, spp, *leaves)
        image = film_mod.develop(acc.view(scene.film_h, scene.film_w, 4))
        loss = loss_fn(image)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for k, v, g in zip(keys, values, gs)}
    return loss.detach(), grads, image.detach()


# ---------------------------------------------------------------------------
# tiled schedule: large films or sample budgets; one (pixel tile, spp
# chunk) forward + walk at a time
# ---------------------------------------------------------------------------

def _loss_from_acc(acc, loss_fn):
    """(loss, image, d loss / d accumulated rgb) of an (h, w, 4)
    accumulator."""
    image = film_mod.develop(acc).detach().requires_grad_()
    with torch.enable_grad():
        loss = loss_fn(image)
        (dL_dI,) = torch.autograd.grad(loss, image)
    wch = acc[..., 3:4]
    g_rgb = torch.where(wch > 0, dL_dI / torch.clamp(wch, min=1e-12), 0.0)
    return loss.detach(), image.detach(), g_rgb.reshape(-1, 3)


def _tile_walk(scene, params, seed, g_rgb, pool_L, pix0, samp0,
               spp_total, spp_chunk, tile_pix):
    aux = _aux_pool(scene, g_rgb, pool_L, seed, spp_total, pix0, tile_pix,
                    samp0, tile_pix * spp_chunk)
    return _replay_walk(scene, params, seed, spp_total, aux, pix0,
                        tile_pix, samp0, spp_chunk)


def _grad_replay_tiled(scene: Scene, params, loss_fn, spp: int, seed):
    w, h = scene.film_w, scene.film_h
    n_pix = w * h
    tile_pix = min(regen_mod.TILE_PIX, n_pix)
    # one flat pool layout for both filters: the pool cap alone sets the
    # chunk (the JAX package's box-filter cap of 16 belongs to its fused
    # film+pool layout)
    spp_chunk = max(1, min(spp, MAX_STORE_PATHS // tile_pix))
    while spp % spp_chunk != 0:
        spp_chunk -= 1
    n_tiles = (n_pix + tile_pix - 1) // tile_pix
    parts = [(t, c) for t in range(n_tiles) for c in range(spp // spp_chunk)]
    keys, values = _leaves(scene, params)
    sc_det = _detach(apply_params(scene, dict(zip(keys, values))))
    grads = {k: torch.zeros_like(v) for k, v in zip(keys, values)}

    def forward(t, c):
        return _render_regen_tile(sc_det, seed, spp, t * tile_pix, tile_pix,
                                  samp0=c * spp_chunk, store_paths=True,
                                  spp_chunk=spp_chunk)

    def walk(t, c, g_rgb, pool_L):
        g = _tile_walk(scene, params, seed, g_rgb, pool_L, t * tile_pix,
                       c * spp_chunk, spp, spp_chunk, tile_pix)
        for k in keys:
            grads[k] = grads[k] + g[k]

    if n_tiles * tile_pix * spp * 12 <= POOL_BYTES_CAP:
        # keep-pools: the stored forwards are the loss's primal
        films = [torch.zeros((tile_pix, 4), device=scene.device)
                 for _ in range(n_tiles)]
        pools = {}
        for t, c in parts:
            film, pools[(t, c)] = forward(t, c)
            films[t] = films[t] + film
        acc = torch.cat(films)[:n_pix].view(h, w, 4)
        loss, image, g_rgb = _loss_from_acc(acc, loss_fn)
        for t, c in parts:
            walk(t, c, g_rgb, pools.pop((t, c)))
        return loss, grads, image

    # low-memory: the primal once, then each partition's forward again
    loss, image, g_rgb = _loss_from_acc(
        regen_mod.render_regen(sc_det, seed, spp), loss_fn)
    for t, c in parts:
        walk(t, c, g_rgb, forward(t, c)[1])
    return loss, grads, image


def render_grad_replay(scene: Scene, params, loss_fn, spp: int = 16,
                       seed: int = 0):
    """(loss, grads, image) through the replay adjoint: the single-walk
    schedule when the film fits one regen tile and the budget fits the
    path pool, the tiled schedule otherwise."""
    n_pix = scene.film_w * scene.film_h
    if n_pix <= regen_mod.TILE_PIX and n_pix * spp <= MAX_STORE_PATHS:
        return _grad_replay_single(scene, params, seed, spp, loss_fn)
    return _grad_replay_tiled(scene, params, loss_fn, spp, seed)
