"""The gradient slice's modules against the JAX package on identical
inputs, on the CPU: parameter leaves, the bio score term, one bounce's
VJP, the splat adjoint, the stored path pool and the replay walk
(parameter traversal: tests/test_torch_grad_keys.py).

Tolerances.  Per-lane values run the same fp32 formulas in both packages
(rtol 1e-5, an ulp of XLA's and PyTorch's log/exp apart).  A bounce's VJP
sums per-lane products over the wavefront in another order, and goes
through exp and log on both sides: rtol 1e-4, atol 1e-6.  The splat
adjoint is pure indexing and products (rtol 1e-6).  The stored pool is a
render per sample, held at the per-pixel tolerances of
test_torch_render.py.  The replay walk recomputes, in the same package and
with the same operations, what the forward stored: equal exactly.

One bounce's VJP runs from tests/test_torch_bounce_vjp.py, which shares
this file's scenes and tolerances, so that xdist's file scheduler can
start it apart from this file (a long file holds one worker to its end).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu.integrators import prb_replay as jreplay
from liverrenderer_tpu.integrators import regen as jregen
from liverrenderer_tpu.media import dispatch as jmed
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.accel import cuda_intersect as tci
from liverrenderer_tpu_torch.bridge import (numpy_tree, params_from_numpy,
                                            scene_from_numpy)
from liverrenderer_tpu_torch.core.rng import Sampler as TSampler
from liverrenderer_tpu_torch.integrators import prb_replay as treplay
from liverrenderer_tpu_torch.integrators import regen as tregen
from liverrenderer_tpu_torch.integrators import volpath as tvp
from liverrenderer_tpu_torch.media import dispatch as tmed
from liverrenderer_tpu_torch.scene.liver_proxy import liver_proxy_dict
from torch_threads import torch_threads_per_worker  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
VJP_RTOL, VJP_ATOL = 1e-4, 1e-6
PIX_RTOL, PIX_ATOL, PIX_FRAC, MEAN_RTOL = 1e-3, 1e-4, 0.99, 1e-3
KEYS = ("media.params", "bsdfs.params")


@pytest.fixture(scope="module")
def scenes():
    """The liver proxy (320 triangles, depth 12) in both packages."""
    js = lr.load_dict(liver_proxy_dict(16, 12, 4, 2, 0))
    return js, scene_from_numpy(*numpy_tree(js), "cpu")


def _t(a):
    """A JAX/numpy array as the port's tensor: ints -> int64."""
    a = np.asarray(a)
    if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.floating):
        return torch.from_numpy(np.array(a))
    return torch.from_numpy(a.astype(np.int64))


def _port_state(jst):
    """The port's VolpathState holding the JAX state's exact values."""
    kw = {f.name: _t(getattr(jst, f.name))
          for f in dataclasses.fields(tvp.VolpathState)
          if f.name != "sampler" and getattr(jst, f.name) is not None}
    js = jst.sampler
    kw["sampler"] = TSampler(seed=_t(js.seed), dim=_t(js.dim),
                             samp=_t(js.samp), pix=_t(js.pix))
    return tvp.VolpathState(**kw)


def test_params_from_numpy_matches_jax_leaves(scenes):
    js, ts = scenes
    jp = {k: np.asarray(lr.traverse(js)[k]) for k in KEYS}
    tp = params_from_numpy(jp, "cpu")
    for k in KEYS:
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), jp[k])
        np.testing.assert_array_equal(lrt.traverse(ts)[k].numpy(), jp[k])


def test_bio_log_p_and_rates_match_jax(scenes):
    """The liver medium's competing-exponential sampling on identical lanes
    (every layer and the parenchyma through tissue depth), then the score
    term's log-likelihood under random segment bounds."""
    js, ts = scenes
    rng = np.random.default_rng(7)
    n = 4096
    midx = np.full(n, int(np.argmax(np.asarray(js.media.mtype)
                                    == jmed.MEDIUM_LIVER)), np.int32)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ch = rng.integers(0, 3, n).astype(np.int32)
    depth = rng.uniform(0.0, 0.05, n).astype(np.float32)
    active = rng.uniform(size=n) < 0.9
    maxt = rng.uniform(0.0, 0.6, n).astype(np.float32)
    ids = np.arange(n)
    from liverrenderer_tpu.core import rng as jrng
    from liverrenderer_tpu_torch.core import rng as trng
    jsam = jrng.make_sampler(jnp.asarray(ids, jnp.uint32), 0, 3)
    tsam = trng.make_sampler(torch.from_numpy(ids), 0, 3)
    jc, _ = jmed.sample_interaction_candidate(
        js, jnp.asarray(midx), jnp.asarray(o), jnp.asarray(d), jsam,
        jnp.asarray(ch), jnp.asarray(depth), jnp.asarray(active))
    tc, _ = tmed.sample_interaction_candidate(
        ts, _t(midx), torch.from_numpy(o), torch.from_numpy(d), tsam,
        _t(ch), torch.from_numpy(depth), torch.from_numpy(active))
    for k in ("dist", "rate_total", "rate_chosen"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert np.ptp(np.asarray(jc["rate_total"])) > 0   # layers differ
    jm = jmed.finalize_interaction(jc, jnp.asarray(maxt), jnp.asarray(ch),
                                   jnp.asarray(active))
    tm = tmed.finalize_interaction(tc, torch.from_numpy(maxt), _t(ch),
                                   torch.from_numpy(active))
    lp = np.asarray(jm.log_p)
    np.testing.assert_allclose(tm.log_p.numpy(), lp, rtol=RTOL, atol=ATOL)
    # both branches (scatter inside the segment, escape past it) occur
    valid = np.asarray(jm.t) < np.inf
    assert (lp[valid & active] != 0).any()
    assert (lp[~valid & active] != 0).any()
    assert (lp[~active] == 0).all()


@pytest.mark.parametrize("rfilter", ["box", "tent"])
def test_delta_from_pos_matches_jax(rfilter):
    d = liver_proxy_dict(7, 5, 1, 0, 0)
    d["sensor"]["film"]["rfilter"] = {"type": rfilter}
    js = lr.load_dict(d)
    ts = scene_from_numpy(*numpy_tree(js), "cpu")
    rng = np.random.default_rng(2)
    g_rgb = rng.normal(size=(35, 3)).astype(np.float32)
    # positions over the film, its edges and a padded last tile's rows
    pos = np.concatenate([
        rng.uniform([0, 0], [7, 5], (500, 2)),
        rng.uniform([0, 5], [7, 7], (50, 2)),
        np.array([[0.0, 0.0], [6.999, 4.999], [0.5, 0.5], [3.5, 5.0]])],
        0).astype(np.float32)
    ref = np.asarray(jreplay._delta_from_pos(js, jnp.asarray(g_rgb),
                                             jnp.asarray(pos)))
    got = treplay._delta_from_pos(ts, torch.from_numpy(g_rgb),
                                  torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    assert (got[500:550] == 0).all() and np.abs(got[:500]).min() > 0


def test_stored_pool_matches_jax(scenes):
    """The stored-path forward: the film and the per-sample radiance pool
    against the JAX package's (its fused layout, read as a flat pool)."""
    js, ts = scenes
    n_pix = 16 * 12
    jfilm, jpool = jregen._render_regen_tile(js, 0, 4, 0, n_pix,
                                             store_paths=True)
    tfilm, tpool = tregen._render_regen_tile(ts, 0, 4, 0, n_pix,
                                             store_paths=True)
    jpool, tpool = np.asarray(jpool), tpool.numpy()
    assert tpool.shape == jpool.shape == (n_pix * 4, 3)
    close = np.abs(tpool - jpool) <= PIX_ATOL + PIX_RTOL * np.abs(jpool)
    assert close.all(-1).mean() >= PIX_FRAC
    assert abs(tpool.mean() - jpool.mean()) <= MEAN_RTOL * abs(jpool.mean())
    np.testing.assert_allclose(tfilm.numpy(), np.asarray(jfilm), rtol=1e-4,
                               atol=1e-5)
    # the film is the pool's per-pixel sum (box filter, one tap)
    np.testing.assert_allclose(
        tpool.reshape(4, n_pix, 3).sum(0), tfilm[:, :3].numpy(), rtol=1e-5,
        atol=1e-6)


def test_replay_walk_recomputes_the_stored_radiance(scenes, monkeypatch):
    """Every lane's radiance recomputed by the replay walk at its death
    equals what the forward stored for that sample, and every sample of
    the budget dies once (wavefront smaller than the budget, so lanes are
    reborn)."""
    _, ts = scenes
    monkeypatch.setattr(tregen, "REGEN_WAVEFRONT", 200)
    n_pix, spp = 16 * 12, 2
    _, pool = tregen._render_regen_tile(ts, 5, spp, 0, n_pix,
                                        store_paths=True)
    g_rgb = torch.ones((n_pix, 3))
    aux = treplay._aux_pool(ts, g_rgb, pool, 5, spp, 0, n_pix, 0,
                            n_pix * spp)
    deaths = []

    def on_death(R2, Ltot, died):
        assert torch.equal(torch.where(torch.isfinite(R2), R2, 0.0)[died],
                           Ltot[died])
        deaths.append(int(died.sum()))

    g = treplay._replay_walk(ts, {"media.params": ts.media.params}, 5, spp,
                             aux, 0, n_pix, 0, spp, on_death=on_death)
    assert sum(deaths) == n_pix * spp
    assert torch.isfinite(g["media.params"]).all()


def test_intersect_on_rays_that_require_grad(scenes):
    """Hit finding carries no derivative: rays with autograd history give
    outputs without one, and the same hits."""
    _, ts = scenes
    rng = np.random.default_rng(3)
    o = torch.tensor(rng.normal(size=(256, 3)) * 0.3, dtype=torch.float32)
    d = torch.tensor(rng.normal(size=(256, 3)), dtype=torch.float32)
    d = d / d.norm(dim=-1, keepdim=True)
    maxt = torch.full((256,), float("inf"))
    og, dg = o.clone().requires_grad_(), d.clone().requires_grad_()
    t, prim, _, _ = tci.intersect_tris(ts.tri_buf, ts.tri_boxes, ts.tri_kperm,
                                       og * 1.0, dg * 1.0, maxt, maxt,
                                       center=ts.tri_center)
    assert not t.requires_grad and not prim.requires_grad
    t0, prim0, _, _ = tci.intersect_tris(ts.tri_buf, ts.tri_boxes,
                                         ts.tri_kperm, o, d, maxt, maxt,
                                         center=ts.tri_center)
    assert torch.equal(t, t0) and torch.equal(prim, prim0)
    assert (prim >= 0).sum() > 100
    rays = torch.cat([og.T, dg.T, maxt[None], maxt[None] * 0], 0)
    tk, pk = tci.intersect_closest(rays, ts.tri_buf, ts.tri_boxes)
    assert not tk.requires_grad and not pk.requires_grad


@pytest.mark.parametrize("rows", [1, 3, 12])
def test_table_lookup_is_the_gather(rows):
    """Broadcast (1 row), select chain (<= 8) or gather (more): the values
    and the gradient of the gather, exactly (each lane adds one row's
    cotangent; sums over lanes in another order stay within fp32)."""
    from liverrenderer_tpu_torch.core import math as tm
    rng = np.random.default_rng(rows)
    table = torch.tensor(rng.normal(size=(rows, 5)), dtype=torch.float32,
                         requires_grad=True)
    idx = torch.from_numpy(rng.integers(0, rows, 1000))
    ct = torch.tensor(rng.normal(size=(1000, 5)), dtype=torch.float32)
    got = tm.table_lookup(table, idx)
    ref = table[idx]
    assert torch.equal(got, ref)
    (g_got,) = torch.autograd.grad(got, table, ct)
    (g_ref,) = torch.autograd.grad(ref, table, ct)
    torch.testing.assert_close(g_got, g_ref, rtol=1e-5, atol=1e-5)
