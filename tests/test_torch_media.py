"""The stock media's components in the port against the JAX package on
identical inputs (made with numpy from a seed): the heterogeneous medium's
grid lookup and free-flight candidate, the extended phase functions'
evaluation and sampling, the builders' medium rows and grid buffers (also
from a test-written .vol file).

Tolerance: fp32, rtol 1e-5 with atol 1e-6 unless stated.  Both packages
run the same formulas in float32; XLA and PyTorch may differ by an ulp in
a transcendental or in the order of a short sum (the grid transform's
3x3 product, tabphase's 32-bin cumulative sum).  Sampled directions are
held to atol 2e-5 for that reason: an ulp in a bin's cumulative sum moves
the inverse-CDF sample by about 32x the ulp of cos_theta.  Discrete
outcomes and sampler dimensions must be equal; builder buffers are
compared bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu.core import rng as jrng
from liverrenderer_tpu.media import dispatch as jmed
from liverrenderer_tpu.phase import dispatch as jph
from liverrenderer_tpu.scene import builder as jbuilder
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.bridge import numpy_tree, scene_from_numpy
from liverrenderer_tpu_torch.core import rng as trng
from liverrenderer_tpu_torch.io.vol import read_vol, write_vol
from liverrenderer_tpu_torch.media import dispatch as tmed
from liverrenderer_tpu_torch.phase import dispatch as tph
from liverrenderer_tpu_torch.scene.ir import (MEDIUM_P, PHASE_BLEND,
                                              PHASE_HG, PHASE_ISOTROPIC,
                                              PHASE_RAYLEIGH, PHASE_SGGX,
                                              PHASE_TAB)
from liverrenderer_tpu_torch.scene.transform import Transform
from torch_threads import torch_threads_per_worker  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
DIR_ATOL = 2e-5
N = 4096

PHASES = {
    "isotropic": {"type": "isotropic"},
    "hg": {"type": "hg", "g": 0.6},
    "rayleigh": {"type": "rayleigh"},
    "blendphase": {"type": "blendphase", "weight": 0.4,
                   "a": {"type": "hg", "g": 0.5},
                   "b": {"type": "isotropic"}},
    "tabphase": {"type": "tabphase", "values": [0.2, 0.5, 1.0, 2.0, 1.0, 0.5]},
    "tabphase_str": {"type": "tabphase", "values": "3, 1, 0.25, 0.1"},
    "sggx": {"type": "sggx", "S": [1.0, 0.3, 0.6, 0.0, 0.0, 0.0]},
    "sggx_keys": {"type": "sggx", "S_xx": 0.4, "S_yy": 1.0, "S_zz": 0.2,
                  "S_xy": 0.1, "S_xz": -0.05, "S_yz": 0.2},
}


def _close(t, j, name="", rtol=RTOL, atol=ATOL):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    if np.issubdtype(j.dtype, np.floating):
        np.testing.assert_allclose(t, j, rtol=rtol, atol=atol, err_msg=name)
    else:
        np.testing.assert_array_equal(t, j.astype(t.dtype), err_msg=name)


@pytest.fixture
def np_rng():
    return np.random.default_rng(11)


def _grids(rng):
    """Two grids of different sizes (the stack pads to the larger), one of
    them 3-channel, with non-trivial transforms."""
    g0 = rng.uniform(0.0, 2.0, (5, 7, 6)).astype(np.float32)
    g1 = rng.uniform(0.0, 1.0, (4, 3, 9, 3)).astype(np.float32)
    tw0 = Transform().translate([-0.5, 0.2, 0.1]).scale([1.5, 1.0, 2.0])
    tw1 = Transform().rotate([0, 1, 1], 30.0).scale(0.8)
    return (g0, tw0.matrix.copy()), (g1, tw1.matrix.copy())


def _grid_media_dict(rng, phase=None):
    (g0, m0), (g1, m1) = _grids(rng)
    med = {
        "type": "heterogeneous", "scale": 1.7,
        "albedo": {"type": "rgb", "value": [0.3, 0.6, 0.9]},
        "sigma_t": {"type": "gridvolume", "data": g0, "to_world": m0}}
    if phase is not None:
        med["phase"] = phase
    return {
        "type": "scene", "integrator": {"type": "volpath", "max_depth": 4},
        "m0": med,
        "m1": {"type": "heterogeneous", "scale": 0.5,
               "sigma_t": {"type": "gridvolume", "data": g1, "to_world": m1},
               "phase": {"type": "hg", "g": -0.3}},
        "m2": {"type": "homogeneous",
               "sigma_t": {"type": "rgb", "value": [0.5, 1.0, 2.0]},
               "albedo": 0.8},
        "a": {"type": "rectangle", "bsdf": {"type": "null"},
              "interior": {"type": "ref", "id": "m0"},
              "exterior": {"type": "ref", "id": "m2"}},
        # a heterogeneous medium with a constant sigma_t reads grid 0's
        # density, as in the JAX package (ROADMAP Queue 3)
        "m3": {"type": "heterogeneous",
               "sigma_t": {"type": "rgb", "value": [0.7, 0.2, 0.4]}},
        "b": {"type": "rectangle", "bsdf": {"type": "null"},
              "interior": {"type": "ref", "id": "m1"},
              "exterior": {"type": "ref", "id": "m3"}},
    }


def _bridge(d):
    js = lr.load_dict(d)
    return js, scene_from_numpy(*numpy_tree(js), "cpu")


def _both_builders(d, base_dir="."):
    """(numpy tree of the JAX builder's scene, the port builder's)."""
    from liverrenderer_tpu_torch.scene.builder import build_numpy
    ja, js = numpy_tree(lr.load_dict(d, base_dir=base_dir))
    ta, ts = build_numpy(d, base_dir)
    return (ja, js), (ta, ts)


def test_builders_pack_media_grids_and_phases(np_rng):
    """Every medium row, the grid stack, its sizes and transforms and the
    statics equal the JAX builder's bit for bit, for each phase plugin."""
    for name, phase in PHASES.items():
        (ja, js), (ta, ts) = _both_builders(
            _grid_media_dict(np.random.default_rng(3), phase))
        for k in ("media.mtype", "media.params", "media.grid_id",
                  "media.grids", "media.grid_whd", "media.grid_to_local"):
            np.testing.assert_array_equal(
                ta[k], np.asarray(ja[k]).astype(ta[k].dtype),
                err_msg=f"{name}: {k}")
        for k in ("media.types_present", "media.phase_types"):
            assert tuple(ts[k]) == tuple(js[k]), (name, k)


def test_vol_file_loads_into_equal_buffers(tmp_path, np_rng):
    """A .vol file written by the port loads into the JAX reader's array
    and into equal grid buffers in both builders (a file name against
    base_dir, 1 and 3 channels); the reader ignores the header's encoding
    field, as the JAX package's does."""
    g1 = np_rng.uniform(0, 3, (6, 5, 4)).astype(np.float32)
    g3 = np_rng.uniform(0, 1, (3, 4, 5, 3)).astype(np.float32)
    write_vol(str(tmp_path / "one.vol"), g1)
    write_vol(str(tmp_path / "three.vol"), g3)
    for name, g in (("one.vol", g1[..., None]), ("three.vol", g3)):
        got = read_vol(str(tmp_path / name))
        np.testing.assert_array_equal(got, g)
        np.testing.assert_array_equal(
            got, jbuilder._load_vol(str(tmp_path / name)))
    raw = bytearray((tmp_path / "one.vol").read_bytes())
    raw[4] = 3                              # encoding field: uint8
    (tmp_path / "enc.vol").write_bytes(bytes(raw))
    np.testing.assert_array_equal(read_vol(str(tmp_path / "enc.vol")),
                                  g1[..., None])
    (tmp_path / "bad.vol").write_bytes(b"NOTAVOL" + bytes(60))
    with pytest.raises(ValueError, match="not a .vol"):
        read_vol(str(tmp_path / "bad.vol"))
    d = {"type": "scene",
         "m0": {"type": "heterogeneous", "scale": 2.0,
                "sigma_t": {"type": "gridvolume", "filename": "one.vol"}},
         "m1": {"type": "heterogeneous",
                "sigma_t": {"type": "gridvolume", "filename": "three.vol",
                            "to_world": Transform().scale(2.0).matrix.copy()}},
         "s": {"type": "rectangle", "bsdf": {"type": "null"},
               "interior": {"type": "ref", "id": "m0"},
               "exterior": {"type": "ref", "id": "m1"}}}
    (ja, _), (ta, _) = _both_builders(d, base_dir=str(tmp_path))
    for k in ("media.params", "media.grid_id", "media.grids",
              "media.grid_whd", "media.grid_to_local"):
        np.testing.assert_array_equal(ta[k], np.asarray(ja[k]).astype(
            ta[k].dtype), err_msg=k)


def test_eval_grid_matches_jax(np_rng):
    """Trilinear lookups of two padded grids at points inside, on the
    boundary and outside (clamped) of each grid's box."""
    js, ts = _bridge(_grid_media_dict(np_rng))
    gid = np_rng.integers(0, 2, N)
    p = np_rng.uniform(-1.5, 1.5, (N, 3)).astype(np.float32)
    j = jmed._eval_grid(js, jnp.asarray(gid, jnp.int32), jnp.asarray(p))
    t = tmed._eval_grid(ts, torch.from_numpy(gid), torch.from_numpy(p))
    _close(t, j, "density")
    assert (np.asarray(j) > 0).all()


def test_grid_lookup_backward_is_one_buffer_sum(np_rng):
    """The lookup's gradient with respect to the grid stack equals the
    JAX package's and the plain gather's (8 taps per lane summed into one
    grid-shaped buffer), and it flows to the points as well."""
    js, ts = _bridge(_grid_media_dict(np_rng))
    gid = np_rng.integers(0, 2, 512)
    p = np_rng.uniform(-0.2, 1.2, (512, 3)).astype(np.float32)
    w = np_rng.normal(size=512).astype(np.float32)

    def jf(grids):
        sc = js.replace(media=js.media.replace(grids=grids))
        return jnp.sum(jmed._eval_grid(sc, jnp.asarray(gid, jnp.int32),
                                       jnp.asarray(p)) * w)

    jg = jax.grad(jf)(js.media.grids)
    grids = ts.media.grids.clone().requires_grad_()
    pt = torch.from_numpy(p).requires_grad_()
    sc = ts.replace(media=ts.media.replace(grids=grids))
    out = torch.sum(tmed._eval_grid(sc, torch.from_numpy(gid), pt)
                    * torch.from_numpy(w))
    tg, tgp = torch.autograd.grad(out, [grids, pt])
    _close(tg, jg, "d/dgrids", atol=1e-5)
    assert tg[..., 1:].abs().sum() == 0 and tg.abs().sum() > 0
    assert torch.isfinite(tgp).all() and tgp.abs().sum() > 0


@pytest.mark.parametrize("integrator", ["volpath", "biovolpath"])
def test_heterogeneous_candidate_matches_jax(np_rng, integrator):
    """sample_interaction_candidate and finalize on lanes in the two grid
    media, the homogeneous one and vacuum: the majorant, the density at
    the candidate point times scale, sigma_n = max(majorant - sigma_t, 0),
    the detached distance and the sampler dimensions."""
    d = _grid_media_dict(np_rng)
    d["integrator"]["type"] = integrator
    js, ts = _bridge(d)
    midx = np_rng.integers(-1, 4, N)
    o = np_rng.uniform(-0.5, 1.5, (N, 3)).astype(np.float32)
    dd = np_rng.normal(size=(N, 3)).astype(np.float32)
    dd /= np.linalg.norm(dd, axis=-1, keepdims=True)
    ch = np_rng.integers(0, 3, N)
    td = np.zeros(N, np.float32)
    active = midx >= 0
    maxt = np_rng.uniform(0.0, 2.0, N).astype(np.float32)
    jsam = jrng.make_sampler(jnp.arange(N), 3, 9)
    tsam = trng.make_sampler(torch.arange(N), 3, 9)
    jc, jsam = jmed.sample_interaction_candidate(
        js, jnp.asarray(midx, jnp.int32), jnp.asarray(o), jnp.asarray(dd),
        jsam, jnp.asarray(ch, jnp.int32), jnp.asarray(td),
        jnp.asarray(active))
    tc, tsam = tmed.sample_interaction_candidate(
        ts, torch.from_numpy(midx), torch.from_numpy(o),
        torch.from_numpy(dd), tsam, torch.from_numpy(ch),
        torch.from_numpy(td), torch.from_numpy(active))
    for k in ("dist", "p", "sigma_t", "sigma_s", "sigma_n", "majorant"):
        _close(tc[k], jc[k], k)
    _close(tsam.dim, np.asarray(jsam.dim).astype(np.int64), "dim")
    het = np.isin(midx, (0, 1, 3))
    assert (np.asarray(jc["sigma_n"])[het] > 0).any()
    jmei = jmed.finalize_interaction(jc, jnp.asarray(maxt),
                                     jnp.asarray(ch, jnp.int32),
                                     jnp.asarray(active))
    tmei = tmed.finalize_interaction(tc, torch.from_numpy(maxt),
                                     torch.from_numpy(ch),
                                     torch.from_numpy(active))
    for k in ("t", "p", "sigma_t", "sigma_n", "combined_extinction"):
        _close(getattr(tmei, k), getattr(jmei, k), k)


def _phase_lanes(rng, n):
    """Lanes with every phase type mixed, each with its own medium row."""
    prm = np.zeros((n, MEDIUM_P), np.float32)
    ptype = rng.choice([PHASE_ISOTROPIC, PHASE_HG, PHASE_RAYLEIGH,
                        PHASE_BLEND, PHASE_TAB, PHASE_SGGX], n)
    g = rng.uniform(-0.9, 0.9, n).astype(np.float32)
    prm[:, 11] = rng.uniform(0.0, 1.0, n)
    prm[:, 12] = rng.choice([PHASE_ISOTROPIC, PHASE_HG], n)
    prm[:, 13] = rng.uniform(-0.9, 0.9, n)
    prm[:, 14] = rng.choice([PHASE_ISOTROPIC, PHASE_HG], n)
    prm[:, 15] = rng.uniform(-0.9, 0.9, n)
    tab = rng.uniform(0.0, 2.0, (n, 32)).astype(np.float32)
    tab[rng.uniform(size=(n, 32)) < 0.2] = 0.0        # empty bins
    # sggx lanes: a symmetric positive definite S; tab lanes: the table
    a = rng.normal(size=(n, 3, 3)).astype(np.float32)
    s = np.einsum("nij,nkj->nik", a, a) + 0.1 * np.eye(3, dtype=np.float32)
    s6 = np.stack([s[:, 0, 0], s[:, 1, 1], s[:, 2, 2], s[:, 0, 1],
                   s[:, 0, 2], s[:, 1, 2]], -1)
    prm[:, 16:48] = np.where((ptype == PHASE_TAB)[:, None], tab, 0.0)
    prm[:, 16:22] = np.where((ptype == PHASE_SGGX)[:, None], s6,
                             prm[:, 16:22])
    fwd = rng.normal(size=(n, 3)).astype(np.float32)
    fwd /= np.linalg.norm(fwd, axis=-1, keepdims=True)
    u2 = rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    return ptype, g, prm, fwd, u2


@pytest.mark.parametrize("present", [None, "all", "basic"])
def test_phase_sample_and_eval_match_jax(np_rng, present):
    """phase_sample's direction, weight and pdf and phase_eval at random
    directions, every phase type mixed (present=None: every branch;
    "all": the static set of all codes; "basic": isotropic, hg and
    rayleigh only, with prm given)."""
    ptype, g, prm, fwd, u2 = _phase_lanes(np_rng, N)
    codes = {None: None,
             "all": (0, 1, 2, 3, 4, 5),
             "basic": (PHASE_ISOTROPIC, PHASE_HG, PHASE_RAYLEIGH)}[present]
    if present == "basic":
        keep = np.isin(ptype, codes)
        ptype, g, prm, fwd, u2 = (x[keep] for x in (ptype, g, prm, fwd, u2))
    jargs = (jnp.asarray(ptype, jnp.int32), jnp.asarray(g))
    targs = (torch.from_numpy(ptype), torch.from_numpy(g))
    jwo, jw, jpdf = jph.phase_sample(*jargs, jnp.asarray(fwd),
                                     jnp.asarray(u2), jnp.asarray(prm),
                                     codes)
    two, tw, tpdf = tph.phase_sample(*targs, torch.from_numpy(fwd),
                                     torch.from_numpy(u2),
                                     torch.from_numpy(prm), codes)
    _close(two, jwo, "wo", atol=DIR_ATOL)
    _close(tw, jw, "weight", rtol=1e-4)
    _close(tpdf, jpdf, "pdf", rtol=1e-4, atol=1e-5)
    wo = np_rng.normal(size=fwd.shape).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    cos = np.sum(fwd * wo, -1)
    jv = jph.phase_eval(*jargs, jnp.asarray(cos), jnp.asarray(prm),
                        jnp.asarray(fwd), jnp.asarray(wo), codes)
    tv = tph.phase_eval(*targs, torch.from_numpy(cos), torch.from_numpy(prm),
                        torch.from_numpy(fwd), torch.from_numpy(wo), codes)
    _close(tv, jv, "value", rtol=1e-4)
    assert np.isfinite(np.asarray(jv)).all()


def test_tab_sampling_draws_the_bins_by_mass(np_rng):
    """tabphase's inverse CDF picks each bin with its mass (the JAX
    rule, `sum(cdf < u * total)`), including empty bins at either end."""
    n = 1 << 16
    prm = np.zeros((n, MEDIUM_P), np.float32)
    tab = np.zeros(32, np.float32)
    tab[3], tab[10], tab[31] = 1.0, 3.0, 4.0
    prm[:, 16:48] = tab
    u = np_rng.uniform(size=n).astype(np.float32)
    ct = tph._tab_sample_cos(torch.from_numpy(prm), torch.from_numpy(u))
    jct = jph._tab_sample_cos(jnp.asarray(prm), jnp.asarray(u))
    _close(ct, jct, "cos", atol=DIR_ATOL)
    b = np.clip(((ct.numpy() + 1.0) * 16).astype(int), 0, 31)
    frac = np.bincount(b, minlength=32) / n
    np.testing.assert_allclose(frac[[3, 10, 31]], [0.125, 0.375, 0.5],
                               atol=0.01)
    assert frac.sum() == pytest.approx(frac[[3, 10, 31]].sum())


def test_phase_plugin_errors():
    """blendphase without two isotropic/hg children and an unknown phase
    raise ValueError, as in the JAX builder (which asserts)."""
    base = {"type": "scene",
            "m": {"type": "homogeneous"},
            "s": {"type": "rectangle", "bsdf": {"type": "null"},
                  "interior": {"type": "ref", "id": "m"}}}
    for phase in ({"type": "blendphase", "a": {"type": "hg"}},
                  {"type": "no_such_phase"}):
        d = dict(base)
        d["m"] = {"type": "homogeneous", "phase": phase}
        with pytest.raises(ValueError):
            lrt.load_dict(d, device="cpu")
