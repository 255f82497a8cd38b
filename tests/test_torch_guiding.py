"""The port's guiding distributions against the JAX package on identical
inputs (made with numpy from a seed): the regular grid (its mass clamp and
power transform, draws and cell lookup), the pilot-guided edge weights,
and the octree, whose host-built leaves must be bit-equal.

Tolerance: fp32 (rtol 1e-6, atol 1e-7): XLA's cumsum on the CPU sums in
another order than torch's, a few ulps apart; discrete outcomes (cells,
octree leaves) are equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liverrenderer_tpu.integrators import guiding as jg
from liverrenderer_tpu_torch.integrators import guiding as tg
from torch_threads import torch_threads_per_worker  # noqa: F401

RTOL, ATOL = 1e-6, 1e-7


def _close(t, j, name, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=atol, err_msg=name)


@pytest.mark.parametrize("clamp,scale", [(0.0, 0.0), (0.05, 0.0),
                                         (0.0, 0.5), (0.02, 2.0)])
def test_grid_distribution_matches(clamp, scale):
    rng = np.random.default_rng(7)
    res = (4, 3, 5)
    mass = rng.uniform(-0.2, 1.0, res).astype(np.float32)
    jd = jg.grid_from_mass(jnp.asarray(mass), res, clamp, scale)
    td = tg.grid_from_mass(torch.from_numpy(mass), res, clamp, scale)
    _close(td.pmf, jd.pmf, "pmf")
    _close(td.cdf, jd.cdf, "cdf")
    u = rng.uniform(size=(8192, 4)).astype(np.float32)
    jp, jr = jg.grid_sample(jd, jnp.asarray(u))
    tp, tr = tg.grid_sample(td, torch.from_numpy(u))
    _close(tp, jp, "points")
    _close(tr, jr, "rcp", rtol=1e-5)
    np.testing.assert_array_equal(tg.grid_cell_of(td, tp).numpy(),
                                  np.asarray(jg.grid_cell_of(jd, jp)))


def test_grid_all_zero_mass_is_uniform():
    td = tg.grid_from_mass(torch.zeros(8), (2, 2, 2))
    jd = jg.grid_from_mass(jnp.zeros(8), (2, 2, 2))
    _close(td.pmf, jd.pmf, "pmf")
    assert torch.allclose(td.pmf, torch.full((8,), 0.125))


@pytest.mark.parametrize("seen", [True, False])
def test_edge_guided_weights_match(seen):
    """Pilot mass scattered onto edges, restricted to the silhouette set
    (base weight > 0), mixed with the length measure; a pilot that saw
    nothing gives the length measure."""
    rng = np.random.default_rng(8)
    E, P = 300, 5000
    base = rng.uniform(0.1, 1.0, E).astype(np.float32)
    base[rng.uniform(size=E) < 0.4] = 0.0
    mass = rng.exponential(1.0, P).astype(np.float32) * seen
    e_idx = rng.integers(0, E, P)
    tw = tg.edge_guided_weights(torch.from_numpy(mass),
                                torch.from_numpy(e_idx),
                                torch.from_numpy(base))
    jw = jg.edge_guided_weights(jnp.asarray(mass), jnp.asarray(e_idx),
                                jnp.asarray(base))
    _close(tw, jw, "weights", rtol=1e-5)
    assert float(tw[base == 0].abs().max()) == 0.0
    np.testing.assert_allclose(float(tw.sum()), 1.0, rtol=1e-5)


@pytest.mark.parametrize("n,spread", [(20000, 0.05), (3000, 0.3)])
def test_octree_leaves_bit_equal(n, spread):
    """The host recursion of both packages on the same pilot samples: the
    same leaves, pmf and cdf bit for bit, and the same draws."""
    rng = np.random.default_rng(9)
    pts = np.clip(rng.normal([0.2, 0.3, 0.7], spread, (n, 3)), 0, 1)
    w = rng.exponential(1.0, n)
    jo = jg.octree_from_samples(pts, w)
    to = tg.octree_from_samples(torch.from_numpy(pts), torch.from_numpy(w))
    assert to.pmf.shape[0] > 8
    for k in ("leaf_lo", "leaf_hi", "pmf", "cdf"):
        np.testing.assert_array_equal(getattr(to, k).numpy(),
                                      np.asarray(getattr(jo, k)), err_msg=k)
    u = rng.uniform(size=(8192, 4)).astype(np.float32)
    jp, jd = jo.sample(jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1:4]))
    tp, td = to.sample(torch.from_numpy(u[:, 0]), torch.from_numpy(u[:, 1:4]))
    _close(tp, jp, "points")
    _close(td, jd, "density", rtol=1e-6)
