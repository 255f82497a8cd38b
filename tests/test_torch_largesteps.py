"""LargeSteps (liverrenderer_tpu_torch/largesteps.py) against the JAX
package's on the CPU: tests/test_largesteps.py's three cases run through
both packages, and the CG solve and its gradient against `jax.grad`.

Tolerances: the solve and its gradient within 1e-5 of the largest entry
(both CGs stop at |r| <= 1e-6 |b|; their sums round in other orders);
to_differential within 1e-6; the Adam loop's losses within 1e-3
relative of optax's (the same Adam, rounded otherwise over 60 steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu.scene import geometry as jgeo
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.scene.liver_proxy import liver_mesh
from torch_threads import torch_threads_per_worker  # noqa: F401

RTOL = 1e-5


def _mesh():
    return jgeo.icosphere(2)    # 320 faces


def _pair(n, faces, **kw):
    return lr.LargeSteps(n, faces, **kw), \
        lrt.LargeSteps(n, faces, device="cpu", **kw)


def _close(got, ref, rtol=RTOL):
    got = got.detach().numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


def test_tables_equal():
    mesh = _mesh()
    js, ts = _pair(len(mesh.vertices), mesh.faces)
    np.testing.assert_array_equal(ts.edges.numpy(), np.asarray(js.edges))
    np.testing.assert_array_equal(ts.degree.numpy(), np.asarray(js.degree))
    assert ts.n == js.n and ts.lambda_ == js.lambda_


def test_roundtrip():
    mesh = _mesh()
    js, ts = _pair(len(mesh.vertices), mesh.faces, lambda_=19.0)
    v = torch.as_tensor(mesh.vertices)
    u = ts.to_differential(v)
    _close(u, js.to_differential(jnp.asarray(mesh.vertices)), 1e-6)
    v2 = ts.from_differential(u, tol=1e-8, maxiter=500)
    assert float((v2 - v).abs().max()) < 1e-4
    _close(v2, js.from_differential(jnp.asarray(u.numpy()), tol=1e-8,
                                    maxiter=500))
    assert 0 < ts.iterations <= 500


def test_smooth_steps():
    """A single-vertex displacement in the differential domain spreads
    smoothly over the neighbourhood, as the JAX package's does."""
    mesh = _mesh()
    js, ts = _pair(len(mesh.vertices), mesh.faces, lambda_=19.0)
    v = torch.as_tensor(mesh.vertices)
    u = ts.to_differential(v)
    spike = torch.zeros_like(u)
    spike[0, 2] = 1.0
    v2 = ts.from_differential(u + spike, tol=1e-8, maxiter=500)
    d = (v2 - v).abs()[:, 2].numpy()
    nb = ts.edges.numpy()
    neigh = np.unique(nb[(nb[:, 0] == 0) | (nb[:, 1] == 0)].ravel())
    neigh = neigh[neigh != 0]
    assert d[0] > d[neigh].mean() > 1e-6
    far = np.argmax(np.linalg.norm(mesh.vertices - mesh.vertices[0],
                                   axis=1))
    assert d[far] < d[0] * 0.2
    ju = js.to_differential(jnp.asarray(mesh.vertices))
    jv2 = js.from_differential(ju.at[0, 2].add(1.0), tol=1e-8, maxiter=500)
    _close(v2, jv2)


def test_optimization_recovers_offsets():
    """torch's Adam in the differential domain pulls a smoothly deformed
    sphere back to the target, with the losses of optax's Adam on the
    JAX package's solve."""
    mesh = _mesh()
    js, ts = _pair(len(mesh.vertices), mesh.faces)
    target = np.asarray(mesh.vertices)
    v0 = target * 1.35 + np.float32([0.2, -0.1, 0.05])

    jt = jnp.asarray(target)
    ju = js.to_differential(jnp.asarray(v0))
    opt = optax.adam(5e-2)
    state = opt.init(ju)
    lg = jax.jit(jax.value_and_grad(lambda u: jnp.mean(
        (js.from_differential(u, tol=1e-6, maxiter=100) - jt) ** 2)))
    tt = torch.as_tensor(target)
    u = ts.to_differential(torch.as_tensor(v0)).requires_grad_(True)
    topt = torch.optim.Adam([u], lr=5e-2)
    jl, tl = [], []
    for _ in range(60):
        loss, g = lg(ju)
        upd, state = opt.update(g, state)
        ju = optax.apply_updates(ju, upd)
        jl.append(float(loss))
        topt.zero_grad()
        tloss = torch.mean((ts.from_differential(u, tol=1e-6, maxiter=100)
                            - tt) ** 2)
        tloss.backward()
        topt.step()
        tl.append(tloss.item())
    assert tl[-1] < tl[0] * 0.5, (tl[0], tl[-1])
    np.testing.assert_allclose(tl, jl, rtol=1e-3)


@pytest.mark.parametrize("subdiv, lam", [(2, 19.0), (3, 4.0)])
def test_solve_and_gradient_match_jax_grad(subdiv, lam):
    """from_differential and its gradient (CG on the incoming gradient)
    against the JAX solve and jax.grad, on the liver proxy's mesh."""
    v, f, _, _ = liver_mesh(subdiv, 0)
    js, ts = _pair(len(v), f, lambda_=lam)
    rng = np.random.default_rng(subdiv)
    u = (v * 1.2 + rng.normal(0, 0.05, v.shape)).astype(np.float32)
    w = rng.normal(size=v.shape).astype(np.float32)

    def jloss(x):
        return jnp.sum(js.from_differential(x) * w)
    ut = torch.tensor(u, requires_grad=True)
    vt = ts.from_differential(ut)
    (vt * torch.as_tensor(w)).sum().backward()
    _close(vt, js.from_differential(jnp.asarray(u)))
    _close(ut.grad, jax.grad(jloss)(jnp.asarray(u)))
    assert ts.iterations > 0 and ts.backward_iterations > 0
