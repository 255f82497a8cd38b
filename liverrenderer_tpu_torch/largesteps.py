"""Large Steps in inverse geometry optimization (counterpart of
liverrenderer_tpu/largesteps.py; the reference's `mi.ad.LargeSteps`,
Nicolet et al. 2021).

Vertex positions v are reparameterized as u = (I + lambda L) v, with L
the combinatorial mesh Laplacian; a uniform-step optimizer on u takes
smooth, large, self-intersection-resistant steps in v.  The system
(I + lambda L) v = u is solved by conjugate gradients whose matvec is two
`index_add_`s over the edge list, with the semantics of
`jax.scipy.sparse.linalg.cg` (the JAX package's solver): x0 = u / diag,
stop when |r| <= tol |b| or after maxiter iterations.  The gradient of
the solve is the same CG on the incoming gradient (the matrix is
symmetric positive definite), from the same x0, as JAX's
`custom_linear_solve` runs it.
"""
from __future__ import annotations

import numpy as np
import torch


def _cg(matvec, b, x0, tol: float, maxiter: int):
    """Conjugate gradients from x0 -> (x, iterations); one host sync per
    iteration for the stopping test."""
    atol2 = tol * tol * torch.sum(b * b)
    x = x0
    r = b - matvec(x0)
    p = r
    gamma = torch.sum(r * r)
    k = 0
    while k < maxiter and bool(gamma > atol2):
        ap = matvec(p)
        alpha = gamma / torch.sum(p * ap)
        x = x + alpha * p
        r = r - alpha * ap
        gamma_new = torch.sum(r * r)
        p = r + (gamma_new / gamma) * p
        gamma = gamma_new
        k += 1
    return x, k


class _Solve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, ls, tol, maxiter):
        x0 = u / ls._diag[:, None]
        v, ls.iterations = _cg(ls._matvec, u, x0, tol, maxiter)
        ctx.ls, ctx.tol, ctx.maxiter = ls, tol, maxiter
        ctx.save_for_backward(x0)
        return v

    @staticmethod
    def backward(ctx, g):
        x0, = ctx.saved_tensors
        ls = ctx.ls
        gu, ls.backward_iterations = _cg(ls._matvec, g, x0, ctx.tol,
                                         ctx.maxiter)
        return gu, None, None, None


class LargeSteps:
    """Built from host-side mesh arrays (the vertex count sets the size;
    connectivity comes from the faces), on `device` (the card unless the
    caller passes device="cpu").  `iterations` and `backward_iterations`
    are the CG iterations of the last solve and of its gradient."""

    def __init__(self, n_vertices: int, faces: np.ndarray,
                 lambda_: float = 19.0, device="cuda"):
        f = np.asarray(faces, np.int64)
        e = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]],
                                    f[:, [2, 0]]]), axis=1)
        # the unique undirected edges in lexicographic order (np.unique
        # over rows, as the JAX package, through one int64 key per edge)
        n = max(n_vertices, int(e.max()) + 1)
        key = np.unique(e[:, 0] * n + e[:, 1])
        e = np.stack([key // n, key % n], 1)
        self.edges = torch.as_tensor(e, device=device)     # (E, 2)
        deg = np.bincount(e.ravel(), minlength=n_vertices)
        self.degree = torch.as_tensor(deg, dtype=torch.float32,
                                      device=device)
        self.n = n_vertices
        self.lambda_ = float(lambda_)
        self._diag = 1.0 + self.lambda_ * self.degree
        self.iterations = self.backward_iterations = None

    def _matvec(self, v):
        """(I + lambda (D - A)) v — two scatter-adds over the edge list."""
        a, b = self.edges[:, 0], self.edges[:, 1]
        neigh = torch.zeros_like(v).index_add(0, a, v[b]).index_add(0, b,
                                                                    v[a])
        return v * self._diag[:, None] - self.lambda_ * neigh

    def to_differential(self, v):
        """v -> u (latent) — mi.ad.LargeSteps.to_differential."""
        return self._matvec(v)

    def from_differential(self, u, tol: float = 1e-6, maxiter: int = 200):
        """u -> v by CG on the SPD system (mi.ad.LargeSteps
        .from_differential); differentiable in u."""
        return _Solve.apply(u, self, tol, maxiter)
