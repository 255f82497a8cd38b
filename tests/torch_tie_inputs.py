"""Inputs with exact ties for the closest-hit sweep (numpy only, no JAX).

Two families of triangles that rays hit at bitwise-equal t:
  A, plane z = +0.5: copies of one triangle and of a coplanar shifted one
     (same edges, so the same packed n and dn) in chunk 0 and in the middle
     and last chunks;
  B, plane z = -0.5: the same, first appearing in a middle chunk.
Every coordinate lies on a 1/64 grid, so pack_tris' re-centring and its
n, dn rows are exact and equal across a family.  The rest of the rows are
small filler triangles away from the rays.  Rays start at z = +-1 over the
overlap of each family and point across the plane with a small tilt; a
quarter of them are cut short by maxt before the plane.

The tie rule (larger id inside a 128-triangle chunk, earlier chunk across
chunks) makes the winner of a family the largest row of its first chunk;
`expected` gives it per ray (-1 for a cut ray).
"""
import numpy as np

TILE_T = 128


def _rows(T):
    a = [3, 70, T // 2, T - 2]
    a_shift = [100, T // 2 + 1]
    b = [T // 3 + 2, T // 3 + 3, T - 1]
    b_shift = [T // 3 + 4, 2 * T // 3]
    return a, a_shift, b, b_shift


def _winner(rows):
    first = min(r // TILE_T for r in rows)
    return max(r for r in rows if r // TILE_T == first)


def tie_inputs(T: int, R: int, seed: int):
    """(v0, v1, v2) (T, 3) f32 triangles and (o, d, maxt, expected) for R
    rays; T >= 300 so that the families' rows are distinct."""
    assert T >= 300
    rng = np.random.default_rng(seed)
    q = 1.0 / 64
    v0 = np.round(rng.uniform(4, 8, (T, 3)) / q) * q
    v1 = v0 + np.round(rng.uniform(0, 0.25, (T, 3)) / q) * q
    v2 = v0 + np.round(rng.uniform(0, 0.25, (T, 3)) / q) * q
    a, a_shift, b, b_shift = _rows(T)
    tri = np.array([[-1, -1], [3, -1], [-1, 3]], np.float64)
    for rows, dx, z in ((a, 0.0, 0.5), (a_shift, -0.5, 0.5),
                        (b, 0.0, -0.5), (b_shift, -0.5, -0.5)):
        for r in rows:
            for v, (x, y) in zip((v0, v1, v2), tri):
                v[r] = (x + dx, y, z)
    # rays: first half from above onto A, second half from below onto B
    h = R // 2
    o = np.empty((R, 3))
    o[:, :2] = rng.uniform(-0.5, 0.5, (R, 2))
    o[:h, 2], o[h:, 2] = 1.0, -1.0
    d = np.empty((R, 3))
    d[:, :2] = rng.uniform(-0.2, 0.2, (R, 2))
    d[:h, 2], d[h:, 2] = -1.0, 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cut = rng.uniform(size=R) < 0.25
    maxt = np.where(cut, 0.25, np.inf)
    expected = np.where(np.arange(R) < h, _winner(a + a_shift),
                        _winner(b + b_shift))
    expected = np.where(cut, -1, expected)
    f32 = np.float32
    return (v0.astype(f32), v1.astype(f32), v2.astype(f32), o.astype(f32),
            d.astype(f32), maxt.astype(f32), expected.astype(np.int64))


def pack_rays(o, d, maxt, center):
    """(8, R) f32 ray rows in pack_tris' local frame."""
    return np.ascontiguousarray(np.concatenate(
        [(o - center).T, d.T, maxt[None], np.zeros((1, len(o)))]),
        np.float32)
