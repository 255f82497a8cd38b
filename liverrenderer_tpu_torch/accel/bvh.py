"""Host-side BVH construction (numpy, binned SAH).

Replaces the reference's acceleration backends (Embree scene_embree.inl /
native SAH kd-tree kdtree.h:2537 / OptiX scene_optix.inl) with a flattened
2-wide BVH whose traversal is a fixed-depth masked loop on device
(accel/intersect.py).  Built once at scene construction, host-side — the
build is latency-insensitive; only traversal is on the TPU hot path.

Layout: depth-first order; internal node i has left child i+1 and right
child right[i]; leaves have right[i] == -1 and prims [first, first+count)
in `perm` order.

The JAX package also has a C++ builder with the identical layout
(native/); the port builds with this numpy version only, so its leaf order
can differ from a natively built JAX scene's.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

N_BINS = 16
MAX_LEAF = 4
TRAVERSAL_COST = 1.0
INTERSECT_COST = 1.0


@dataclass
class BVHArrays:
    node_min: np.ndarray   # (Nn, 3) f32
    node_max: np.ndarray   # (Nn, 3) f32
    right: np.ndarray      # (Nn,) i32, -1 for leaves
    first: np.ndarray      # (Nn,) i32
    count: np.ndarray      # (Nn,) i32
    perm: np.ndarray       # (T,) i32 leaf order -> original tri index
    depth: int


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> BVHArrays:
    """Binned-SAH BVH over triangles given by their vertices (T,3) each."""
    T = len(v0)
    if T == 0:
        return BVHArrays(
            np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32),
            np.full(1, -1, np.int32), np.zeros(1, np.int32),
            np.zeros(1, np.int32), np.zeros(0, np.int32), 1)

    lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float64)
    hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float64)
    cen = 0.5 * (lo + hi)

    perm = np.arange(T, dtype=np.int64)
    node_min, node_max, right, first, count = [], [], [], [], []
    sys.setrecursionlimit(max(100000, sys.getrecursionlimit()))
    max_depth = [1]

    def area(blo, bhi):
        d = np.maximum(bhi - blo, 0)
        return (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                + d[..., 2] * d[..., 0])

    def recurse(s, e, dep):
        ni = len(right)
        node_min.append(None)
        node_max.append(None)
        right.append(-1)
        first.append(0)
        count.append(0)
        max_depth[0] = max(max_depth[0], dep)
        idx = perm[s:e]
        bmin = lo[idx].min(0)
        bmax = hi[idx].max(0)
        node_min[ni], node_max[ni] = bmin, bmax
        n = e - s
        if n <= MAX_LEAF:
            first[ni], count[ni] = s, n
            return ni

        cmin = cen[idx].min(0)
        cmax = cen[idx].max(0)
        ext = cmax - cmin
        axis = int(np.argmax(ext))

        if ext[axis] < 1e-12:
            # Degenerate centroid bounds: object-median split.
            mid = s + n // 2
        else:
            scale = N_BINS * (1.0 - 1e-7) / ext[axis]
            bins = np.minimum(((cen[idx, axis] - cmin[axis]) * scale)
                              .astype(np.int64), N_BINS - 1)
            bin_cnt = np.bincount(bins, minlength=N_BINS)
            bin_lo = np.full((N_BINS, 3), np.inf)
            bin_hi = np.full((N_BINS, 3), -np.inf)
            for b in np.unique(bins):
                m = bins == b
                bin_lo[b] = lo[idx[m]].min(0)
                bin_hi[b] = hi[idx[m]].max(0)
            l_lo = np.minimum.accumulate(bin_lo, 0)
            l_hi = np.maximum.accumulate(bin_hi, 0)
            r_lo = np.minimum.accumulate(bin_lo[::-1], 0)[::-1]
            r_hi = np.maximum.accumulate(bin_hi[::-1], 0)[::-1]
            l_cnt = np.cumsum(bin_cnt)
            r_cnt = np.cumsum(bin_cnt[::-1])[::-1]
            valid = (l_cnt[:-1] > 0) & (r_cnt[1:] > 0)
            cost = np.where(
                valid,
                area(l_lo[:-1], l_hi[:-1]) * l_cnt[:-1]
                + area(r_lo[1:], r_hi[1:]) * r_cnt[1:],
                np.inf)
            best = int(np.argmin(cost))
            parent_area = max(area(bmin, bmax), 1e-30)
            if np.isfinite(cost[best]):
                split_cost = TRAVERSAL_COST + cost[best] / parent_area
                if split_cost >= INTERSECT_COST * n and n <= 8 * MAX_LEAF:
                    first[ni], count[ni] = s, n
                    return ni
                in_left = bins <= best
                nl = int(in_left.sum())
                if nl == 0 or nl == n:
                    mid = s + n // 2
                else:
                    perm[s:e] = np.concatenate([idx[in_left], idx[~in_left]])
                    mid = s + nl
            else:
                order = np.argsort(cen[idx, axis], kind="stable")
                perm[s:e] = idx[order]
                mid = s + n // 2

        recurse(s, mid, dep + 1)
        right[ni] = recurse(mid, e, dep + 1)
        return ni

    recurse(0, T, 1)
    return BVHArrays(
        node_min=np.asarray(node_min, np.float32),
        node_max=np.asarray(node_max, np.float32),
        right=np.asarray(right, np.int32),
        first=np.asarray(first, np.int32),
        count=np.asarray(count, np.int32),
        perm=perm.astype(np.int32),
        depth=max_depth[0],
    )
