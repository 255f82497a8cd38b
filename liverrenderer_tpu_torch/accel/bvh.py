"""Host-side BVH construction (binned SAH; counterpart of
liverrenderer_tpu/accel/bvh.py).

Replaces the reference's acceleration backends (Embree scene_embree.inl /
native SAH kd-tree kdtree.h:2537 / OptiX scene_optix.inl) with a flattened
2-wide BVH: its leaf order is the packed triangle buffer's order for the
closest-hit sweep, and accel/intersect._bvh_tris traverses it.

Layout: depth-first order; internal node i has left child i+1 and right
child right[i]; leaves have right[i] == -1 and prims [first, first+count)
in `perm` order.

Two builders with that layout: `build_bvh_numpy`, which every scene up to
NATIVE_MIN_TRIS triangles uses (so their leaf order, and every image
rendered from them, stays what it was), and the C++ build of
csrc/bvh_build.cpp (the port's copy of the JAX package's native builder)
for larger meshes, where the recursive numpy build takes minutes.  The C++
build is compiled at first use with the host C++ compiler into
build/torch_kernels and loaded with ctypes; a failed build raises.  Both
give the same nodes; the order of triangles inside a leaf can differ.
"""
from __future__ import annotations

import ctypes
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..host_build import BUILD_DIR, compile_shared

N_BINS = 16
MAX_LEAF = 4
TRAVERSAL_COST = 1.0
INTERSECT_COST = 1.0
# meshes above this many triangles take the C++ build
NATIVE_MIN_TRIS = 1 << 16

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "bvh_build.cpp"
_BUILD_DIR = BUILD_DIR
_LIB = None
# the compile's seconds, output and path, and the last build's seconds and
# triangles (chip_smoke.py reads them)
BUILD_INFO: dict = {}


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
    """Binned-SAH BVH over triangles given by their vertices (T,3) each:
    the C++ build past NATIVE_MIN_TRIS triangles, numpy below."""
    if len(v0) > NATIVE_MIN_TRIS:
        return build_bvh_native(v0, v1, v2)
    return build_bvh_numpy(v0, v1, v2)


def build_native():
    """Build (once per source hash) and load csrc/bvh_build.cpp; raises if
    the compiler fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    info = compile_shared(_SRC, _BUILD_DIR, "BVH build")
    lib = ctypes.CDLL(info["path"])
    p = ctypes.c_void_p
    lib.lrt_bvh_build.argtypes = [p, p, p, ctypes.c_int64, p, p, p, p, p, p,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_int32),
                                  ctypes.c_int64]
    lib.lrt_bvh_build.restype = ctypes.c_int
    BUILD_INFO.update(info)
    _LIB = lib
    return lib


def build_bvh_native(v0: np.ndarray, v1: np.ndarray,
                     v2: np.ndarray) -> BVHArrays:
    """The C++ binned-SAH build (csrc/bvh_build.cpp); its seconds go to
    BUILD_INFO["build_seconds"]."""
    lib = build_native()
    t0 = time.perf_counter()
    T = len(v0)
    cap = max(2 * T, 1)
    vs = [np.ascontiguousarray(v, np.float32).reshape(T, 3)
          for v in (v0, v1, v2)]
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    right = np.empty(cap, np.int32)
    first = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    perm = np.empty(max(T, 1), np.int32)
    n_nodes = ctypes.c_int64()
    depth = ctypes.c_int32()
    ptr = [a.ctypes.data for a in vs + [node_min, node_max, right, first,
                                        count, perm]]
    rc = lib.lrt_bvh_build(*ptr[:3], T, *ptr[3:], ctypes.byref(n_nodes),
                           ctypes.byref(depth), cap)
    if rc != 0:
        raise RuntimeError("BVH build: the node buffer overflowed")
    n = n_nodes.value
    out = BVHArrays(node_min[:n].copy(), node_max[:n].copy(),
                    right[:n].copy(), first[:n].copy(), count[:n].copy(),
                    perm[:T].copy(), depth.value)
    BUILD_INFO["build_seconds"] = time.perf_counter() - t0
    BUILD_INFO["build_tris"] = T
    return out


def build_bvh_numpy(v0: np.ndarray, v1: np.ndarray,
                    v2: np.ndarray) -> BVHArrays:
    """The recursive numpy build: the plain version the C++ build is held
    against, and the builder of every mesh up to NATIVE_MIN_TRIS."""
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
