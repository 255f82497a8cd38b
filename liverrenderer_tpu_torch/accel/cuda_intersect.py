"""Closest-hit ray x triangle sweep: host code, the CUDA kernels' wrappers
and their plain PyTorch versions (counterpart of
liverrenderer_tpu/accel/pallas_intersect.py).

The kernels (csrc/intersect.cu) replace both Pallas TPU kernels of the JAX
package, `_intersect_kernel` and `_intersect_stream_kernel`: a sweep kernel
that cuts the chunk range into splits over its grid's second dimension and
writes one partial closest hit per split and ray, and a merge kernel that
walks the splits in order (not launched when there is one split).  They are
built from the repository's source with nvcc at first use into
build/torch_kernels (keyed by a hash of the source; sm_90a, -O3,
FMA contraction on, no fast math) and bound with ctypes.

Layout contract, shared by the kernels, the plain version and the JAX
package:
  rays   (8, N)  f32 rows: ox oy oz dx dy dz maxt (row 7 unused)
  tris   (Tpad, 16) f32 Baldwin-Weber rows (pack_tris), Tpad % 128 == 0
  boxes  (Tpad/128, 8) f32 chunk AABBs
  ->     t (N,) f32 (inf = miss), prim (N,) int32 original triangle id
         (-1 = miss)
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

TILE_T = 128       # triangles per chunk (the kernel's shared-memory tile)
MAX_VMEM_TRIS = 65536
TRI_COLS = 16
# The JAX package pads buffers past MAX_VMEM_TRIS to whole SUPER_T blocks
# for its streaming kernel; the port keeps that padding so both packages
# pack identical buffers (padded chunks have empty boxes and are skipped).
SUPER_T = MAX_VMEM_TRIS
MAX_STREAM_TRIS = 1 << 21

_INF = float("inf")

# Kernel launches so far, sweep and merge (chip_smoke.py resets them and
# reads them back to show that a run went through the kernels); the SHADOW_
# counts are the part of them made for next-event shadow queries.
LAUNCHES = 0
MERGE_LAUNCHES = 0
SHADOW_LAUNCHES = 0
SHADOW_MERGE_LAUNCHES = 0
# Sweep blocks aimed for per call, in multiples of what the card holds at
# once; the chunk range is split until the grid reaches it (chosen by
# timing 2, 4, 8 and 16 on the card, PERF.md).
WAVES = 8

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "intersect.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_LIB = None
_CONFIG: dict = {}
BUILD_INFO: dict = {}


def bw_rows(v0, v1, v2):
    """Baldwin-Weber per-triangle rows (n, dn, r1, d1, r2, d2) from the
    three (T,3) vertex arrays (numpy, float64 in pack_tris)."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    nn = np.sum(n * n, -1)
    # degenerate or overflowing |n|^2: zero n too, so |n.d| > 1e-12 rejects
    ok = (nn > 0) & np.isfinite(nn)
    n = np.where(ok[:, None], n, 0.0)
    dn = np.sum(n * v0, -1)
    inv_nn = np.where(ok, 1.0 / np.where(ok, nn, 1.0), 0.0)
    r1 = np.cross(e2, n) * inv_nn[:, None]
    d1 = -np.sum(r1 * v0, -1)
    r2 = np.cross(n, e1) * inv_nn[:, None]
    d2 = -np.sum(r2 * v0, -1)
    return n, dn, r1, d1, r2, d2


def pack_tris(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              perm: np.ndarray | None = None):
    """Pack the (Tpad, 16) triangle buffer (Baldwin-Weber rows in float64,
    stored f32) in `perm` order (BVH leaf order) with per-chunk AABBs.
    Geometry is re-centred on the scene AABB midpoint so the rows keep fp32
    precision far from the origin; intersect_tris shifts ray origins by the
    same centre.  Returns (tri_buf, boxes, kernel_perm, center)."""
    T = len(v0)
    tpad = max(((T + TILE_T - 1) // TILE_T) * TILE_T, TILE_T)
    if tpad > MAX_VMEM_TRIS:
        tpad = ((tpad + SUPER_T - 1) // SUPER_T) * SUPER_T
    if perm is None:
        perm = np.arange(T, dtype=np.int64)
    v0o, v1o, v2o = v0[perm].astype(np.float64), \
        v1[perm].astype(np.float64), v2[perm].astype(np.float64)
    if T:
        allv = np.concatenate([v0o, v1o, v2o])
        center = 0.5 * (allv.min(0) + allv.max(0))
    else:
        center = np.zeros(3)
    v0o, v1o, v2o = v0o - center, v1o - center, v2o - center
    n, dn, r1, d1, r2, d2 = bw_rows(v0o, v1o, v2o)
    buf = np.zeros((tpad, TRI_COLS), np.float32)
    buf[:T, 0:3] = n
    buf[:T, 3] = dn
    buf[:T, 4:7] = r1
    buf[:T, 7] = d1
    buf[:T, 8:11] = r2
    buf[:T, 11] = d2
    # original triangle id in a padding column: the reduction yields ids
    buf[:T, 12] = perm.astype(np.float32)

    n_chunks = tpad // TILE_T
    boxes = np.zeros((n_chunks, 8), np.float32)
    boxes[:, 0:3] = np.inf          # empty chunks never pass the slab test
    boxes[:, 3:6] = -np.inf
    for c in range(n_chunks):
        lo, hi = c * TILE_T, min((c + 1) * TILE_T, T)
        if lo >= T:
            continue
        pts = np.concatenate([v0o[lo:hi], v1o[lo:hi], v2o[lo:hi]])
        boxes[c, 0:3] = pts.min(0)
        boxes[c, 3:6] = pts.max(0)
    kperm = np.full(tpad, -1, np.int32)
    kperm[:T] = perm
    return buf, boxes, kperm, center.astype(np.float32)


# ---------------------------------------------------------------------------
# Kernel build (nvcc -> plain C ABI .so, loaded with ctypes)
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("intersect kernel: no CUDA toolkit (nvcc) found")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build_kernel():
    """Build (once per source hash) and load the kernels' library from
    csrc/intersect.cu; raises if nvcc fails.  The build's seconds, ptxas
    report (empty when the library was already built) and path go to
    BUILD_INFO."""
    global _LIB
    if _LIB is not None:
        return _LIB
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _BUILD_DIR / f"intersect_{tag}.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC", "-o", tmp, str(_SRC)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError("intersect kernel: nvcc failed\n"
                               + res.stdout + res.stderr)
        log = res.stdout + res.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.lr_intersect_config.argtypes = [ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.lr_intersect_sweep.argtypes = [ptr, i, ptr, ptr, i, i, i, ptr, ptr,
                                       ptr]
    lib.lr_intersect_merge.argtypes = [ptr, ptr, i, i, ptr, ptr, ptr]
    for fn in (lib.lr_intersect_config, lib.lr_intersect_sweep,
               lib.lr_intersect_merge):
        fn.restype = ctypes.c_int
    BUILD_INFO.update(seconds=time.perf_counter() - t0, log=log,
                      path=str(so))
    _LIB = lib
    return lib


# ---------------------------------------------------------------------------
# The kernel's wrapper and its plain version
# ---------------------------------------------------------------------------

def _check(rays, tris, boxes):
    if rays.dim() != 2 or rays.shape[0] != 8:
        raise ValueError(f"rays must be (8, N), got {tuple(rays.shape)}")
    if tris.dim() != 2 or tris.shape[1] != TRI_COLS \
            or tris.shape[0] % TILE_T:
        raise ValueError(f"tris must be (Tpad, 16) with Tpad % {TILE_T} "
                         f"== 0, got {tuple(tris.shape)}")
    if tuple(boxes.shape) != (tris.shape[0] // TILE_T, 8):
        raise ValueError(f"boxes must be ({tris.shape[0] // TILE_T}, 8), "
                         f"got {tuple(boxes.shape)}")
    for name, x in (("rays", rays), ("tris", tris), ("boxes", boxes)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != rays.device:
            raise ValueError(f"{name} is on {x.device}, rays on "
                             f"{rays.device}")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"intersect {what} launch failed: CUDA error "
                           f"{err}")


def _launch(fn, device, what: str, *args):
    """Call a C launcher on `device`'s current stream (the tensors' card)
    and raise on the CUDA error it returns."""
    with torch.cuda.device(device):
        _raise_on(fn(*args, torch.cuda.current_stream().cuda_stream), what)


def split_plan(n: int, n_chunks: int, device):
    """(splits, chunks_per_split) for a sweep of n rays over n_chunks
    chunks: the chunk range is cut until the grid holds WAVES times the
    sweep blocks the card keeps resident (from the kernel's occupancy)."""
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _CONFIG:
        rpb, bps = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(idx):
            _raise_on(build_kernel().lr_intersect_config(
                ctypes.byref(rpb), ctypes.byref(bps)), "occupancy query")
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        _CONFIG[idx] = (rpb.value, bps.value * sms)
    rays_per_block, resident = _CONFIG[idx]
    blocks_x = max(-(-n // rays_per_block), 1)
    splits = min(n_chunks, max(1, -(-WAVES * resident // blocks_x)))
    per = -(-n_chunks // splits)
    return -(-n_chunks // per), per


def intersect_closest(rays: torch.Tensor, tris: torch.Tensor,
                      boxes: torch.Tensor, shadow: bool = False):
    """Closest hit of each ray over the packed triangle buffer ->
    (t (N,) f32, prim (N,) int32).  CUDA tensors launch the sweep kernel,
    and the merge kernel when the chunk range is split (or raise); CPU
    tensors take the plain version.  No gradient flows: the hit search is
    sampling geometry, re-derived differentiably in compute_si.  `shadow`
    marks a next-event shadow query: its launches also count in the
    SHADOW_ counts."""
    global LAUNCHES, SHADOW_LAUNCHES
    rays, tris, boxes = rays.detach(), tris.detach(), boxes.detach()
    _check(rays, tris, boxes)
    if rays.device.type == "cpu":
        return intersect_closest_reference(rays, tris, boxes)
    if rays.device.type != "cuda":
        raise ValueError(f"intersect_closest: unsupported device "
                         f"{rays.device}")
    for name, x in (("rays", rays), ("tris", tris), ("boxes", boxes)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, n_chunks = rays.shape[1], boxes.shape[0]
    splits, per = split_plan(n, n_chunks, rays.device)
    t_part = torch.empty((splits, n), dtype=torch.float32,
                         device=rays.device)
    prim_part = torch.empty((splits, n), dtype=torch.int32,
                            device=rays.device)
    _launch(build_kernel().lr_intersect_sweep, rays.device, "sweep",
            rays.data_ptr(), n, tris.data_ptr(), boxes.data_ptr(), n_chunks,
            per, splits, t_part.data_ptr(), prim_part.data_ptr())
    LAUNCHES += 1
    SHADOW_LAUNCHES += shadow
    if splits == 1:
        return t_part[0], prim_part[0]
    return merge_partials(t_part, prim_part, shadow)


def merge_partials(t_part: torch.Tensor, prim_part: torch.Tensor,
                   shadow: bool = False):
    """Closest of the (S, N) per-split partial hits, walking the splits in
    order with strict '<' (an earlier split keeps a tie) -> (t, prim).
    CUDA tensors launch the merge kernel (or raise); CPU tensors take the
    plain version."""
    global MERGE_LAUNCHES, SHADOW_MERGE_LAUNCHES
    if t_part.dim() != 2 or t_part.shape != prim_part.shape \
            or t_part.dtype != torch.float32 \
            or prim_part.dtype != torch.int32:
        raise ValueError("merge_partials takes (S, N) float32 t and int32 "
                         "prim partials")
    if t_part.device != prim_part.device:
        raise ValueError("merge_partials: partials on two devices")
    if t_part.device.type == "cpu":
        return merge_partials_reference(t_part, prim_part)
    if not (t_part.is_contiguous() and prim_part.is_contiguous()):
        raise ValueError("partials must be contiguous")
    splits, n = t_part.shape
    t = torch.empty(n, dtype=torch.float32, device=t_part.device)
    prim = torch.empty(n, dtype=torch.int32, device=t_part.device)
    _launch(build_kernel().lr_intersect_merge, t_part.device, "merge",
            t_part.data_ptr(), prim_part.data_ptr(), n, splits, t.data_ptr(),
            prim.data_ptr())
    MERGE_LAUNCHES += 1
    SHADOW_MERGE_LAUNCHES += shadow
    return t, prim


def merge_partials_reference(t_part: torch.Tensor, prim_part: torch.Tensor):
    """Plain PyTorch version of the merge kernel."""
    best_t, best_prim = t_part[0], prim_part[0]
    for s in range(1, t_part.shape[0]):
        got = t_part[s] < best_t
        best_t = torch.where(got, t_part[s], best_t)
        best_prim = torch.where(got, prim_part[s], best_prim)
    return best_t, best_prim


def intersect_closest_reference(rays: torch.Tensor, tris: torch.Tensor,
                                boxes: torch.Tensor):
    """Plain PyTorch version of the kernel: the same Baldwin-Weber sweep in
    the same operation order, over the same 128-triangle chunks with the
    same tie rule (larger id inside a chunk, strict '<' across chunks), and
    no culling (a culled chunk holds no hit, so results agree per ray).
    Several chunks are evaluated at once and merged in order."""
    n = rays.shape[1]
    ox, oy, oz, dx, dy, dz, maxt = (rays[i][None, :] for i in range(7))
    best_t = torch.full((n,), _INF, dtype=torch.float32, device=rays.device)
    best_prim = torch.full((n,), -1.0, dtype=torch.float32,
                           device=rays.device)
    n_chunks = tris.shape[0] // TILE_T
    group = max(1, min(n_chunks, (1 << 24) // max(TILE_T * n, 1)))
    for c0 in range(0, n_chunks, group):
        blk = tris[c0 * TILE_T:(c0 + group) * TILE_T]     # (G*128, 16)
        g = blk.shape[0] // TILE_T
        col = [blk[:, k:k + 1] for k in range(13)]        # (G*128, 1)
        nx, ny, nz, dn, r1x, r1y, r1z, d1, r2x, r2y, r2z, d2, ids = col
        ndir = nx * dx + ny * dy + nz * dz
        no = nx * ox + ny * oy + nz * oz
        ok = torch.abs(ndir) > 1e-12
        inv = torch.where(ok, 1.0 / ndir, 0.0)
        t = (dn - no) * inv
        px = ox + t * dx
        py = oy + t * dy
        pz = oz + t * dz
        u = r1x * px + r1y * py + r1z * pz + d1
        v = r2x * px + r2y * py + r2z * pz + d2
        # the running-best test (t < best_t) is applied at the merge: a
        # chunk minimum that fails it is exactly a chunk with no hit
        hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0) \
            & (t < maxt)
        t_m = torch.where(hit, t, _INF).view(g, TILE_T, n)
        t_min = t_m.amin(1)                                # (G, N)
        sel = t_m == t_min[:, None]
        prim_min = torch.where(sel, ids.view(g, TILE_T, 1), -1.0).amax(1)
        for k in range(g):
            got = t_min[k] < best_t
            best_prim = torch.where(got, prim_min[k], best_prim)
            best_t = torch.where(got, t_min[k], best_t)
    return best_t, best_prim.to(torch.int32)


# ---------------------------------------------------------------------------
# Host side of the query
# ---------------------------------------------------------------------------

def intersect_tris(tri_buf, boxes, kperm, o, d, maxt, t_best,
                   sort: bool = False, center=None, shadow: bool = False):
    """Closest hit over the packed (BVH-leaf-ordered) triangle buffer.
    Returns (t, prim, u, v) with prim == -1 for misses (original triangle
    ids); hits farther than `t_best` are rejected.  u, v are zeros: the
    winner's barycentrics are re-derived in compute_si.

    sort=True orders the wavefront by direction octant + origin Morton key
    before the query so blocks of rays are spatially coherent.

    Hit finding carries no derivative (the winner is re-derived
    differentiably in compute_si), so the rays are detached here: no
    autograd history reaches the kernel."""
    n = o.shape[0]
    o, d, maxt, t_best = o.detach(), d.detach(), maxt.detach(), \
        t_best.detach()
    lim = torch.minimum(torch.where(torch.isfinite(maxt), maxt, _INF),
                        t_best)
    if center is not None:
        o = o - center[None]            # local frame of pack_tris
    if sort:
        order = _coherence_order(o, d)
        o, d, lim = o[order], d[order], lim[order]
    rays = torch.cat([o.T, d.T, lim[None], torch.zeros_like(lim)[None]],
                     0).contiguous()
    t, prim = intersect_closest(rays, tri_buf, boxes, shadow=shadow)
    prim = prim.to(torch.int64)
    if sort:
        inv = torch.empty_like(order)
        inv[order] = torch.arange(n, device=order.device)
        t, prim = t[inv], prim[inv]
    miss = prim < 0
    zero = torch.zeros_like(t)
    return torch.where(miss, _INF, t), torch.where(miss, -1, prim), \
        zero, zero


def _coherence_order(o, d):
    """Sort key: 3-bit direction octant + 15-bit origin Morton code (32^3
    cells over the wavefront's bounding box)."""
    lo = o.amin(0)
    hi = o.amax(0)
    q = torch.clamp(((o - lo) / torch.clamp(hi - lo, min=1e-9) * 32.0)
                    .to(torch.int64), 0, 31)

    def spread(x):  # 5 bits -> every 3rd bit
        x = (x | (x << 8)) & 0x100F
        x = (x | (x << 4)) & 0x10C3
        x = (x | (x << 2)) & 0x1249
        return x

    morton = spread(q[:, 0]) | (spread(q[:, 1]) << 1) \
        | (spread(q[:, 2]) << 2)
    octant = ((d[:, 0] > 0).to(torch.int64)
              | ((d[:, 1] > 0).to(torch.int64) << 1)
              | ((d[:, 2] > 0).to(torch.int64) << 2))
    key = (octant << 15) | morton
    return torch.argsort(key, stable=True)
