"""Pillow 12.1's two quantisers (libImaging/Quant.c and QuantOctree.c), as
`Image.quantize` and `convert("P", palette=ADAPTIVE)` run them with 256
colours: median cut for RGB, fast octree for RGBA.  The loops run in C++
(csrc/quantize.cpp, built at first use by host_build.compile_shared; a
failed build raises, and nothing falls back); `_median_cut_plain` and
`_octree_plain` are their plain versions with the same contract.

Median cut.  The distinct colours are counted in a hash table that drops
one more low bit of every channel while it holds more than 65,536 keys
(the colour-precision reduction; Pillow's pixel hash is one-to-one on
8-bit triples, so a key is a colour at that precision).  The boxes of
colours split in a max-heap on their pixel count (QuantHeap.c's sift
order decides ties), each box along the channel of widest range weighted
77 / 150 / 29, at the colour where the count passes half, the colours
equal to it staying on the high side; a box of one colour is never split.
The leaves, left (high) before right, are the palette, each the rounded
mean of its full-precision pixels.  A pixel takes the nearest palette
colour found by scanning its own box's colour's neighbours in distance
order (ties by index) while they lie within four times its own box's
distance.

Fast octree.  A fine cube (3, 4, 3, 3 bits of R, G, B, A) and a coarse
one (2 bits each) of bucket counts and sums; the
palette is the used coarse buckets plus the most used fine buckets, the
fine ones subtracted from the coarse ones until no coarse bucket empties,
both sorted by count with ties by bucket order (glibc's stable qsort);
a bucket's colour is its float32 mean, truncated.  A pixel takes its fine
bucket's entry, else its coarse bucket's.  Transparent pixels first take
the colour of the first transparent pixel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "quantize.cpp"
_LIB = None

MAX_HASH_ENTRIES = 65536
COLORS = 256
# QuantOctree.c's CUBE_LEVELS for RGBA: fine (r, g, b, a) bits, coarse bits
_FINE, _COARSE = (3, 4, 3, 3), (2, 2, 2, 2)


def library():
    """Build (once per source hash) and load csrc/quantize.cpp; raises if
    the compiler fails."""
    global _LIB
    if _LIB is None:
        from ..host_build import BUILD_DIR, compile_shared
        info = compile_shared(_SRC, BUILD_DIR, "quantize")
        lib = ctypes.CDLL(info["path"])
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.lrt_median_cut.argtypes = [p, i64, p, p]
        lib.lrt_median_cut.restype = i32
        lib.lrt_octree.argtypes = [p, i64, p, p]
        lib.lrt_octree.restype = i32
        _LIB = lib
    return _LIB


def quantize(px: np.ndarray):
    """(H, W, 3) -> median cut, (H, W, 4) -> fast octree, as Pillow's
    quantize() -> (palette (n, 3 or 4) uint8, (H, W) uint8 indices).  An
    RGB palette has the entries median cut made; an RGBA one all 256
    entries of the octree."""
    px = np.ascontiguousarray(px, np.uint8)
    if px.ndim != 3 or px.shape[2] not in (3, 4) or px.size == 0:
        raise ValueError(f"quantize: {px.shape} pixels")
    h, w, c = px.shape
    flat = px.reshape(-1, c)
    idx = np.zeros(h * w, np.uint8)
    pal = np.zeros((256, c), np.uint8)
    lib = library()
    if c == 3:
        n = lib.lrt_median_cut(flat.ctypes.data, h * w, pal.ctypes.data,
                               idx.ctypes.data)
    else:
        n = lib.lrt_octree(flat.ctypes.data, h * w, pal.ctypes.data,
                           idx.ctypes.data)
    return pal[:n].copy(), idx.reshape(h, w)


def _quantize_plain(px: np.ndarray):
    """quantize's plain version."""
    px = np.asarray(px, np.uint8)
    h, w, c = px.shape
    flat = px.reshape(-1, c)
    if c == 3:
        pal, idx = _median_cut_plain(flat)
    else:
        pal, idx = _octree_plain(flat)
    return pal, idx.reshape(h, w)


# ------------------------------------------------------------ median cut ----
def _scale(px: np.ndarray) -> int:
    """The bits create_pixel_hash drops: the fewest that leave at most
    MAX_HASH_ENTRIES distinct colours."""
    for s in range(8):
        q = (px >> s).astype(np.int64)
        if len(np.unique(q[:, 0] << 16 | q[:, 1] << 8 | q[:, 2])) \
                <= MAX_HASH_ENTRIES:
            return s
    return 8


class _Box:
    __slots__ = ("idx", "count", "l", "r", "volume")

    def __init__(self, idx, count):
        self.idx, self.count = idx, count
        self.l = self.r = None
        self.volume = -1


def _heap_add(heap, box):
    """ImagingQuantHeapAdd with box_heap_cmp (a max-heap on the count)."""
    heap.append(box)
    k = len(heap) - 1
    while k != 1:
        if box.count - heap[k // 2].count <= 0:
            break
        heap[k] = heap[k // 2]
        k >>= 1
    heap[k] = box


def _heap_remove(heap):
    """ImagingQuantHeapRemove -> the top box, or None."""
    n = len(heap) - 1
    if n == 0:
        return None
    top = heap[1]
    v = heap.pop()
    n -= 1
    if n == 0:
        return top
    k = 1
    while k * 2 <= n:
        lo = k * 2
        if lo < n and heap[lo].count - heap[lo + 1].count < 0:
            lo += 1
        if v.count - heap[lo].count > 0:
            break
        heap[k] = heap[lo]
        k = lo
    heap[k] = v
    return top


def _median_cut_plain(px: np.ndarray):
    """(N, 3) uint8 -> (palette (n, 3) uint8, (N,) uint8 indices), as
    ImagingQuantize's median cut."""
    px = np.asarray(px, np.uint8)
    s = _scale(px)
    q = (px >> s).astype(np.int64)
    key = q[:, 0] << 16 | q[:, 1] << 8 | q[:, 2]
    ukey, inv, cnt = np.unique(key, return_inverse=True, return_counts=True)
    uq = np.stack([ukey >> 16, (ukey >> 8) & 255, ukey & 255], 1)
    root = _Box(np.arange(len(ukey)), len(px))
    heap = [None, root]
    for _ in range(COLORS - 1):
        while True:
            box = _heap_remove(heap)
            if box is None or _volume(box, uq) != 1:
                break
        if box is None:
            break
        _split(box, uq, cnt)
        _heap_add(heap, box.l)
        _heap_add(heap, box.r)
    leaf_of = np.zeros(len(ukey), np.int64)
    n = 0
    stack = [root]
    while stack:
        b = stack.pop()
        if b.l is not None:
            stack += [b.r, b.l]
        elif len(b.idx):
            leaf_of[b.idx] = n
            n += 1
    own = leaf_of[inv.reshape(-1)]
    num = np.bincount(own, minlength=n).astype(np.float64)
    pal = np.stack([(0.5 + np.bincount(own, px[:, c].astype(np.float64), n)
                     / num).astype(np.int64) for c in range(3)], 1)
    return pal.astype(np.uint8), _map_pixels(px, own, pal)


def _volume(box, uq) -> int:
    if box.volume < 0:
        v = uq[box.idx]
        box.volume = int(np.prod(v.max(0) - v.min(0) + 1))
    return box.volume


def _split(box, uq, cnt):
    """split + splitlists: the box's colours above and below the median
    of the widest weighted channel."""
    v = uq[box.idx]
    f = (v.max(0) - v.min(0)) * np.array([77, 150, 29])
    axis = int(np.argmax(f))
    vals = v[:, axis]
    levels, first = np.unique(-vals, return_inverse=True)
    sums = np.bincount(first, cnt[box.idx], len(levels))
    over = np.nonzero(np.cumsum(sums) * 2 > box.count)[0]
    g = int(over[0]) if len(over) else len(levels) - 1
    right = first > g
    if not right.any():
        right = vals == vals.min()
    left_idx, right_idx = box.idx[~right], box.idx[right]
    box.l = _Box(left_idx, int(cnt[left_idx].sum()))
    box.r = _Box(right_idx, int(cnt[right_idx].sum()))


def _dist(a, b):
    d = a.astype(np.int64)[:, None, :] - b.astype(np.int64)[None, :, :]
    return (d * d).sum(-1)


def _map_pixels(px, own, pal, chunk=4096):
    """map_image_pixels_from_median_box over the distinct colours."""
    n = len(pal)
    avg = _dist(pal, pal)
    order = np.argsort(avg, axis=1, kind="stable")
    rank = np.empty_like(order)
    np.put_along_axis(rank, order, np.arange(n)[None, :], 1)
    key = px.astype(np.int64) @ np.array([1 << 16, 1 << 8, 1])
    ukey, first, inv = np.unique(key, return_index=True, return_inverse=True)
    ucol, uown = px[first], own[first]
    best = np.empty(len(ukey), np.int64)
    for lo in range(0, len(ukey), chunk):
        c, o = ucol[lo:lo + chunk], uown[lo:lo + chunk]
        d = _dist(c, pal)
        rows = np.arange(len(c))
        d_own = d[rows, o]
        cand = avg[o] <= (d_own << 2)[:, None]
        m = np.where(cand, d, np.iinfo(np.int64).max).min(1)
        hit = cand & (d == m[:, None])
        pick = np.argmin(np.where(hit, rank[o], n), 1)
        best[lo:lo + chunk] = np.where(m < d_own, pick, o)
    return best[inv.reshape(-1)].astype(np.uint8)


# ------------------------------------------------------------ fast octree ----
def _bucket(px, bits):
    """color_bucket_offset of (N, 4) pixels in a cube of `bits`."""
    r, g, b, a = bits
    c = [px[:, i].astype(np.int64) >> (8 - bits[i]) for i in range(4)]
    return c[0] << (g + b + a) | c[1] << (b + a) | c[2] << a | c[3]


def _coords(bits):
    """Every bucket's (r, g, b, a) coordinates, in bucket order."""
    r, g, b, a = bits
    i = np.arange(1 << (r + g + b + a))
    return np.stack([i >> (g + b + a), (i >> (b + a)) & ((1 << g) - 1),
                     (i >> a) & ((1 << b) - 1), i & ((1 << a) - 1)], 1)


def _shrink(fine, coarse):
    """copy_color_cube from the fine cube's bucket order to the coarse
    cube's -> the coarse bucket of each fine bucket."""
    c = _coords(fine) >> (np.array(fine) - np.array(coarse))
    r, g, b, a = coarse
    return c[:, 0] << (g + b + a) | c[:, 1] << (b + a) | c[:, 2] << a | c[:, 3]


def _avg(count, sums):
    """avg_color_from_color_bucket: float32 mean, truncated, clipped."""
    cf = count.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        m = sums.astype(np.float32) / cf[:, None]
    m = np.where(count[:, None] > 0, m, 0)
    return np.clip(np.trunc(m), 0, 255).astype(np.int64)


def _octree_plain(px: np.ndarray):
    """(N, 4) uint8 -> (palette (256, 4) uint8, (N,) uint8 indices), as
    ImagingQuantize's fast octree on RGBA."""
    px = np.array(px, np.uint8)
    clear = np.nonzero(px[:, 3] == 0)[0]
    if len(clear):
        px[clear, :3] = px[clear[0], :3]
    fine_bits, coarse_bits = _FINE, _COARSE
    fb = _bucket(px, fine_bits)
    nf = 1 << sum(fine_bits)
    f_cnt = np.bincount(fb, minlength=nf).astype(np.int64)
    f_sum = np.stack([np.bincount(fb, px[:, c].astype(np.float64), nf)
                      for c in range(4)], 1).astype(np.int64)
    to_coarse = _shrink(fine_bits, coarse_bits)
    nc = 1 << sum(coarse_bits)
    c_cnt = np.bincount(to_coarse, f_cnt, nc).astype(np.int64)
    c_sum = np.stack([np.bincount(to_coarse, f_sum[:, c], nc)
                      for c in range(4)], 1).astype(np.int64)
    n_coarse = min(int((c_cnt > 0).sum()), COLORS)
    n_fine = COLORS - n_coarse
    f_order = np.argsort(-f_cnt, kind="stable")
    f_avg = _avg(f_cnt[f_order], f_sum[f_order])
    f_home = _bucket(f_avg, coarse_bits)

    def subtract(lo, hi):
        for i in range(lo, hi):
            if f_cnt[f_order[i]]:
                c_cnt[f_home[i]] -= f_cnt[f_order[i]]
                c_sum[f_home[i]] -= f_sum[f_order[i]]

    subtract(0, n_fine)
    while n_coarse > int((c_cnt > 0).sum()):
        done = n_fine
        n_coarse = int((c_cnt > 0).sum())
        n_fine = COLORS - n_coarse
        subtract(done, n_fine)
    c_order = np.argsort(-c_cnt, kind="stable")
    pal_cnt = np.concatenate([c_cnt[c_order[:n_coarse]],
                              f_cnt[f_order[:n_fine]]])
    pal_sum = np.concatenate([c_sum[c_order[:n_coarse]],
                              f_sum[f_order[:n_fine]]])
    pal = _avg(pal_cnt, pal_sum)
    coarse_lut = np.zeros(nc, np.int64)
    for i in range(n_coarse - 1, -1, -1):
        coarse_lut[_bucket(pal[i:i + 1], coarse_bits)[0]] = i
    lut = coarse_lut[to_coarse]
    for i in range(n_coarse + n_fine - 1, n_coarse - 1, -1):
        lut[_bucket(pal[i:i + 1], fine_bits)[0]] = i
    return pal.astype(np.uint8), lut[fb].astype(np.uint8)
