"""Multi-GPU rendering over torch.distributed (counterpart of
liverrenderer_tpu/parallel/mesh.py, which shards over a JAX device mesh).

One process drives one device.  A `Mesh` is this process's place in a
torch.distributed world: its rank, the world size, its device and the
process group.  The pixel x spp wavefront is sharded by sample index:
rank d renders its slab of every pixel's samples with the counter RNG
keyed on the global (pixel, sample) pair, so a sample is the same
whichever rank draws it.  Scene and parameters are replicated; each rank
splats into a local film and one all-reduce merges the films.  The
gradient paths add one all-reduce of the parameter gradients.

Where the JAX package runs one SPMD program and masks whole dummy chunks
to keep it uniform, a rank here skips them and adds zeros to the
collective: every rank walks exactly the (pixel, sample) pairs that the
same JAX device walks.  Each per-rank body (`_local_pass`,
`_sharded_regen_tile`, `_local_replay_grad`, `_tiled_local`) is a plain
function of (rank, world size), so its ranks can also be run in turn in
one process and summed by hand; the public functions call the body and
then the collective.

    # each of N processes, rank r:
    init_distributed("host:port", num_processes=N, process_id=r)
    mesh = make_mesh()                    # the default group
    scene = lrt.load_dict(d)              # on this rank's card
    img = render_sharded(scene, mesh, spp=64)

Backends: NCCL for CUDA devices, gloo on the CPU; `init_distributed`
takes `backend=` to ask for another by name (gloo also all-reduces and
all-gathers CUDA tensors, which two ranks sharing one card need: NCCL
refuses two ranks on one device).
"""
from __future__ import annotations

import dataclasses
import datetime
import time

import torch
import torch.distributed as dist

from .. import film as film_mod
from ..core.rng import make_sampler
from ..integrators import prb_replay as pr
from ..integrators import regen as regen_mod
from ..integrators.common import _integrator_sample, render_pass
from ..integrators.regen import _render_regen_tile
from ..scene.ir import Scene
from ..sensor.perspective import sample_ray
from ..util import apply_params

AXIS = "dp"
# how long init_distributed waits for the other ranks to join
_INIT_TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the world: `rank` of `size` ranks, the
    device it renders on, and the process group its collectives use
    (None: a world of one that issues no collective)."""
    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    group: object = None


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """The mesh of the default process group when one is initialized
    (n_devices None or its world size), else a world of one.
    make_mesh(1) is always a world of one with no collective, this
    process alone (measure_scaling's single-device side).  `device`: the
    device this rank renders on; "cuda" means the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if n_devices == 1:
        return Mesh(0, 1, dev, None)
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_devices in (None, world):
            return Mesh(dist.get_rank(), world, dev, dist.group.WORLD)
    elif n_devices is None:
        return Mesh(0, 1, dev, None)
    raise ValueError(
        f"make_mesh({n_devices}): one process drives one device; start "
        f"{n_devices} processes and call init_distributed in each")


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device="cuda",
                     backend: str | None = None) -> None:
    """Join a world of `num_processes` ranks at tcp://`coordinator`
    ("host:port") as rank `process_id`; once per process, before
    make_mesh.  A no-op for one process, as in the JAX package.

    The backend is NCCL when `device` is a CUDA device ("cuda" picks
    card process_id % card count) and gloo on the CPU, or the one named
    by `backend`.  Raises when the device or the backend cannot start."""
    if not num_processes or num_processes <= 1:
        return
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device; pass "
                               "device='cpu' to join over gloo on the CPU")
        torch.cuda.set_device(dev.index if dev.index is not None
                              else process_id % torch.cuda.device_count())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("init_distributed: this PyTorch has no NCCL")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=_INIT_TIMEOUT)


# ---------------------------------------------------------------------------
# the collectives: every one of this module goes through _all_reduce or
# _all_gather, which collective_stats counts
# ---------------------------------------------------------------------------

_STATS: dict | None = None


def _record(kind: str, nbytes: int) -> None:
    if _STATS is not None:
        e = _STATS.setdefault(kind, {"ops": 0, "bytes": 0})
        e["ops"] += 1
        e["bytes"] += nbytes


def _all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum over the mesh, in place; no collective in a world of one
    without a group."""
    if mesh.group is not None:
        _record("all-reduce", t.numel() * t.element_size())
        dist.all_reduce(t, group=mesh.group)
    return t


def _all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(size,) + t.shape: every rank's t, in rank order."""
    if mesh.group is None:
        return t[None]
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    _record("all-gather", mesh.size * t.numel() * t.element_size())
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.stack(parts)


class _FilmAllReduce(torch.autograd.Function):
    """The film all-reduce under autograd.  Its backward passes each
    rank's cotangent through unchanged: every rank computes the same loss
    on the reduced film, so the sum all-reduce that a collective's own
    backward would apply counts the cotangent once per rank.  The one
    all-reduce of the parameter gradients afterwards sums the ranks'
    contributions."""

    @staticmethod
    def forward(ctx, acc, mesh):
        return _all_reduce(acc.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_reduce_grads(grads: list, mesh: Mesh) -> list:
    """One all-reduce of every gradient, flattened into one buffer."""
    if mesh.group is None or not grads:
        return grads
    flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh)
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    return out


def _tiles(scene: Scene):
    n_pix = scene.film_w * scene.film_h
    tile_pix = min(regen_mod.TILE_PIX, n_pix)
    return n_pix, tile_pix, (n_pix + tile_pix - 1) // tile_pix


# ---------------------------------------------------------------------------
# the fixed-wavefront sample-sharded render
# ---------------------------------------------------------------------------

def _local_pass(scene: Scene, seed, spp_local: int, mode: str, extra: int,
                rank: int, world: int):
    """Per-rank body: this rank's sample-index slab -> (h, w, 4) film.
    extra = spp % world: ranks below it render ONE more sample, global
    index world * spp_local + rank."""
    acc = None
    if spp_local > 0:
        acc = render_pass(scene, seed, spp_local, rank * spp_local, mode)
    if rank < extra:
        e = render_pass(scene, seed, 1, world * spp_local + rank, mode)
        acc = e if acc is None else acc + e
    if acc is None:
        acc = torch.zeros((scene.film_h, scene.film_w, 4),
                          device=scene.device)
    return acc


@torch.no_grad()
def render_sharded(scene: Scene, mesh: Mesh, spp: int | None = None,
                   seed: int = 0, mode: str = "primal"):
    """Distributed fixed-wavefront render -> (h, w, 3) on every rank,
    equal (up to summation order) to the single-device render of the same
    total spp.  Any spp: a remainder r = spp % size is one extra sample
    on the first r ranks."""
    spp = spp or scene.spp
    spp_local, r = divmod(spp, mesh.size)
    acc = _local_pass(scene, seed, spp_local, mode, r, mesh.rank, mesh.size)
    return film_mod.develop(_all_reduce(acc, mesh))


# ---------------------------------------------------------------------------
# the regenerating wavefront and the replay adjoint, sample-sharded
# ---------------------------------------------------------------------------

def _sharded_regen_tile(scene: Scene, seed, pix0: int, samp0_base: int,
                        n_valid: int, spp: int, tile_pix: int,
                        spp_local: int, rank: int):
    """Per-rank body: one regen wavefront over samples [samp0_base + rank
    * spp_local, ... + spp_local) of every pixel of a tile -> (tile_pix,
    4), or None for a rank at or past n_valid (the remainder's ranks
    without a sample), which renders nothing."""
    if rank >= n_valid:
        return None
    return _render_regen_tile(scene, seed, spp, pix0, tile_pix,
                              samp0=samp0_base + rank * spp_local,
                              spp_chunk=spp_local)


@torch.no_grad()
def render_regen_sharded(scene: Scene, mesh: Mesh, spp: int | None = None,
                         seed: int = 0):
    """Distributed regen render -> the (h, w, 4) accumulator on every rank:
    each rank walks spp // size samples of every pixel in one chunk per
    tile (the card has no watchdog to split it for), ranks below r = spp %
    size one more, and one all-reduce sums the films."""
    spp = spp or scene.spp
    n = mesh.size
    w, h = scene.film_w, scene.film_h
    n_pix, tile_pix, n_tiles = _tiles(scene)
    spp_local = spp // n
    spp_main, r = spp_local * n, spp % n
    film = torch.zeros((n_tiles * tile_pix, 4), device=scene.device)
    for t in range(n_tiles):
        part = film[t * tile_pix:(t + 1) * tile_pix]
        for base, n_valid, sl in ((0, n, spp_local), (spp_main, r, 1)):
            if sl and n_valid:
                f = _sharded_regen_tile(scene, seed, t * tile_pix, base,
                                        n_valid, spp, tile_pix, sl,
                                        mesh.rank)
                if f is not None:
                    part += f
    return _all_reduce(film, mesh)[:n_pix].view(h, w, 4)


def _local_replay_grad(scene: Scene, params, g_rgb, seed, pix0: int,
                       samp0_base: int, n_valid: int, spp: int,
                       tile_pix: int, spp_local: int, rank: int):
    """Per-rank body of the sharded replay adjoint: the stored forward and
    the replay walk over this rank's sample chunk -> {key: gradient}, or
    None for a rank at or past n_valid.  g_rgb (d loss / d accumulated
    rgb per film pixel) is the same on every rank."""
    if rank >= n_valid:
        return None
    samp0 = samp0_base + rank * spp_local
    keys, values = pr._leaves(scene, params)
    sc_det = pr._detach(apply_params(scene, dict(zip(keys, values))))
    _, pool_L = _render_regen_tile(sc_det, seed, spp, pix0, tile_pix,
                                   store_paths=True, samp0=samp0,
                                   spp_chunk=spp_local)
    return pr._tile_walk(scene, params, seed, g_rgb, pool_L, pix0, samp0,
                         spp, spp_local, tile_pix)


def render_grad_replay_sharded(scene: Scene, mesh: Mesh, params, loss_fn,
                               spp: int, seed: int = 0):
    """(loss, grads, image) through the sharded replay adjoint: one
    sharded regen primal for the loss image (film all-reduce), then per
    (pixel tile, spp chunk) each rank's stored forward and replay walk,
    and one all-reduce of the gradients.  Any spp: a remainder r = spp %
    size walks one more sample on the first r ranks.  A configuration
    outside prb_replay.replay_applicable raises ValueError (render_grad's
    scan adjoint serves it)."""
    if not pr.replay_applicable(scene, params, spp):
        raise ValueError(
            "render_grad_replay_sharded: configuration outside the replay "
            "adjoint's domain (see prb_replay.replay_applicable); use the "
            "scan adjoint (render_grad) for it")
    n = mesh.size
    keys, values = pr._leaves(scene, params)
    sc_det = pr._detach(apply_params(scene, dict(zip(keys, values))))
    acc = render_regen_sharded(sc_det, mesh, spp=spp, seed=seed)
    loss, image, g_rgb = pr._loss_from_acc(acc, loss_fn)

    n_pix, tile_pix, n_tiles = _tiles(scene)
    spp_main, r = (spp // n) * n, spp % n
    # each rank's chunk within the port's path-pool cap
    per = spp_main // n
    spp_local = max(1, min(per, pr.MAX_STORE_PATHS // tile_pix))
    while per % spp_local:
        spp_local -= 1
    n_chunks = per // spp_local
    grads = [torch.zeros_like(v) for v in values]

    def add(g):
        if g is not None:
            for i, k in enumerate(keys):
                grads[i] = grads[i] + g[k]

    for t in range(n_tiles):
        for c in range(n_chunks):
            add(_local_replay_grad(scene, params, g_rgb, seed, t * tile_pix,
                                   c * spp_local * n, n, spp, tile_pix,
                                   spp_local, mesh.rank))
        if r:
            add(_local_replay_grad(scene, params, g_rgb, seed, t * tile_pix,
                                   spp_main, r, spp, tile_pix, 1, mesh.rank))
    grads = _all_reduce_grads(grads, mesh)
    return loss, dict(zip(keys, grads)), image


# ---------------------------------------------------------------------------
# the pixel-sharded render
# ---------------------------------------------------------------------------

def _tiled_local(scene: Scene, seed, spp: int, mode: str, interleave: bool,
                 rank: int, world: int):
    """Per-rank body of render_tiled: this rank's rows at full spp ->
    (rows, w, 4) film slab, rows past the film zeroed.  Contiguous: rows
    [rank * rows, (rank + 1) * rows); interleaved: rows rank, rank +
    world, ...  The sampler stratifies the call's spp, as in the JAX
    package's render_tiled."""
    h, w = scene.film_h, scene.film_w
    dev = scene.device
    rows = (h + world - 1) // world
    lane = torch.arange(w * rows * spp, device=dev)
    pix_local = lane // spp
    row_local = pix_local // w
    py = row_local * world + rank if interleave else row_local + rank * rows
    px = pix_local % w
    sampler = make_sampler(py * w + px, lane % spp, seed,
                           kind=scene.sampler_kind, spp=spp)
    uf, sampler = sampler.next_2d()
    pos = torch.stack([px.to(torch.float32), py.to(torch.float32)], -1) + uf
    L, _, _ = _integrator_sample(scene, sampler, sample_ray(scene, pos),
                                 mode=mode)
    L = torch.where(torch.isfinite(L), L, 0.0)
    # splat into the slab: the film position rebased to this rank's rows
    pos_local = torch.stack(
        [pos[:, 0], row_local.to(torch.float32)
         + torch.remainder(pos[:, 1], 1.0)], -1)
    acc = film_mod.splat(w, rows, scene.rfilter, pos_local, L)
    # padded rows (global row >= h): values and weights zeroed, so the
    # develop of the assembled film sees no phantom samples
    lr = torch.arange(rows, device=dev)
    grow = lr * world + rank if interleave else rank * rows + lr
    return acc * (grow < h)[:, None, None]


@torch.no_grad()
def render_tiled(scene: Scene, mesh: Mesh, spp: int | None = None,
                 seed: int = 0, mode: str = "primal",
                 interleave: bool | None = None):
    """Pixel-sharded distributed render -> (h, w, 3) on every rank: each
    rank renders a horizontal slab at full spp, and one all-gather
    assembles the film.  Sample sharding (render_sharded) scales spp,
    pixel sharding scales film memory.

    interleave (default whenever the filter footprint is one pixel):
    rank d owns rows d, d + N, ..., which spreads an expensive image
    region over every rank; wider filters need contiguous slabs (their
    splat crosses row boundaries)."""
    spp = spp or scene.spp
    n = mesh.size
    one_pixel = film_mod.filter_radius(scene.rfilter) == 0
    if interleave is None:
        interleave = one_pixel
    if interleave and not one_pixel:
        raise ValueError("render_tiled: interleaved tiling needs a 1 px "
                         "filter footprint (box)")
    slabs = _all_gather(_tiled_local(scene, seed, spp, mode, interleave,
                                     mesh.rank, n), mesh)
    return film_mod.develop(_assemble(slabs, scene.film_h, interleave))


def _assemble(slabs, h: int, interleave: bool):
    """(n, rows, w, 4) slabs in rank order -> the (h, w, 4) film."""
    n, rows, w, c = slabs.shape
    if interleave:
        # rank-major (rank, local); image row local * n + rank
        slabs = slabs.permute(1, 0, 2, 3)
    return slabs.reshape(rows * n, w, c)[:h]


# ---------------------------------------------------------------------------
# measurement and the training step
# ---------------------------------------------------------------------------

def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_scaling(scene: Scene, n_devices: int | None = None,
                    spp: int = 16, seed: int = 0, reps: int = 3,
                    renderer: str = "pass") -> dict:
    """Wall-clock scaling proxy: a FIXED total workload on a world of one
    (rank 0 alone, the others waiting) and on the whole world;
    efficiency = t1 / (tN * N) when every rank has a device of its own.
    renderer="regen" times render_regen_sharded, "pass" render_sharded.

    When every rank shares one device (one CPU, or one card), the ideal
    is equal wall clock, and the reported ``efficiency_proxy`` = t1 / tN
    reads how well the ranks' host work overlaps (1.0: sharding costs
    nothing), as the JAX package reports for its virtual CPU mesh."""
    import socket

    meshN = make_mesh(n_devices, device=scene.device)
    mesh1 = make_mesh(1, device=scene.device)
    n = meshN.size

    def run(mesh, s):
        if renderer == "regen":
            return render_regen_sharded(scene, mesh, spp=spp, seed=s)
        return render_sharded(scene, mesh, spp=spp, seed=s)

    def timed(mesh):
        run(mesh, seed)
        _sync(scene.device)
        t0 = time.perf_counter()
        for i in range(reps):
            run(mesh, seed + 1 + i)
        _sync(scene.device)
        return (time.perf_counter() - t0) / reps

    t1 = timed(mesh1) if meshN.rank == 0 else 0.0
    place = (socket.gethostname(), str(scene.device))
    places = [place]
    if meshN.group is not None:
        box = [t1]
        dist.broadcast_object_list(box, src=0, group=meshN.group)
        t1 = box[0]
        places = [None] * n
        dist.all_gather_object(places, place, group=meshN.group)
    tn = timed(meshN)
    shared = len(set(places)) == 1
    eff = t1 / tn if shared else t1 / (tn * n)
    return {"n_devices": n, "t_1dev_s": t1, "t_ndev_s": tn,
            "efficiency_proxy" if shared else "efficiency": eff}


def collective_stats(fn, *args, **kwargs) -> dict:
    """Run fn(*args, **kwargs) and total what this module's collectives
    moved: {"all-reduce": {"ops", "bytes"}, "all-gather": ...} (the JAX
    package's keys; bytes of each result).  The JAX package parses the
    compiled program's HLO; here nothing is compiled, so the collectives
    are counted as they are issued.  A world of one without a group
    issues none."""
    global _STATS
    outer, _STATS = _STATS, {}
    try:
        fn(*args, **kwargs)
        return _STATS
    finally:
        _STATS = outer


def make_train_step(scene: Scene, mesh: Mesh, loss_fn, optimizer,
                    spp: int, mode: str = "ad"):
    """A distributed inverse-rendering step:
    step(params, opt_state, target, seed) -> (params, opt_state, loss).

    The JAX package's step is one jitted program over optax; this one
    keeps the signature's order in torch's idiom: `optimizer` is a
    torch.optim optimizer over the tensors of `params` (a dict of
    util.traverse keys to leaf tensors on the scene's device,
    requires_grad), which the step updates in place.  `opt_state`: a
    state_dict to load first, or None to keep the optimizer's own; the
    step returns optimizer.state_dict().  optax.sgd / optax.adam pair with
    torch.optim.SGD / torch.optim.Adam at the same lr, betas and eps.

    The step: this rank's sample slab of the forward fixed pass under
    autograd (`mode`), the film all-reduce (its backward passes the
    cotangent through), develop, loss_fn(image, target), backward, one
    all-reduce of the gradients, optimizer.step()."""
    spp_local, r = divmod(spp, mesh.size)

    def step(params, opt_state, target, seed):
        if opt_state is not None:
            optimizer.load_state_dict(opt_state)
        keys = list(params)
        leaves = [params[k] for k in keys]
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            sc = apply_params(scene, dict(zip(keys, leaves)))
            acc = _local_pass(sc, seed, spp_local, mode, r, mesh.rank,
                              mesh.size)
            img = film_mod.develop(_FilmAllReduce.apply(acc, mesh))
            loss = loss_fn(img, target)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(v) if g is None else g
                 for v, g in zip(leaves, grads)]
        for v, g in zip(leaves, _all_reduce_grads(grads, mesh)):
            v.grad = g
        optimizer.step()
        return params, optimizer.state_dict(), loss.detach()

    return step
