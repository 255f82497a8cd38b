#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (liverrenderer_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, one JSON line each (then the card line and the result line):
  device           card name and power limit (nvidia-smi), torch and CUDA
  build            nvcc build of csrc/intersect.cu and its seconds
  kernel_vs_plain  the closest-hit kernel against its plain PyTorch version
                   (a) on the 5,120-triangle liver proxy, 65,536 rays
                   (b) on ~100k random small triangles, 16,384 rays;
                   hit-set and prim agreement, max |dt|, median times
  render_small     the port's render through the kernel against the same
                   render on the CPU (plain version), per pixel
  render           the liver proxy at 428x240, 64 spp, depth 12, through
                   liverrenderer_tpu_torch.render: seconds, paths/s, image
                   checks and the kernel launches of this run
  kernels          every kernel of the path with the TPU kernels it
                   replaces, its launches, agreement and times
The last line is {"ok": true, "device": {...}}.  Any failed check exits
non-zero before it.  Without a CUDA device the script exits 2.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

WIDTH, HEIGHT, SPP, SUBDIV, SEED = 428, 240, 64, 4, 0

# tolerances: the kernel and its plain version run the same fp32
# operations in the same order (no FMA contraction), and differ only where
# the kernel's chunk culling drops a grazing hit that lies outside its
# chunk's box by a rounding error
HIT_AGREE_MIN = 0.9999
PRIM_AGREE_MIN = 0.99
T_RTOL = 1e-5
# render_small: the card's transcendentals differ from the CPU's by ulps,
# which can flip a rare dielectric / roulette decision of one path
PIX_RTOL, PIX_ATOL, PIX_FRAC_MIN, MEAN_RTOL = 1e-3, 1e-4, 0.99, 1e-3


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def cuda_ms(fn, reps: int, inner: int):
    """Median ms of one call, from CUDA events around `inner` calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / inner)
    out.sort()
    return out[len(out) // 2]


def compare_hits(tk, pk, tr, pr):
    hk, hr = pk >= 0, pr >= 0
    both = hk & hr
    same = both & (pk == pr)
    dt = (tk - tr).abs()[same]
    rel = (dt / tr.abs()[same].clamp(min=1e-30))
    return dict(
        n_rays=int(tk.numel()), hits=int(hr.sum()),
        hit_agree=float((hk == hr).float().mean()),
        prim_agree=float(same.sum()) / max(int(both.sum()), 1),
        max_abs_dt=float(dt.max()) if dt.numel() else 0.0,
        max_rel_dt=float(rel.max()) if rel.numel() else 0.0)


def check_agreement(r, what):
    check(r["hit_agree"] >= HIT_AGREE_MIN, f"{what}: hit sets {r}")
    check(r["prim_agree"] >= PRIM_AGREE_MIN, f"{what}: prims {r}")
    check(r["max_rel_dt"] <= T_RTOL, f"{what}: t {r}")


def kernel_vs_plain(torch, ci, rays, tris, boxes, reps_plain):
    tk, pk = ci.intersect_closest(rays, tris, boxes)
    tr, pr = ci.intersect_closest_reference(rays, tris, boxes)
    torch.cuda.synchronize()
    res = compare_hits(tk, pk, tr, pr)
    res["ms"] = cuda_ms(lambda: ci.intersect_closest(rays, tris, boxes),
                        reps=7, inner=10)
    res["plain_ms"] = cuda_ms(
        lambda: ci.intersect_closest_reference(rays, tris, boxes),
        reps=reps_plain, inner=1)
    return res


def proxy_rays(torch, scene, n_cam, n_in, gen):
    """Camera rays through random film positions, and rays from random
    points inside the liver with random directions; half of the interior
    rays are cut short by a finite maxt."""
    from liverrenderer_tpu_torch.sensor.perspective import sample_ray
    dev = scene.device
    pos = torch.rand((n_cam, 2), generator=gen, device=dev) \
        * torch.tensor([scene.film_w, scene.film_h], device=dev)
    cam = sample_ray(scene, pos)
    p = torch.randn((n_in, 3), generator=gen, device=dev)
    p = p / p.norm(dim=-1, keepdim=True) \
        * torch.rand((n_in, 1), generator=gen, device=dev) ** (1 / 3)
    o_in = p * torch.tensor([1.5, 0.9, 0.75], device=dev) * 0.8
    d_in = torch.randn((n_in, 3), generator=gen, device=dev)
    d_in = d_in / d_in.norm(dim=-1, keepdim=True)
    cut = torch.rand(n_in, generator=gen, device=dev) < 0.5
    maxt_in = torch.where(
        cut, torch.rand(n_in, generator=gen, device=dev) * 1.0 + 0.02,
        float("inf"))
    o = torch.cat([cam.o, o_in]) - scene.tri_center
    d = torch.cat([cam.d, d_in])
    maxt = torch.cat([cam.maxt, maxt_in])
    return torch.cat([o.T, d.T, maxt[None], torch.zeros_like(maxt)[None]],
                     0).contiguous()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import numpy as np
        import liverrenderer_tpu_torch as lrt
        from liverrenderer_tpu_torch.accel import cuda_intersect as ci
        from liverrenderer_tpu_torch.scene.liver_proxy import \
            liver_proxy_dict
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # ---- 2. build
    ci.build_kernel()
    ptxas = [ln.strip() for ln in ci.BUILD_INFO["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=round(ci.BUILD_INFO["seconds"], 3), ptxas=ptxas)

    # ---- 3. kernel against its plain version
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    scene = lrt.load_dict(liver_proxy_dict(WIDTH, HEIGHT, SPP, SUBDIV, SEED),
                          device="cuda")
    check(scene.n_tris == 5120, f"proxy has {scene.n_tris} triangles")
    rays = proxy_rays(torch, scene, 32768, 32768, gen)
    res_a = kernel_vs_plain(torch, ci, rays, scene.tri_buf, scene.tri_boxes,
                            reps_plain=5)
    emit("kernel_vs_plain", regime="K1 liver proxy", tris=scene.n_tris,
         **res_a)
    check_agreement(res_a, "liver proxy")

    rs = np.random.default_rng(SEED)
    T = 100_000
    v0 = rs.uniform(-1, 1, (T, 3)).astype(np.float32)
    v1 = v0 + rs.uniform(-0.05, 0.05, (T, 3)).astype(np.float32)
    v2 = v0 + rs.uniform(-0.05, 0.05, (T, 3)).astype(np.float32)
    buf, boxes, _, center = ci.pack_tris(v0, v1, v2)
    R = 16384
    o = rs.uniform(-2, 2, (R, 3)).astype(np.float32)
    aim = rs.uniform(-0.6, 0.6, (R, 3)).astype(np.float32)
    d = aim - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays_b = np.ascontiguousarray(np.concatenate(
        [(o - center).T, d.T, np.full((1, R), np.inf), np.zeros((1, R))]),
        np.float32)
    res_b = kernel_vs_plain(
        torch, ci, torch.from_numpy(rays_b).cuda(),
        torch.from_numpy(buf).cuda(), torch.from_numpy(boxes).cuda(),
        reps_plain=3)
    emit("kernel_vs_plain", regime="K2 ~100k triangles", tris=T,
         tpad=int(buf.shape[0]), **res_b)
    check_agreement(res_b, "100k triangles")
    check(res_b["hits"] > R // 4, f"100k cloud: only {res_b['hits']} hits")

    # ---- 4a. the render through the kernel against the CPU render
    small = liver_proxy_dict(16, 12, 4, 2, SEED)
    img_cpu = lrt.render(lrt.load_dict(small, device="cpu"), spp=4,
                         seed=SEED).numpy()
    img_gpu = lrt.render(lrt.load_dict(small, device="cuda"), spp=4,
                         seed=SEED).cpu().numpy()
    close = np.abs(img_gpu - img_cpu) <= PIX_ATOL + PIX_RTOL \
        * np.abs(img_cpu)
    frac = float(close.all(-1).mean())
    mean_rel = float(abs(img_gpu.mean() - img_cpu.mean())
                     / abs(img_cpu.mean()))
    emit("render_small", film=[16, 12], spp=4, tris=320, pixel_frac=frac,
         mean_rel=mean_rel, mean=float(img_gpu.mean()))
    check(frac >= PIX_FRAC_MIN and mean_rel <= MEAN_RTOL,
          "GPU render disagrees with the CPU render")

    # ---- 4b. the main path at full width
    torch.cuda.synchronize()
    ci.LAUNCHES = 0
    t0 = time.perf_counter()
    img = lrt.render(scene, spp=SPP, seed=SEED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ci.LAUNCHES
    finite = bool(torch.isfinite(img).all())
    paths = WIDTH * HEIGHT * SPP
    emit("render", film=[WIDTH, HEIGHT], spp=SPP, max_depth=scene.max_depth,
         tris=scene.n_tris, wavefront=1 << 16, seconds=round(secs, 3),
         paths_per_s=paths / secs, finite=finite,
         shape=list(img.shape), mean=float(img.mean()),
         corner=[float(x) for x in img[0, 0]], launches=launches)
    check(tuple(img.shape) == (HEIGHT, WIDTH, 3), "image shape")
    check(finite, "image has non-finite values")
    check(launches > 0, "the render did not launch the kernel")
    # the corner sees the constant white environment directly
    check(bool(torch.allclose(img[0, 0], torch.ones(3, device="cuda"))),
          "corner pixel is not the environment")
    check(0.05 < float(img.mean()) < 1.0, "image mean out of range")

    # ---- 5. kernels
    src = "liverrenderer_tpu_torch/csrc/intersect.cu"
    print(json.dumps({"kernels": [dict(
        name="intersect_closest", route="cuda", source=src,
        replaces="liverrenderer_tpu/accel/pallas_intersect.py:101",
        also_replaces="liverrenderer_tpu/accel/pallas_intersect.py:152",
        tpu_kernels=["K1 _intersect_kernel", "K2 _intersect_stream_kernel"],
        launches=launches, max_abs_err=res_a["max_abs_dt"],
        ms=res_a["ms"], plain_ms=res_a["plain_ms"],
        hit_agree=res_a["hit_agree"], prim_agree=res_a["prim_agree"],
        k2_max_abs_err=res_b["max_abs_dt"], k2_ms=res_b["ms"],
        k2_plain_ms=res_b["plain_ms"], k2_hit_agree=res_b["hit_agree"],
        k2_prim_agree=res_b["prim_agree"])]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
