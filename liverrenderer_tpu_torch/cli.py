"""Command-line renderer (counterpart of liverrenderer_tpu/cli.py; the
reference's `mitsuba` CLI):

    python -m liverrenderer_tpu_torch.cli scene.xml -o out.exr --spp 64
    python -m liverrenderer_tpu_torch.cli scene.xml --cpu   # no card

Loads the scene with -D parameter overrides, renders it on the card
(the CPU with --cpu; without a card and without --cpu it fails), writes
the EXR (and a PNG beside an .exr) or the named AOVs, and time.txt beside
the output in LiverRenderer.py's format; its last log line is a JSON
object of load_s, render_s and paths_per_s.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="liverrenderer_tpu_torch",
        description="PyTorch/CUDA renderer (mitsuba CLI analog)")
    ap.add_argument("scene", help="scene .xml file")
    ap.add_argument("-o", "--output", default=None,
                    help="output image (.exr/.png); default: scene dir")
    ap.add_argument("-D", "--define", action="append", default=[],
                    metavar="key=value", help="override a scene $parameter")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--integrator", default=None,
                    help="override the scene's integrator")
    ap.add_argument("--aovs", default=None,
                    help="comma-separated AOV names instead of radiance")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (default: the CUDA card)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="capture a torch.profiler trace (host ops and "
                         "the card's kernels) into DIR as a Chrome trace")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import liverrenderer_tpu_torch as lrt
    from .log import log

    device = "cpu" if args.cpu else "cuda"

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    overrides = {}
    for kv in args.define:
        k, _, v = kv.partition("=")
        overrides[k] = v
    if args.integrator:
        overrides["integrator"] = args.integrator

    t0 = time.time()
    scene = lrt.load_file(args.scene, device=device, **overrides)
    sync()
    log(f"loaded {args.scene} ({scene.n_tris} tris, "
        f"{scene.film_w}x{scene.film_h}, integrator={scene.integrator}, "
        f"device={device})")

    out = args.output
    if out is None:
        base = os.path.splitext(os.path.basename(args.scene))[0]
        out = os.path.join(os.path.dirname(os.path.abspath(args.scene)),
                           base + "_render.exr")

    t1 = time.time()
    trace_ctx = None
    if args.trace:
        from .log import device_trace
        trace_ctx = device_trace(args.trace)
        trace_ctx.__enter__()
    if args.aovs:
        aovs = lrt.render_aovs(scene, tuple(args.aovs.split(",")),
                               seed=args.seed)
        sync()
        for name, img in aovs.items():
            stem, ext = os.path.splitext(out)
            img = img.cpu().numpy()
            if img.ndim == 2:
                img = np.repeat(img[..., None], 3, -1)
            lrt.write_image(f"{stem}_{name}{ext}", img)
            log(f"wrote {stem}_{name}{ext}")
    else:
        img = lrt.render(scene, spp=args.spp, seed=args.seed)
        sync()
        img = img.cpu().numpy()
        lrt.write_image(out, img)
        if out.lower().endswith(".exr"):
            lrt.write_image(os.path.splitext(out)[0] + ".png", img)
        log(f"wrote {out}")
    if trace_ctx is not None:
        trace_ctx.__exit__(None, None, None)
    t2 = time.time()

    # LiverRenderer.py's time.txt
    spp = args.spp or scene.spp
    with open(os.path.join(os.path.dirname(os.path.abspath(out)),
                           "time.txt"), "w") as f:
        f.write(f"Scene: {os.path.basename(args.scene)}\n")
        f.write(f"Resolution: {scene.film_w}x{scene.film_h}\n")
        f.write(f"SPP: {spp}\n")
        f.write(f"Load time: {t1 - t0:.4f} s\n")
        f.write(f"Render time: {(t2 - t1) / 60.0:.4f} min\n")
    log(json.dumps({"load_s": round(t1 - t0, 3),
                    "render_s": round(t2 - t1, 3),
                    "paths_per_s": round(
                        scene.film_w * scene.film_h * spp / max(t2 - t1,
                                                                1e-9))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
