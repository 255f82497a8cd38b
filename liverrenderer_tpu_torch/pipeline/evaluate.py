"""Evaluation of renders against the reference's goldens (counterpart of
liverrenderer_tpu/pipeline/evaluate.py; the reference's results.py as a
batch tool): renders each liver scene whose golden is in the scenes
directory, scores it by RMSE and SSIM (masked where the scene has a
mask), and writes results.json and side-by-side PNGs.

    python -m liverrenderer_tpu_torch.pipeline.evaluate --scenes-dir D \\
        --out-dir results                        # on the card
    python -m liverrenderer_tpu_torch.pipeline.evaluate ... --cpu

Without a card and without --cpu it fails.  A scene whose evaluation
raises gets an "error" row and the batch goes on (the tool's batch
semantics; the error is the row's result, nothing is rendered in its
place).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .driver import DEFAULT_SCENES

# scene xml -> (golden image, mask exr or None, opts), paths relative to
# the scenes directory.  EXR goldens compare in linear radiance; PNG
# goldens (the reference's committed Mitsuba3-CPU renders) compare in
# display (sRGB) space, both sides tonemapped identically.
#
# legacy_env: the GlissonCapsule and Parenchyma goldens were rendered
# before the envmap switch (pure white backgrounds), so those scenes are
# evaluated with the constant white environment restored.  The JAX
# package's CONFIGS (pipeline/evaluate.py) document each row's
# provenance; the rows here are the same.
CONFIGS = {
    "Liver-MultiMesh": ("Liver-MultiMesh/mitsuba3/scene.xml",
                        "Liver-MultiMesh/mitsuba3/scene.exr",
                        "Liver-MultiMesh/mitsuba3/LiverMask-MultiMesh.exr",
                        {}),
    # denoise_probe: also render at that (low) spp, denoise it with the
    # a-trous filter (denoise.py), and report noisy against denoised
    # metrics (the reference's results/OptixRSME.png analog)
    "Liver-SingleMesh": (
        "Liver-SingleMesh/mitsuba3/scene.xml",
        "Liver-SingleMesh/mitsuba3/outputs/Mitsuba3/CPU/liver-singlemesh.png",
        None, {"denoise_probe": 16}),
    "GlissonCapsule": (
        "GlissonCapsule/mitsuba3/scene.xml",
        "GlissonCapsule/mitsuba3/outputs/Mitsuba3/CPU/glissoncapsule.png",
        None, {"legacy_env": True}),
    # the golden was rendered from scene_temp.xml (prepare_medium's
    # per-channel sigmas) with the cavidade envmap and hide_emitters off
    "Parenchyma": (
        "Parenchyma/mitsuba3/scene_temp.xml",
        "Parenchyma/mitsuba3/outputs/Mitsuba/CPU/parenchyma.png",
        None, {"restore_envmap": True, "hide_emitters": False}),
    # the golden is scene_temp.xml's render (960x540, 16 spp, depth 12)
    "SphereLiverConstEnv": (
        "SphereLiverConstEnv/mitsuba3/scene_temp.xml",
        "SphereLiverConstEnv/mitsuba3/sphereliverconstenv.exr",
        None, {}),
    "SphereLiverPoint": (
        "SphereLiverPoint/mitsuba3/scene.xml",
        "SphereLiverPoint/mitsuba3/sphereliverpoint.exr",
        None, {}),
    # learned SSS against the vaescatter.cpp demo's golden, with the
    # fitted soap substitute (substitute.py) in place of the missing
    # soap_fine.obj: the background (pure envmap) is the parity
    # measurement, the object means are reported for the record
    "SphereLiverPoint-SSS": (
        "SphereLiverPoint/sss/scene.xml",
        "SphereLiverPoint/sss/scene.exr",
        None, {"substitute": "soap", "sss_report": True}),
}


def _clean_error(e: Exception, limit: int = 400) -> str:
    """A persistable error string: ANSI escapes, URL and compiler-log
    lines stripped, truncated."""
    import re
    txt = f"{type(e).__name__}: {e}"
    txt = re.sub(r"\x1b\[[0-9;]*m", "", txt)
    lines = [ln for ln in txt.splitlines()
             if not re.search(r"https?://|^[EWI]\d{4}|\.cc:\d", ln)]
    out = " ".join(" ".join(lines).split())
    return out[:limit] + ("…" if len(out) > limit else "")


def _subsurface_silhouette(scene) -> np.ndarray:
    """(h, w) bool mask of the pixels whose centre camera ray hits a
    shape with a subsurface attached: the object's exact silhouette."""
    import torch

    from ..accel.intersect import ray_intersect
    from ..core import math as m
    from ..sensor.perspective import sample_ray

    w, h = scene.film_w, scene.film_h
    px, py = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
    pos = torch.as_tensor(np.stack([px.ravel(), py.ravel()], -1),
                          dtype=torch.float32, device=scene.device)
    si = ray_intersect(scene, sample_ray(scene, pos))
    ss = m.table_lookup(scene.shape_subsurface,
                        torch.clamp(si.shape, min=0))
    return (si.valid & (ss >= 0)).reshape(h, w).cpu().numpy()


def _load_scene(path: str, opts: dict, w: int, h: int, spp: int,
                device="cuda"):
    from ..scene.builder import load_dict
    from ..scene.transform import Transform
    from ..scene.xml import parse_xml
    ov = {"res_width": w, "res_height": h, "spp": spp}
    if "integrator" in opts:
        ov["integrator"] = opts["integrator"]
    d = parse_xml(path, ov)
    if opts.get("legacy_env"):
        for k, v in list(d.items()):
            if isinstance(v, dict) and v.get("type") == "envmap":
                d[k] = {"type": "constant",
                        "radiance": {"type": "rgb", "value": [1.0] * 3}}
    if opts.get("restore_envmap"):
        # the cavidade envmap block commented out of the shipped XMLs
        # (scene.xml:68-76 in Parenchyma): the goldens were rendered with
        # it active
        for k, v in list(d.items()):
            if isinstance(v, dict) and v.get("type") in ("constant",
                                                         "envmap"):
                del d[k]
        d["env_restored"] = {
            "type": "envmap", "filename": "cavidade_latitude.exr",
            "scale": 2.5,
            "to_world": Transform().translate([-3, 3, 4])
            .rotate([0.57735, 0.57735, 0.57735], 180)}
    if "hide_emitters" in opts:
        d["integrator"]["hide_emitters"] = opts["hide_emitters"]
    if opts.get("substitute") == "soap":
        from .substitute import soap_mesh
        v, f, _ = soap_mesh()
        for k, val in list(d.items()):
            if isinstance(val, dict) and val.get("filename") == \
                    "soap_fine.obj":
                refs = {rk: rv for rk, rv in val.items()
                        if isinstance(rv, dict) and rv.get("type") == "ref"}
                d[k] = {"type": "mesh", "vertices": v, "faces": f, **refs}
    return load_dict(d, device=device,
                     base_dir=os.path.dirname(os.path.abspath(path)))


def evaluate(scenes_dir=DEFAULT_SCENES, out_dir=".", downsample=4, spp=64,
             scenes=None, merge=False, device="cuda"):
    """Evaluate the CONFIGS rows named in `scenes` (default: all) ->
    {name: entry}, also written to out_dir/results.json after each row;
    on the card unless device="cpu": without one it raises before the
    batch starts."""
    import torch

    from ..log import log

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("evaluate: no CUDA device; pass device='cpu' "
                           "(--cpu) to render on the CPU")
    os.makedirs(out_dir, exist_ok=True)
    table = {}
    rpath = os.path.join(out_dir, "results.json")
    if merge and os.path.exists(rpath):
        with open(rpath) as f:
            table = json.load(f)
    for name, (xml, golden, mask, opts) in CONFIGS.items():
        if scenes and name not in scenes:
            continue
        try:
            _eval_one(scenes_dir, out_dir, downsample, spp, table, name,
                      xml, golden, mask, opts, device)
        except Exception as e:             # noqa: BLE001 — one scene's
            # failure is its row's result; the batch goes on
            log(f"{name}: FAILED ({type(e).__name__}: {e})")
            table[name] = {"error": _clean_error(e)}
        with open(rpath, "w") as f:
            json.dump(table, f, indent=2)
    return table


def _dilate(msk):
    from numpy.lib.stride_tricks import sliding_window_view
    p = np.pad(msk, 2)
    return sliding_window_view(p, (5, 5)).any((-1, -2))


def _eval_one(scenes_dir, out_dir, downsample, spp, table, name, xml,
              golden, mask, opts, device):
    import torch

    import liverrenderer_tpu_torch as lrt
    from ..denoise import denoise_render
    from ..io.png import write_png
    from ..log import log
    from ..tonemap import tonemap
    from .results import rmse, ssim

    def render(scene, n_spp, seed):
        img = lrt.render(scene, spp=n_spp, seed=seed)
        if img.device.type == "cuda":
            torch.cuda.synchronize()
        return img.cpu().numpy()

    gpath = os.path.join(scenes_dir, golden)
    if not os.path.exists(gpath):
        log(f"{name}: golden missing, skipped")
        return
    is_ldr = gpath.lower().endswith(".png")
    # PNG goldens stay display-encoded; ours gets the same transfer
    g = lrt.read_image(gpath, srgb_to_linear=False)[..., :3]
    # crop to a downsample multiple (e.g. 540-row goldens at ds=8)
    gh = g.shape[0] - g.shape[0] % downsample
    gw = g.shape[1] - g.shape[1] % downsample
    g = g[:gh, :gw]
    h, w = gh // downsample, gw // downsample
    gd = g.reshape(h, downsample, w, downsample, 3).mean((1, 3))
    scene = _load_scene(os.path.join(scenes_dir, xml), opts, w, h, spp,
                        device)
    t0 = time.time()
    img_lin = render(scene, spp, 0)
    dt = time.time() - t0
    img = tonemap(img_lin) if is_ldr else img_lin
    m = None
    if mask and os.path.exists(os.path.join(scenes_dir, mask)):
        marr = lrt.read_image(os.path.join(scenes_dir, mask))[..., 0]
        mh = marr.shape[0] // h
        m = marr.reshape(h, mh, w, marr.shape[1] // w).mean((1, 3)) > 0.5
    a, b = np.clip(img, 0, 1), np.clip(gd, 0, 1)
    entry = {
        "rmse": rmse(a, b), "ssim": ssim(a, b),
        "render_s": round(dt, 2),
        "paths_per_s": round(w * h * spp / dt),
    }
    if m is not None:
        entry["rmse_masked"] = rmse(a, b, m)
        entry["ssim_masked"] = ssim(a, b, m)
    if opts.get("sss_report"):
        # the substitute-geometry row: the background, where both images
        # are pure envmap, and the object interiors' mean radiance; the
        # golden's object is its dark region, ours the camera rays' hits
        # on the subsurface shape
        lum_r = b @ np.array([0.2126, 0.7152, 0.0722])
        obj_r = lum_r < 0.02
        obj_o = _subsurface_silhouette(scene)
        bg = ~(_dilate(obj_r) | _dilate(obj_o))
        inter = obj_r & obj_o
        entry["substitute_mesh"] = True
        entry["silhouette_iou"] = round(
            float((obj_r & obj_o).sum() / max((obj_r | obj_o).sum(), 1)), 4)
        entry["rmse_background"] = rmse(a, b, bg)
        entry["ssim_background"] = ssim(a, b, bg)
        if inter.any():
            entry["obj_mean_ours"] = [round(float(x), 5)
                                      for x in a[inter].mean(0)]
            entry["obj_mean_ref"] = [round(float(x), 5)
                                     for x in b[inter].mean(0)]
    if opts.get("denoise_probe"):
        spp_lo = int(opts["denoise_probe"])
        img_lo = render(scene, spp_lo, 1)
        img_dn = denoise_render(scene, spp=spp_lo, seed=1).cpu().numpy()
        if is_ldr:
            img_lo, img_dn = tonemap(img_lo), tonemap(img_dn)
        lo = np.clip(img_lo, 0, 1)
        dn = np.clip(img_dn, 0, 1)
        entry["denoise"] = {
            "spp": spp_lo,
            "noisy_rmse": rmse(lo, b), "noisy_ssim": ssim(lo, b),
            "denoised_rmse": rmse(dn, b), "denoised_ssim": ssim(dn, b),
        }
    table[name] = entry
    if is_ldr:
        # display-encoded already: 8-bit quantisation, no sRGB step
        write_png(os.path.join(out_dir, f"{name.lower()}_ours.png"),
                  (a * 255 + 0.5).astype(np.uint8))
        write_png(os.path.join(out_dir, f"{name.lower()}_ref.png"),
                  (b * 255 + 0.5).astype(np.uint8))
    else:
        lrt.write_image(os.path.join(out_dir, f"{name.lower()}_ours.png"),
                        img)
        lrt.write_image(os.path.join(out_dir, f"{name.lower()}_ref.png"),
                        gd)
    log(f"{name}: rmse {entry['rmse']:.4f} ssim {entry['ssim']:.4f} "
        f"({dt:.1f}s)")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="render the liver scenes and score them against their "
                    "goldens")
    ap.add_argument("--scenes-dir", default=DEFAULT_SCENES)
    ap.add_argument("--out-dir", default="results")
    ap.add_argument("--downsample", type=int, default=4)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--scenes", default=None,
                    help="comma-separated subset of CONFIGS keys")
    ap.add_argument("--merge", action="store_true",
                    help="update rows in the existing results.json")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (default: the CUDA card)")
    a = ap.parse_args(argv)
    scenes = a.scenes.split(",") if a.scenes else None
    print(json.dumps(evaluate(a.scenes_dir, a.out_dir, a.downsample,
                              a.spp, scenes=scenes, merge=a.merge,
                              device="cpu" if a.cpu else "cuda"),
                     indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
