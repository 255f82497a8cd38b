"""The liver rendering pipeline (counterpart of
liverrenderer_tpu/pipeline/driver.py; the reference's LiverRenderer.py):
reads RendererSettings.yml (scene, resolution, spp, depth, tissue volume
fractions), computes the medium coefficients with prepare_medium, loads
the scene and writes the coefficients into its liver media's rows (in
place of LiverRenderer.py:81-289's rewrite of the XML on disk), renders,
and writes the EXR, a PNG and time.txt.

    python -m liverrenderer_tpu_torch.pipeline.driver settings.yml \\
        --scenes-dir scenes --out-dir out          # on the card
    python -m liverrenderer_tpu_torch.pipeline.driver settings.yml --cpu

Without a card and without --cpu it fails.  The default files follow the
reference repository's layout at the root of the checkout
(RendererSettings.yml, scenes/).
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_SETTINGS = str(_ROOT / "RendererSettings.yml")
DEFAULT_SCENES = str(_ROOT / "scenes")

SCENE_DIRS = {
    "Liver-SingleMesh": "Liver-SingleMesh/mitsuba3/scene.xml",
    "Liver-MultiMesh": "Liver-MultiMesh/mitsuba3/scene.xml",
    "GlissonCapsule": "GlissonCapsule/mitsuba3/scene.xml",
    "Parenchyma": "Parenchyma/mitsuba3/scene.xml",
    "SphereLiverConstEnv": "SphereLiverConstEnv/mitsuba3/scene.xml",
    "SphereLiverPoint": "SphereLiverPoint/mitsuba3/scene.xml",
    "SphereLiverCavityEnv": "SphereLiverCavityEnv/mitsuba3/scene.xml",
}

# RendererSettings.yml's tissue keys -> prepare_medium's
_REMAP = {"collagen_nMed": "collagen_n_med", "collagen_nP": "collagen_n_p",
          "elastin_nMed": "elastin_n_med", "elastin_nP": "elastin_n_p"}


def load_settings(path: str) -> dict:
    """RendererSettings.yml -> {scene, width, height, spp, max_depth,
    tissue} (read by `settings_yaml`, no YAML package needed)."""
    from .settings_yaml import load
    y = load(path)
    s = {
        "scene": y.get("Scene", "Liver-SingleMesh"),
        "width": int(y.get("Resolution", {}).get("Width", 1920)),
        "height": int(y.get("Resolution", {}).get("Height", 1080)),
        "spp": int(y.get("Samples Per Pixel", 256)),
        "max_depth": int(y.get("Max Depth", y.get("Max Depth ", 12))),
    }
    gc = y.get("Glisson Capsule", {}) or {}
    pa = y.get("Parenchyma", {}) or {}
    s["tissue"] = {_REMAP.get(k, k): v for k, v in {**gc, **pa}.items()}
    return s


def apply_medium_coefficients(scene, coeffs: dict):
    """The scene with the computed sigma_* values written into the rows
    of its liver, glissonCapsule and parenchyma media (the row layout of
    scene/builder.py and media/dispatch.py), on the scene's device."""
    import torch

    from ..scene.ir import MEDIUM_GLISSON, MEDIUM_LIVER, MEDIUM_PARENCHYMA
    params = scene.media.params
    prm = params.detach().cpu().numpy().copy()
    mtypes = scene.media.mtype.cpu().numpy()
    for i, mt in enumerate(mtypes):
        if mt not in (MEDIUM_GLISSON, MEDIUM_PARENCHYMA, MEDIUM_LIVER):
            continue
        for layer in range(4):
            for c, ch in enumerate("RGB"):
                prm[i, 12 + layer * 3 + c] = coeffs[
                    f"sigma_collagen{layer + 1}_{ch}"]
                prm[i, 24 + layer * 3 + c] = coeffs[
                    f"sigma_elastin{layer + 1}_{ch}"]
        if mt == MEDIUM_LIVER:
            prm[i, 40:43] = coeffs["sigma_blood"]
            prm[i, 43:46] = coeffs["sigma_bile"]
            prm[i, 3:6] = coeffs["sigma_lipid_water"]
            prm[i, 46] = coeffs["sigma_hepatocity"]
        elif mt == MEDIUM_PARENCHYMA:
            prm[i, 12:15] = coeffs["sigma_blood"]
            prm[i, 15:18] = coeffs["sigma_bile"]
            prm[i, 18:21] = coeffs["sigma_lipid_water"]
            prm[i, 21] = coeffs["sigma_hepatocity"]
    new = torch.as_tensor(prm, dtype=params.dtype, device=params.device)
    return scene.replace(media=scene.media.replace(params=new))


def run(settings_path: str = DEFAULT_SETTINGS,
        scenes_dir: str = DEFAULT_SCENES, out_dir: str = ".",
        spp: int | None = None, width: int | None = None,
        height: int | None = None, device: str = "cuda"):
    """Settings -> coefficients -> scene -> render -> <scene>.exr/.png and
    time.txt in out_dir; returns the (h, w, 3) image as numpy.  On the
    card unless device="cpu"."""
    import torch

    import liverrenderer_tpu_torch as lrt
    from ..log import log
    from .prepare_medium import compute_coefficients

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    s = load_settings(settings_path)
    if spp:
        s["spp"] = spp
    if width:
        s["width"] = width
    if height:
        s["height"] = height

    log(f"pipeline: scene={s['scene']} {s['width']}x{s['height']} "
        f"@{s['spp']}spp d{s['max_depth']} device={device}")
    coeffs = compute_coefficients(s["tissue"])
    log("computed medium coefficients "
        f"(collagen1_R={coeffs['sigma_collagen1_R']:.4f})")

    xml = os.path.join(scenes_dir, SCENE_DIRS[s["scene"]])
    t0 = time.time()
    scene = lrt.load_file(xml, device=device, res_width=s["width"],
                          res_height=s["height"], spp=s["spp"],
                          max_depth=s["max_depth"])
    scene = apply_medium_coefficients(scene, coeffs)
    sync()
    t1 = time.time()
    img = lrt.render(scene, spp=s["spp"], seed=0)
    sync()
    t2 = time.time()
    img = img.cpu().numpy()

    os.makedirs(out_dir, exist_ok=True)
    base = os.path.join(out_dir, s["scene"].lower())
    lrt.write_image(base + ".exr", img)
    lrt.write_image(base + ".png", img)
    with open(os.path.join(out_dir, "time.txt"), "w") as f:
        f.write(f"Scene: {s['scene']}\n")
        f.write(f"Resolution: {s['width']}x{s['height']}\n")
        f.write(f"SPP: {s['spp']}\n")
        f.write(f"Load time: {t1 - t0:.4f} s\n")
        f.write(f"Render time: {(t2 - t1) / 60.0:.4f} min\n")
    log(f"render {t2 - t1:.1f}s -> {base}.exr/.png")
    return img


def main(argv=None):
    ap = argparse.ArgumentParser(description="Liver rendering pipeline")
    ap.add_argument("settings", nargs="?", default=DEFAULT_SETTINGS)
    ap.add_argument("--scenes-dir", default=DEFAULT_SCENES)
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (default: the CUDA card)")
    a = ap.parse_args(argv)
    run(a.settings, a.scenes_dir, a.out_dir, a.spp, a.width, a.height,
        device="cpu" if a.cpu else "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
