"""Progressive renderer (counterpart of liverrenderer_tpu/viewer.py; the
reference's realtime viewer, src/mitsuba/realtime.hpp:341-630
runRealtimeRenderer): per-frame renders with EMA accumulation, a plain
running average or a denoised display, a camera orbit, and a per-stage
timing report.  There is no display, so frames are written to disk or
handed to a callback.

    python -m liverrenderer_tpu_torch.viewer scene.xml --frames 8
    python -m liverrenderer_tpu_torch.viewer scene.xml --cpu   # no card

Frames stay tensors on the scene's device: the accumulation runs there,
and a frame is copied to the host (the "copy" phase) only when a write or
a callback needs it.
"""
from __future__ import annotations

import numpy as np
import torch


def _sync(device) -> None:
    """Wait for the card, so that a phase's wall time covers its work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_viewer(scene, n_frames: int = 16, spp: int = 1, mode: str = "ema",
               ema_alpha: float = 0.1, out_pattern: str | None = None,
               camera_orbit_deg: float = 0.0, frame_callback=None):
    """Render `n_frames` progressive frames.

    mode='ema': exponential moving average accumulation (realtime.hpp:379,
    506-516); mode='denoise': per-frame a-trous denoise guided by the
    albedo, normal and emission AOVs (the OptixDenoiser stand-in);
    mode='accum': plain running average.  frame_callback(frame, image)
    receives each frame as a host numpy (h, w, 3) array.  Returns the
    final frame, an (h, w, 3) tensor on the scene's device.
    """
    import liverrenderer_tpu_torch as lrt
    from .log import log, phase_report, scoped_phase
    from .scene.transform import Transform

    dev = scene.device
    acc = None
    aovs = None
    if mode == "denoise":
        with scoped_phase("aovs"):
            aovs = lrt.render_aovs(scene, ("albedo", "sh_normal",
                                           "emission"))

    for frame in range(n_frames):
        sc = scene
        if camera_orbit_deg:
            angle = camera_orbit_deg * frame / max(n_frames - 1, 1)
            rot = Transform().rotate([0, 1, 0], angle).matrix
            to_w = torch.as_tensor(rot, dtype=torch.float32, device=dev) \
                @ scene.sensor.to_world
            sc = scene.replace(sensor=scene.sensor.replace(to_world=to_w))
            # camera moved: restart accumulation (parameters_changed)
            acc = None

        with scoped_phase("render"):
            img = lrt.render(sc, spp=spp, seed=frame)
            _sync(dev)

        with scoped_phase("accumulate"):
            if mode == "ema":
                acc = img if acc is None else \
                    ema_alpha * img + (1.0 - ema_alpha) * acc
            elif mode == "accum":
                acc = img if acc is None else \
                    (acc * frame + img) / (frame + 1)
            else:  # denoise
                from .denoise import atrous_denoise
                acc = atrous_denoise(img, aovs["albedo"], aovs["sh_normal"],
                                     emission=aovs["emission"])
            _sync(dev)

        if out_pattern or frame_callback:
            with scoped_phase("copy"):
                host = acc.cpu().numpy()
        if out_pattern:
            with scoped_phase("write"):
                lrt.write_image(out_pattern.format(frame=frame), host)
        if frame_callback:
            frame_callback(frame, host)

    log(phase_report())
    return acc


@torch.no_grad()
def denoise(img, albedo=None, normal=None, radius: int = 3,
            sigma_s: float = 2.0, sigma_r: float = 0.2,
            sigma_n: float = 0.3):
    """AOV-guided joint-bilateral denoiser (the JAX package's stand-in for
    the reference's OptixDenoiser wrapper, optixdenoiser.cpp,
    Denoise.py): cross-bilateral weights from luminance distance, albedo
    and normal feature buffers.  Torch on the image's device (numpy
    input: the CPU); returns an (h, w, 3) float32 tensor."""
    img = torch.as_tensor(img, dtype=torch.float32)
    dev = img.device

    def guide(x):
        return None if x is None else torch.as_tensor(
            x, dtype=torch.float32, device=dev)

    albedo, normal = guide(albedo), guide(normal)
    h, w, _ = img.shape
    acc = torch.zeros_like(img)
    wsum = torch.zeros((h, w, 1), dtype=torch.float32, device=dev)
    lum = img.mean(-1, keepdim=True)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            sy = slice(max(dy, 0), h + min(dy, 0))
            sx = slice(max(dx, 0), w + min(dx, 0))
            ty = slice(max(-dy, 0), h + min(-dy, 0))
            tx = slice(max(-dx, 0), w + min(-dx, 0))
            # the spatial weight in double, as numpy's scalar exp gives it
            wgt_s = float(np.exp(-(dx * dx + dy * dy) / (2 * sigma_s ** 2)))
            d_lum = lum[ty, tx] - lum[sy, sx]
            wgt = wgt_s * torch.exp(-(d_lum ** 2) / (2 * sigma_r ** 2))
            if albedo is not None:
                d_a = ((albedo[ty, tx] - albedo[sy, sx]) ** 2).sum(
                    -1, keepdim=True)
                wgt = wgt * torch.exp(-d_a / (2 * sigma_r ** 2))
            if normal is not None:
                d_n = ((normal[ty, tx] - normal[sy, sx]) ** 2).sum(
                    -1, keepdim=True)
                wgt = wgt * torch.exp(-d_n / (2 * sigma_n ** 2))
            acc[ty, tx] += img[sy, sx] * wgt
            wsum[ty, tx] += wgt
    return acc / torch.clamp(wsum, min=1e-8)


def main(argv=None):
    """`python -m liverrenderer_tpu_torch.viewer scene.xml` — progressive
    render with frames written to ./frame_NNN.png (Denoise.py-style batch
    use: --mode denoise --frames 1); on the card unless --cpu, failing
    without one."""
    import argparse

    import liverrenderer_tpu_torch as lrt

    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--mode", choices=("ema", "accum", "denoise"),
                    default="ema")
    ap.add_argument("--orbit", type=float, default=0.0)
    ap.add_argument("--out", default="frame_{frame:03d}.png")
    ap.add_argument("-D", "--define", action="append", default=[])
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (default: the CUDA card)")
    a = ap.parse_args(argv)
    overrides = dict(kv.split("=", 1) for kv in a.define)
    scene = lrt.load_file(a.scene, device="cpu" if a.cpu else "cuda",
                          **overrides)
    run_viewer(scene, a.frames, a.spp, a.mode, out_pattern=a.out,
               camera_orbit_deg=a.orbit)
    return 0


if __name__ == "__main__":
    main()
