"""Edge-avoiding à-trous wavelet denoiser, SVGF-style, single frame
(counterpart of liverrenderer_tpu/denoise.py; the reference wraps NVIDIA's
OptiX denoiser, src/render/optixdenoiser.cpp and Denoise.py).

The same guide buffers drive a multi-iteration edge-avoiding à-trous
filter (Dammertz et al. 2010, with SVGF's variance-modulated luminance
weight, Schied et al. 2017):

  * a 5x5 B3-spline kernel dilated 2^i in iteration i;
  * edge-stopping weights: the luminance difference over a local
    variance estimate, the normals' dot product raised to a power, the
    albedo distance and, where given, the direct emission;
  * plain torch on the image's device (the JAX version is jnp, no
    kernel of its own).

    python -m liverrenderer_tpu_torch.denoise scene.xml -o out.exr --spp 16
"""
from __future__ import annotations

import sys

import torch

from .core.math import sqrt

# B3 spline taps
_B3 = torch.tensor([1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16])


def _shift2(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """x[y + dy, x + dx], clamped at the edges (no wrap-around ghosts)."""
    h, w = x.shape[0], x.shape[1]
    ys = torch.clamp(torch.arange(h, device=x.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=x.device) + dx, 0, w - 1)
    return x.index_select(0, ys).index_select(1, xs)


def _luminance(img: torch.Tensor) -> torch.Tensor:
    return (0.2126 * img[..., 0] + 0.7152 * img[..., 1]
            + 0.0722 * img[..., 2])


def _local_variance(lum: torch.Tensor) -> torch.Tensor:
    """3x3 local variance of luminance — the noise estimate when no
    per-pixel sample-moment buffer is available."""
    s1 = torch.zeros_like(lum)
    s2 = torch.zeros_like(lum)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            v = _shift2(lum, dy, dx)
            s1 = s1 + v
            s2 = s2 + v * v
    mean = s1 / 9.0
    return torch.clamp(s2 / 9.0 - mean * mean, min=0.0)


def _f32(x, device):
    return None if x is None else torch.as_tensor(
        x, dtype=torch.float32, device=device)


@torch.no_grad()
def atrous_denoise(img, albedo=None, normal=None, variance=None,
                   emission=None, iterations: int = 5, sigma_l: float = 4.0,
                   sigma_a: float = 0.15, sigma_n: float = 128.0):
    """Denoise an (h, w, 3) radiance image guided by AOV buffers, on the
    image's device (numpy input: the CPU).

    variance: optional (h, w) per-pixel luminance variance of the
    estimator (from render_moments); estimated locally when absent.
    emission: optional (h, w, 3) direct-emission AOV — blocks filtering
    across emitter silhouettes (a light edge looks like a firefly to the
    colour and variance weights; only a semantic guide tells them apart).
    Returns the filtered (h, w, 3) image.
    """
    img = torch.as_tensor(img, dtype=torch.float32)
    dev = img.device
    albedo = _f32(albedo, dev)
    normal = _f32(normal, dev)
    emission = None if emission is None else _luminance(_f32(emission, dev))

    # filter demodulated irradiance (SVGF): albedo texture detail is
    # re-applied afterwards, so it never blurs
    if albedo is not None:
        demod = torch.clamp(albedo, min=0.05)
        work = img / demod
    else:
        demod = None
        work = img

    lum0 = _luminance(work)
    if variance is None:
        var = _local_variance(lum0)
    else:
        var = _f32(variance, dev)
        if demod is not None:
            # variance was measured on the modulated radiance; rescale to
            # the demodulated space the filter operates in
            var = var / torch.clamp(_luminance(demod) ** 2, min=1e-4)

    taps = [(dy - 2, dx - 2, float(_B3[dy] * _B3[dx]))
            for dy in range(5) for dx in range(5)]
    if normal is not None:
        has_n = torch.sum(normal * normal, -1) > 1e-6

    out = work
    for it in range(iterations):
        step = 1 << it
        lum = _luminance(out)

        acc = torch.zeros_like(out)
        acc_v = torch.zeros_like(lum)
        wsum = torch.zeros_like(lum)
        for dy, dx, k in taps:
            sy, sx = dy * step, dx * step
            c = _shift2(out, sy, sx)
            l_q = _shift2(lum, sy, sx)
            # symmetric variance normalization: the max of both endpoints'
            # variance lets an outlier both accept its neighbours and be
            # accepted by them, so firefly energy is redistributed, not
            # destroyed
            v_q = _shift2(var, sy, sx)
            denom_l = sigma_l * sqrt(
                torch.clamp(torch.maximum(var, v_q), min=0.0)) + 1e-3
            w = k * torch.exp(-torch.abs(lum - l_q) / denom_l)
            if normal is not None:
                n_q = _shift2(normal, sy, sx)
                # environment pixels carry a zero normal: the power
                # weight is neutral for bg<->bg pairs and blocking for
                # bg<->surface
                has_q = torch.sum(n_q * n_q, -1) > 1e-6
                ndot = torch.clamp(torch.sum(normal * n_q, -1), 0.0, 1.0)
                w = w * torch.where(has_n & has_q, ndot ** sigma_n,
                                    (has_n == has_q).to(torch.float32))
            if albedo is not None:
                a_q = _shift2(albedo, sy, sx)
                d_a = torch.sum((albedo - a_q) ** 2, -1)
                w = w * torch.exp(-d_a / max(sigma_a, 1e-6))
            if emission is not None:
                e_q = _shift2(emission, sy, sx)
                d_e = torch.abs(emission - e_q) \
                    / (1.0 + torch.maximum(emission, e_q))
                w = w * torch.exp(-8.0 * d_e)
            acc = acc + c * w[..., None]
            acc_v = acc_v + v_q * w * w
            wsum = wsum + w
        out = acc / torch.clamp(wsum, min=1e-8)[..., None]
        var = acc_v / torch.clamp(wsum * wsum, min=1e-8)

    if demod is not None:
        out = out * demod
    return out


def estimator_variance(scene, spp: int, seed: int = 0):
    """(mean image, per-pixel luminance variance of the mean) from the
    sample moments (render_moments).  The right noise estimate for the
    edge-stopping weights: a directly visible emitter has high spatial
    contrast but near-zero sample variance, a noisy indirect pixel high
    sample variance."""
    from .integrators.aux import render_moments
    mean, m2 = render_moments(scene, spp=spp, seed=seed)
    var_rgb = torch.clamp(m2 - mean ** 2, min=0.0)
    var_lum = (0.2126 * var_rgb[..., 0] + 0.7152 * var_rgb[..., 1]
               + 0.0722 * var_rgb[..., 2])
    return mean, var_lum / max(spp, 1)


def denoise_render(scene, spp: int = 16, seed: int = 0, iterations: int = 5):
    """Render, AOVs, moment-based variance and denoise in one call (the
    Denoise.py batch analog) -> (h, w, 3) on the scene's device."""
    from .integrators.aux import render_aovs
    img, var = estimator_variance(scene, spp, seed)
    aovs = render_aovs(scene, ("albedo", "sh_normal", "emission"),
                       seed=seed)
    return atrous_denoise(img, aovs["albedo"], aovs["sh_normal"],
                          variance=var, emission=aovs["emission"],
                          iterations=iterations)


def main(argv=None):
    """Batch denoiser (the reference's Denoise.py workflow: load the
    scene, render with AOVs, denoise, write the EXR and a PNG beside it);
    on the card unless --cpu, failing without one."""
    import argparse

    ap = argparse.ArgumentParser(description="render + denoise a scene")
    ap.add_argument("scene")
    ap.add_argument("-o", "--output", default="denoised.exr")
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iterations", type=int, default=5)
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (default: the CUDA card)")
    a = ap.parse_args(argv)

    import liverrenderer_tpu_torch as lrt
    scene = lrt.load_file(a.scene, device="cpu" if a.cpu else "cuda")
    out = denoise_render(scene, spp=a.spp, seed=a.seed,
                         iterations=a.iterations).cpu().numpy()
    lrt.write_image(a.output, out)
    if a.output.lower().endswith(".exr"):
        lrt.write_image(a.output[:-4] + ".png", out)
    print(f"wrote {a.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
