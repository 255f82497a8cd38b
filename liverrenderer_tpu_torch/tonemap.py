"""Tonemapping (counterpart of liverrenderer_tpu/tonemap.py; the
reference's src/python/python/tonemap.py): HDR -> LDR PNG with exposure,
gamma and Reinhard options, written through the port's own PNG encoder
with the JAX package's quantisation (no dither).

    python -m liverrenderer_tpu_torch.tonemap in.exr out.png --exposure 1.5
"""
from __future__ import annotations

import argparse

import numpy as np


def tonemap(img: np.ndarray, exposure: float = 0.0, gamma: float | None
            = None, reinhard: bool = False) -> np.ndarray:
    """Linear HDR -> display-encoded LDR in [0,1].  exposure in f-stops;
    gamma=None applies the sRGB transfer curve."""
    from .core.spectrum import linear_to_srgb_np
    x = np.asarray(img, np.float32) * (2.0 ** exposure)
    if reinhard:
        # luminance-normalized Reinhard operator
        lum = 0.212671 * x[..., 0] + 0.715160 * x[..., 1] \
            + 0.072169 * x[..., 2]
        x = x * (1.0 / (1.0 + lum))[..., None]
    x = np.clip(x, 0.0, None)
    out = linear_to_srgb_np(x) if gamma is None else x ** (1.0 / gamma)
    return np.clip(out, 0.0, 1.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description="HDR -> LDR tonemapper")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--exposure", type=float, default=0.0,
                    help="exposure in f-stops")
    ap.add_argument("--gamma", type=float, default=None,
                    help="gamma (default: sRGB curve)")
    ap.add_argument("--reinhard", action="store_true")
    a = ap.parse_args(argv)

    from .io.image import read_image
    from .io.png import write_png
    ldr = tonemap(read_image(a.input), a.exposure, a.gamma, a.reinhard)
    write_png(a.output, (ldr * 255 + 0.5).astype(np.uint8))
    print(f"wrote {a.output}")


if __name__ == "__main__":
    main()
