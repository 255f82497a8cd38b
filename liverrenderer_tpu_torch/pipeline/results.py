"""Image-quality metrics: RMSE and SSIM with optional masks (counterpart
of liverrenderer_tpu/pipeline/results.py; the reference's results.py,
calculate_mse :68, calculate_ssim :76, masked variants in
resultsMasked/).  numpy float64, as in the JAX package.
"""
from __future__ import annotations

import numpy as np


def load(path: str) -> np.ndarray:
    from ..io.image import read_image
    return read_image(path)


def _mask2d(mask) -> np.ndarray:
    m = np.asarray(mask, bool)
    return m.any(-1) if m.ndim == 3 else m


def rmse(img: np.ndarray, ref: np.ndarray, mask: np.ndarray | None = None):
    """Root-mean-square error over (masked) pixels (results.py:68)."""
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    d2 = (img - ref) ** 2
    if mask is not None:
        d2 = d2[_mask2d(mask)]
    return float(np.sqrt(d2.mean()))


def ssim(img: np.ndarray, ref: np.ndarray, mask: np.ndarray | None = None,
         window: int = 7, k1: float = 0.01, k2: float = 0.03):
    """Structural similarity (Wang et al. 2004), mean over channels, with
    a uniform window (results.py:76 uses skimage's default
    parametrization); a mask keeps the windows whose centre it holds."""
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    if img.ndim == 2:
        img = img[..., None]
        ref = ref[..., None]
    data_range = max(ref.max() - ref.min(), 1e-9)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    k = window

    def box(x):
        # separable uniform filter, valid region only
        c = np.cumsum(x, axis=0)
        x = (c[k:] - c[:-k]) / k
        c = np.cumsum(x, axis=1)
        return (c[:, k:] - c[:, :-k]) / k

    vals = []
    for ch in range(img.shape[-1]):
        a, b = img[..., ch], ref[..., ch]
        mu_a, mu_b = box(a), box(b)
        s_aa = box(a * a) - mu_a ** 2
        s_bb = box(b * b) - mu_b ** 2
        s_ab = box(a * b) - mu_a * mu_b
        s = ((2 * mu_a * mu_b + c1) * (2 * s_ab + c2)) / \
            ((mu_a ** 2 + mu_b ** 2 + c1) * (s_aa + s_bb + c2))
        if mask is not None:
            m = _mask2d(mask)
            m = m[k // 2:m.shape[0] - (k - k // 2),
                  k // 2:m.shape[1] - (k - k // 2)]
            mh = min(m.shape[0], s.shape[0])
            mw = min(m.shape[1], s.shape[1])
            s = s[:mh, :mw][m[:mh, :mw]]
        vals.append(s.mean())
    return float(np.mean(vals))


def compare(img_path: str, ref_path: str, mask_path: str | None = None):
    """A render against its golden, from files -> {"rmse", "ssim"} (the
    results.py per-scene record); the mask is the first channel > 0.5."""
    img = load(img_path)
    ref = load(ref_path)
    if img.shape[:2] != ref.shape[:2]:
        raise ValueError(f"size mismatch {img.shape} vs {ref.shape}")
    mask = None
    if mask_path:
        mask = load(mask_path)[..., 0] > 0.5
    return {"rmse": rmse(img, ref, mask), "ssim": ssim(img, ref, mask)}
