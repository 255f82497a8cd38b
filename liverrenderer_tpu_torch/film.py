"""Film accumulation: filtered sample splatting + develop (counterpart of
liverrenderer_tpu/film.py) for the box, tent, gaussian, mitchell,
catmullrom and lanczos filters.  Splats are index_add_ scatter-adds into
an (h*w, 4) RGB+weight accumulator, one per pixel of the filter's
footprint: 1, 4, 16, 16, 16 and 36 per sample."""
from __future__ import annotations

import math

import torch

from .scene.ir import (FILTER_BOX, FILTER_CATMULLROM, FILTER_GAUSSIAN,
                       FILTER_LANCZOS, FILTER_MITCHELL, FILTER_TENT)

# footprint radius in pixels: the splat visits (2 r)^2 pixel centres
_RADIUS = {FILTER_BOX: 0, FILTER_TENT: 1, FILTER_GAUSSIAN: 2,
           FILTER_MITCHELL: 2, FILTER_CATMULLROM: 2, FILTER_LANCZOS: 3}


def filter_radius(rfilter: int) -> int:
    return _RADIUS[rfilter]


def _mitchell_1d(x, B, C):
    """Mitchell-Netravali kernel (mitchell.cpp; catmullrom.cpp is B = 0,
    C = 0.5)."""
    x = torch.abs(x)
    x2, x3 = x * x, x * x * x
    near = ((12.0 - 9.0 * B - 6.0 * C) * x3
            + (-18.0 + 12.0 * B + 6.0 * C) * x2 + (6.0 - 2.0 * B)) / 6.0
    far = ((-B - 6.0 * C) * x3 + (6.0 * B + 30.0 * C) * x2
           + (-12.0 * B - 48.0 * C) * x + (8.0 * B + 24.0 * C)) / 6.0
    return torch.where(x < 1.0, near, torch.where(x < 2.0, far, 0.0))


def _lanczos_1d(x, tau=3.0):
    """Lanczos-windowed sinc (lanczos.cpp, tau = 3)."""
    x = torch.abs(x)
    pix = math.pi * torch.clamp(x, min=1e-6)
    sinc = torch.sin(pix) / pix
    wind = torch.sin(pix / tau) / (pix / tau)
    w = torch.where(x < 1e-6, 1.0, sinc * wind)
    return torch.where(x < tau, w, 0.0)


def _filter_weight(rfilter: int, dx, dy):
    if rfilter == FILTER_MITCHELL:
        return _mitchell_1d(dx, 1 / 3, 1 / 3) * _mitchell_1d(dy, 1 / 3, 1 / 3)
    if rfilter == FILTER_CATMULLROM:
        return _mitchell_1d(dx, 0.0, 0.5) * _mitchell_1d(dy, 0.0, 0.5)
    if rfilter == FILTER_LANCZOS:
        return _lanczos_1d(dx) * _lanczos_1d(dy)
    if rfilter == FILTER_GAUSSIAN:
        # gaussian.cpp: std 0.5, truncated at 4 std = 2 px
        std = 0.5
        alpha = -1.0 / (2.0 * std * std)
        cut = math.exp(alpha * 2.0 * 2.0)
        wx = torch.clamp(torch.exp(alpha * dx * dx) - cut, min=0.0)
        wy = torch.clamp(torch.exp(alpha * dy * dy) - cut, min=0.0)
        return wx * wy
    return torch.clamp(1.0 - torch.abs(dx), min=0.0) \
        * torch.clamp(1.0 - torch.abs(dy), min=0.0)


def splat(w: int, h: int, rfilter: int, pos, value):
    """pos (N,2) continuous film coords, value (N,3) -> (h, w, 4)."""
    img = torch.zeros((h * w, 4), device=value.device)
    ones = torch.ones(value.shape[:-1] + (1,), device=value.device)
    r = filter_radius(rfilter)
    if r == 0:
        px = torch.clamp(pos[..., 0].to(torch.int64), 0, w - 1)
        py = torch.clamp(pos[..., 1].to(torch.int64), 0, h - 1)
        img.index_add_(0, py * w + px, torch.cat([value, ones], -1))
        return img.view(h, w, 4)
    # the pixel centres around the sample
    cx = pos[..., 0] - 0.5
    cy = pos[..., 1] - 0.5
    bx = torch.floor(cx).to(torch.int64)
    by = torch.floor(cy).to(torch.int64)
    for oy in range(-r + 1, r + 1):
        for ox in range(-r + 1, r + 1):
            px = bx + ox
            py = by + oy
            wgt = _filter_weight(rfilter, px.to(torch.float32) - cx,
                                 py.to(torch.float32) - cy)
            inside = (px >= 0) & (px < w) & (py >= 0) & (py < h)
            wgt = torch.where(inside, wgt, 0.0)
            idx = torch.clamp(py, 0, h - 1) * w + torch.clamp(px, 0, w - 1)
            img.index_add_(0, idx,
                           torch.cat([value * wgt[..., None],
                                      wgt[..., None]], -1))
    return img.view(h, w, 4)


def develop(acc):
    """Weight-divide the accumulator -> (h, w, 3)."""
    wch = acc[..., 3:4]
    return torch.where(wch > 0, acc[..., 0:3] / torch.clamp(wch, min=1e-12),
                       0.0)
