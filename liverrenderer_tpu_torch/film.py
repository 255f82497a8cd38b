"""Film accumulation: filtered sample splatting + develop (counterpart of
liverrenderer_tpu/film.py) for the box and tent filters.  Splats are
index_add_ scatter-adds into an (h*w, 4) RGB+weight accumulator."""
from __future__ import annotations

import torch

from .errors import not_ported
from .scene.ir import FILTER_BOX, FILTER_TENT


def splat(w: int, h: int, rfilter: int, pos, value):
    """pos (N,2) continuous film coords, value (N,3) -> (h, w, 4)."""
    img = torch.zeros((h * w, 4), device=value.device)
    ones = torch.ones(value.shape[:-1] + (1,), device=value.device)
    if rfilter == FILTER_BOX:
        px = torch.clamp(pos[..., 0].to(torch.int64), 0, w - 1)
        py = torch.clamp(pos[..., 1].to(torch.int64), 0, h - 1)
        img.index_add_(0, py * w + px, torch.cat([value, ones], -1))
        return img.view(h, w, 4)
    if rfilter != FILTER_TENT:
        raise not_ported(f"reconstruction filter {rfilter}", "Queue 1 M3")
    # tent, radius 1: the 2x2 pixel centres around the sample
    cx = pos[..., 0] - 0.5
    cy = pos[..., 1] - 0.5
    bx = torch.floor(cx).to(torch.int64)
    by = torch.floor(cy).to(torch.int64)
    for oy in (0, 1):
        for ox in (0, 1):
            px = bx + ox
            py = by + oy
            wgt = torch.clamp(1.0 - torch.abs(px.to(torch.float32) - cx),
                              min=0.0) \
                * torch.clamp(1.0 - torch.abs(py.to(torch.float32) - cy),
                              min=0.0)
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
