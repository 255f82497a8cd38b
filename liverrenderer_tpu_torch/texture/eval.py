"""Texture evaluation over the wavefront (counterpart of
liverrenderer_tpu/texture/eval.py): constant, checkerboard and bitmap
textures, combined with masked selects over the scene's static set of
texture types, and the height-map tap of bump mapping.

A bitmap tap is bilinear with repeat wrap.  When the scene packs quads
(`Textures.has_quads`, every stack the builder makes up to 64 Mi floats)
the four texels of a tap come from one row of `quads`; otherwise from four
reads of `bitmaps`.  So, as in the JAX package, the `textures.bitmaps` leaf
receives a gradient only on the four-tap path.  Mesh-attribute and volume
textures raise: the intersector does not carry vertex attributes yet.
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..errors import not_ported
from ..scene.ir import (TEX_BITMAP, TEX_CHECKERBOARD, TEX_CONST, TEX_MESHATTR,
                        TEX_VOLUME, Textures)


def _check_types(present):
    if TEX_MESHATTR in present or TEX_VOLUME in present:
        raise not_ported("mesh-attribute and volume textures", "Queue 1 M10")


def eval_texture(tex: Textures, tex_idx, uv, types=None):
    """(N, 3) linear RGB of texture tex_idx (-1 => white) at uv (N, 2).
    `types` narrows the texture families this call can reach (a slot that
    only ever holds constants skips the bitmap tap)."""
    present = tex.types_present if types is None \
        else tuple(set(tex.types_present) & set(types))
    _check_types(present)
    idx = torch.clamp(tex_idx, min=0)
    ttype = tex.ttype[idx]
    data = m.table_lookup(tex.data, idx)
    out = uv.new_ones(uv.shape[:-1] + (3,))
    if TEX_CONST in present:
        out = torch.where((ttype == TEX_CONST)[..., None], data[..., 0:3], out)
    if TEX_CHECKERBOARD in present:
        # color0 where the half-unit masks of u and v agree
        suv = uv * data[..., 6:8] + data[..., 8:10]
        fu = suv[..., 0] - torch.floor(suv[..., 0])
        fv = suv[..., 1] - torch.floor(suv[..., 1])
        par = (fu > 0.5) == (fv > 0.5)
        col = torch.where(par[..., None], data[..., 0:3], data[..., 3:6])
        out = torch.where((ttype == TEX_CHECKERBOARD)[..., None], col, out)
    if TEX_BITMAP in present:
        suv = uv * data[..., 6:8] + data[..., 8:10]
        col = _bilinear(tex, idx, suv)
        out = torch.where((ttype == TEX_BITMAP)[..., None], col, out)
    return torch.where((tex_idx >= 0)[..., None], out, 1.0)


def eval_texture_mono(tex: Textures, tex_idx, uv):
    return torch.mean(eval_texture(tex, tex_idx, uv), -1)


def _tap(tex: Textures, idx, uv):
    """The bilinear tap's texel grid: (bitmap id, (h, w) as ints, x0, y0
    as floats, fx, fy).  v runs down the image rows."""
    bid = torch.clamp(tex.bitmap_id[idx], min=0)
    hw = tex.bitmap_hw[bid]
    h = hw[..., 0].to(torch.float32)
    w = hw[..., 1].to(torch.float32)
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    return bid, hw, x0, y0, x - x0, y - y0


def _texel(tex: Textures, bid, hw, xa, ya):
    """Flat row of texel (xa, ya) of each lane's bitmap, repeat wrap
    (remainder takes the divisor's sign, as jnp.mod)."""
    H, W = tex.bitmaps.shape[1], tex.bitmaps.shape[2]
    xi = torch.remainder(xa.to(torch.int64), torch.clamp(hw[..., 1], min=1))
    yi = torch.remainder(ya.to(torch.int64), torch.clamp(hw[..., 0], min=1))
    return (bid * H + yi) * W + xi


def _corners(tex: Textures, bid, hw, x0, y0):
    """(c00, c10, c01, c11), each (N, 3): one quad row, or four texels."""
    if tex.has_quads:
        q = tex.quads.reshape(-1, 12)[_texel(tex, bid, hw, x0, y0)]
        return q[..., 0:3], q[..., 3:6], q[..., 6:9], q[..., 9:12]
    flat = tex.bitmaps.reshape(-1, 3)
    return (flat[_texel(tex, bid, hw, x0, y0)],
            flat[_texel(tex, bid, hw, x0 + 1, y0)],
            flat[_texel(tex, bid, hw, x0, y0 + 1)],
            flat[_texel(tex, bid, hw, x0 + 1, y0 + 1)])


def _bilinear(tex: Textures, idx, uv):
    """Bilinear, repeat wrap."""
    bid, hw, x0, y0, fx, fy = _tap(tex, idx, uv)
    c00, c10, c01, c11 = _corners(tex, bid, hw, x0, y0)
    fx = fx[..., None]
    fy = fy[..., None]
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def eval_texture_grad_mono(tex: Textures, tex_idx, uv):
    """(height, dh/du, dh/dv) for bump mapping from one tap: the bilinear
    patch's analytic gradient, chained through the texel size and the
    texture's uv scale."""
    idx = torch.clamp(tex_idx, min=0)
    ttype = tex.ttype[idx]
    data = m.table_lookup(tex.data, idx)
    h = uv.new_zeros(uv.shape[:-1])
    du = uv.new_zeros(uv.shape[:-1])
    dv = uv.new_zeros(uv.shape[:-1])
    if TEX_CONST in tex.types_present:
        h = torch.where(ttype == TEX_CONST, torch.mean(data[..., 0:3], -1), h)
    if TEX_BITMAP in tex.types_present:
        suv = uv * data[..., 6:8] + data[..., 8:10]
        bid, hw, x0, y0, fx, fy = _tap(tex, idx, suv)
        c00, c10, c01, c11 = (torch.mean(c, -1)
                              for c in _corners(tex, bid, hw, x0, y0))
        hb = (c00 * (1 - fx) + c10 * fx) * (1 - fy) \
            + (c01 * (1 - fx) + c11 * fx) * fy
        dhdx = (c10 - c00) * (1 - fy) + (c11 - c01) * fy
        dhdy = (c01 - c00) * (1 - fx) + (c11 - c10) * fx
        sel = ttype == TEX_BITMAP
        h = torch.where(sel, hb, h)
        du = torch.where(sel, dhdx * hw[..., 1].to(torch.float32)
                         * data[..., 6], du)
        dv = torch.where(sel, dhdy * hw[..., 0].to(torch.float32)
                         * data[..., 7], dv)
    return h, du, dv
