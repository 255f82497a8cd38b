"""Texture evaluation over the wavefront (counterpart of
liverrenderer_tpu/texture/eval.py): constant, checkerboard, bitmap,
mesh-attribute and volume textures, combined with masked selects over the
scene's static set of texture types, and the height-map tap of bump
mapping.

A bitmap tap is bilinear with repeat wrap.  When the scene packs quads
(`Textures.has_quads`, every stack the builder makes up to 64 Mi floats)
the four texels of a tap come from one row of `quads`; otherwise from four
reads of `bitmaps`.  So, as in the JAX package, the `textures.bitmaps` leaf
receives a gradient only on the four-tap path.  A mesh-attribute texture
reads the interaction's interpolated vertex attribute (`attr`), a volume
texture its grid trilinearly at the world position (`p`); a call that
passes neither evaluates them as white, as the JAX package's does (the
builder refuses such textures in the slots that are evaluated so).
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..scene.ir import (TEX_BITMAP, TEX_CHECKERBOARD, TEX_CONST, TEX_MESHATTR,
                        TEX_VOLUME, Textures)


def eval_texture(tex: Textures, tex_idx, uv, types=None, p=None, attr=None):
    """(N, 3) linear RGB of texture tex_idx (-1 => white) at uv (N, 2).
    `types` narrows the texture families this call can reach (a slot that
    only ever holds constants skips the bitmap tap); p (N, 3) is the world
    hit position (volume textures), attr (N, 3) the interpolated vertex
    attribute (mesh-attribute textures)."""
    present = tex.types_present if types is None \
        else tuple(set(tex.types_present) & set(types))
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
    if TEX_MESHATTR in present and attr is not None:
        # mesh_attribute.cpp: the vertex attribute times data[0:3]
        out = torch.where((ttype == TEX_MESHATTR)[..., None],
                          attr * data[..., 0:3], out)
    if TEX_VOLUME in present and p is not None:
        out = torch.where((ttype == TEX_VOLUME)[..., None],
                          _trilinear_volume(tex, idx, p) * data[..., 0:3],
                          out)
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


def _trilinear_volume(tex: Textures, idx, p):
    """A volume texture's grid (bitmap_id holds its index), trilinear at
    the world position p through the grid's world -> [0,1]^3 transform
    (volumes/grid.cpp); the JAX package's operations in its order."""
    vid = torch.clamp(tex.bitmap_id[idx], min=0)
    g2l = tex.vgrid_to_local[vid]
    pl = torch.einsum("nij,nj->ni", g2l[:, :3, :3], p) + g2l[:, :3, 3]
    whd = tex.vgrid_whd[vid]
    D = (whd[:, 0] - 1).to(torch.float32)
    H = (whd[:, 1] - 1).to(torch.float32)
    W = (whd[:, 2] - 1).to(torch.float32)
    x = torch.clamp(pl[:, 0], 0.0, 1.0) * W
    y = torch.clamp(pl[:, 1], 0.0, 1.0) * H
    z = torch.clamp(pl[:, 2], 0.0, 1.0) * D
    x0 = torch.minimum(torch.clamp(x.to(torch.int64), min=0), whd[:, 2] - 2)
    y0 = torch.minimum(torch.clamp(y.to(torch.int64), min=0), whd[:, 1] - 2)
    z0 = torch.minimum(torch.clamp(z.to(torch.int64), min=0), whd[:, 0] - 2)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    fz = (z - z0)[:, None]
    _, Dm, Hm, Wm, _ = tex.vgrids.shape
    flat = tex.vgrids.reshape(-1, 3)
    base = ((vid * Dm + z0) * Hm + y0) * Wm + x0

    def g(dz, dy, dx):
        return flat[base + (dz * Hm + dy) * Wm + dx]

    c00 = g(0, 0, 0) * (1 - fx) + g(0, 0, 1) * fx
    c01 = g(0, 1, 0) * (1 - fx) + g(0, 1, 1) * fx
    c10 = g(1, 0, 0) * (1 - fx) + g(1, 0, 1) * fx
    c11 = g(1, 1, 0) * (1 - fx) + g(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz
