"""Block-compressed (BCn) texture decoders, as Pillow 12.1's BcnDecode.c
decodes them for its "bcn" codec (DDS and FTEX files).

BC1 (DXT1, 3- and 4-colour blocks), BC2 (DXT3), BC3 (DXT5), BC4 (ATI1)
and BC5 (ATI2, unsigned and signed, blue 0 or 128) decode in numpy over all blocks at
once.  BC6H (UF16, SF16: all 14 modes, the reserved ones black; a signed
block's deltas are not sign-extended after they are added, as Pillow
leaves them) and BC7
(8 modes; a first byte of 0 is Pillow's "degenerate" block) run their
per-block mode logic in C++ (csrc/bcn.cpp, built at first use by
host_build.compile_shared; a failed build raises, and nothing falls back);
`_bc6h_plain` and `_bc7_plain` are their plain Python versions with the
same contract.  Blocks fill the image in row order, ceil(w / 4) to a row,
and the parts past the right and bottom edges are dropped, as Pillow's
put_block drops them.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "bcn.cpp"
_LIB = None

# BcnDecode.c's n -> bytes per block
BLOCK_BYTES = {1: 8, 2: 16, 3: 16, 4: 8, 5: 16, 6: 16, 7: 16}

# BC7 partition tables: two subsets, one bit per pixel
_SI2 = (
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800,
    0xffec, 0xfe80, 0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000, 0xf710, 0x8e,
    0x7100, 0x8ce, 0x8c, 0x7310, 0x3100, 0x8cce, 0x88c, 0x3110, 0x6666,
    0x366c, 0x17e8, 0xff0, 0x718e, 0x399c, 0xaaaa, 0xf0f0, 0x5a5a, 0x33cc,
    0x3c3c, 0x55aa, 0x9696, 0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996,
    0xc33c, 0x9966, 0x660, 0x272, 0x4e4, 0x4e40, 0x2720, 0xc936, 0x936c,
    0x39c6, 0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0xfcc, 0x7744,
    0xee22)
# three subsets, two bits per pixel
_SI3 = (
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050,
    0x5555a0a0, 0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090,
    0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250, 0xa5945040, 0xa425054,
    0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x50a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414,
    0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424,
    0xaa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580,
    0xaa141414, 0x96960000, 0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000,
    0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254)
# anchor pixels: of subset 1 of two, of subsets 1 and 2 of three
_AI0 = (
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2, 8,
    2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2, 15, 15, 6, 8, 2, 8, 15, 15, 2, 8,
    2, 2, 2, 15, 15, 6, 6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2,
    15)
_AI1 = (
    3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3, 3, 3, 8, 15, 3, 3, 6,
    10, 5, 8, 8, 6, 8, 5, 15, 15, 8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5,
    15, 15, 15, 15, 3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3)
_AI2 = (
    15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8, 15, 8, 15, 3,
    15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8, 15, 3, 15, 10, 10, 8, 9, 10,
    6, 15, 8, 15, 3, 6, 6, 8, 15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    3, 15, 15, 8)
# BC6H: for each mode, the endpoint bit each stored bit goes to
# (16 * endpoint + bit; endpoints r0 g0 b0 r1 g1 b1 ... b3)
_PACK = (
    (116, 132, 180, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179),
    (117, 164, 165, 0, 1, 2, 3, 4, 5, 6, 176, 177, 132, 16, 17, 18, 19, 20, 21, 22, 133, 178, 116, 32, 33, 34, 35, 36, 37, 38, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 10, 112, 113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82, 83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 26, 160, 161, 162, 163, 80, 81, 82, 83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 176, 178, 144, 145, 146, 147, 116, 179),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 132, 112, 113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 42, 128, 129, 130, 131, 96, 97, 98, 99, 177, 178, 144, 145, 146, 147, 180, 179),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 132, 16, 17, 18, 19, 20, 21, 22, 23, 24, 116, 32, 33, 34, 35, 36, 37, 38, 39, 40, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179),
    (0, 1, 2, 3, 4, 5, 6, 7, 164, 132, 16, 17, 18, 19, 20, 21, 22, 23, 178, 116, 32, 33, 34, 35, 36, 37, 38, 39, 179, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149),
    (0, 1, 2, 3, 4, 5, 6, 7, 176, 132, 16, 17, 18, 19, 20, 21, 22, 23, 117, 116, 32, 33, 34, 35, 36, 37, 38, 39, 165, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179),
    (0, 1, 2, 3, 4, 5, 6, 7, 177, 132, 16, 17, 18, 19, 20, 21, 22, 23, 133, 116, 32, 33, 34, 35, 36, 37, 38, 39, 181, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179),
    (0, 1, 2, 3, 4, 5, 164, 176, 177, 132, 16, 17, 18, 19, 20, 21, 117, 133, 178, 116, 32, 33, 34, 35, 36, 37, 165, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 10, 64, 65, 66, 67, 68, 69, 70, 71, 72, 26, 80, 81, 82, 83, 84, 85, 86, 87, 88, 42),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 11, 10, 64, 65, 66, 67, 68, 69, 70, 71, 27, 26, 80, 81, 82, 83, 84, 85, 86, 87, 43, 42),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 15, 14, 13, 12, 11, 10, 64, 65, 66, 67, 31, 30, 29, 28, 27, 26, 80, 81, 82, 83, 47, 46, 45, 44, 43, 42),
)

_T_SI2 = np.array(_SI2, np.uint16)
_T_SI3 = np.array(_SI3, np.uint32)
_T_AI = [np.array(a, np.uint8) for a in (_AI0, _AI1, _AI2)]
_T_PACK = np.zeros((14, 75), np.uint8)
for _m, _row in enumerate(_PACK):
    _T_PACK[_m, :len(_row)] = _row

_W = {2: (0, 21, 43, 64), 3: (0, 9, 18, 27, 37, 46, 55, 64),
      4: (0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64)}
# ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2
_BC7_MODES = ((3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
              (3, 6, 0, 0, 5, 0, 0, 0, 2, 0), (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
              (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
              (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0))
# ns, transformed, pb, endpoint bits, delta bits r, g, b
_BC6_MODES = ((2, 1, 5, 10, 5, 5, 5), (2, 1, 5, 7, 6, 6, 6),
              (2, 1, 5, 11, 5, 4, 4), (2, 1, 5, 11, 4, 5, 4),
              (2, 1, 5, 11, 4, 4, 5), (2, 1, 5, 9, 5, 5, 5),
              (2, 1, 5, 8, 6, 5, 5), (2, 1, 5, 8, 5, 6, 5),
              (2, 1, 5, 8, 5, 5, 6), (2, 0, 5, 6, 6, 6, 6),
              (1, 0, 0, 10, 10, 10, 10), (1, 1, 0, 11, 9, 9, 9),
              (1, 1, 0, 12, 8, 8, 8), (1, 1, 0, 16, 4, 4, 4))


def library():
    """Build (once per source hash) and load csrc/bcn.cpp; raises if the
    compiler fails."""
    global _LIB
    if _LIB is None:
        from ..host_build import BUILD_DIR, compile_shared
        info = compile_shared(_SRC, BUILD_DIR, "BCn decode")
        lib = ctypes.CDLL(info["path"])
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.lrt_bc7.argtypes = [p, i64, p, p, p, p, p, p]
        lib.lrt_bc7.restype = None
        lib.lrt_bc6h.argtypes = [p, i64, i32, p, p, p, p]
        lib.lrt_bc6h.restype = None
        _LIB = lib
    return _LIB


def decode(data: bytes, width: int, height: int, n: int,
           pixel_format: str = "", plain: bool = False) -> np.ndarray:
    """Pillow's "bcn" codec: the blocks at the start of `data` -> (H, W, C)
    uint8 in the mode Pillow gives format n (RGBA for 1, 2, 3, 7; L for
    4; RGB for 5, 6).  "BC5S" and "BC6HS" decode signed.  Too few blocks
    raise OSError as Pillow's truncated-file error."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    size = BLOCK_BYTES[n]
    nb = bw * bh
    if len(data) < nb * size:
        raise OSError("image file is truncated "
                      f"({len(data) % size} bytes not processed)")
    blocks = np.frombuffer(data, np.uint8, nb * size).reshape(nb, size)
    if n == 1:
        px = _bc1_color(blocks, False)
    elif n == 2:
        px = _bc1_color(blocks[:, 8:], True)
        nib = np.stack([blocks[:, :8] & 15, blocks[:, :8] >> 4], -1)
        px[..., 3] = nib.reshape(nb, 16) * 17
    elif n == 3:
        px = _bc1_color(blocks[:, 8:], True)
        px[..., 3] = _bc3_alpha(blocks[:, :8], False)
    elif n == 4:
        px = _bc3_alpha(blocks, False)[..., None]
    elif n == 5:
        sign = pixel_format == "BC5S"
        # Pillow sets a signed block's blue to 128, an unsigned one's to 0
        px = np.full((nb, 16, 3), 128 if sign else 0, np.uint8)
        px[..., 0] = _bc3_alpha(blocks[:, :8], sign)
        px[..., 1] = _bc3_alpha(blocks[:, 8:], sign)
    elif n == 6:
        sign = int(pixel_format == "BC6HS")
        px = _bc6h_plain(blocks, sign) if plain else _bc6h(blocks, sign)
    else:
        px = _bc7_plain(blocks) if plain else _bc7(blocks)
    c = px.shape[-1]
    img = px.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(
        img.reshape(bh * 4, bw * 4, c)[:height, :width])


# ------------------------------------------------------------ BC1 - BC5 ----
def _565(c):
    r = (c & 0xF800) >> 8
    g = (c & 0x7E0) >> 3
    b = (c & 0x1F) << 3
    return r | (r >> 5), g | (g >> 6), b | (b >> 5)


def _bc1_color(blocks, separate_alpha):
    """decode_bc1_color over (nb, 8) blocks -> (nb, 16, 4) RGBA."""
    w = blocks.astype(np.int32)
    c0 = w[:, 0] | (w[:, 1] << 8)
    c1 = w[:, 2] | (w[:, 3] << 8)
    lut = w[:, 4] | (w[:, 5] << 8) | (w[:, 6] << 16) | (w[:, 7] << 24)
    e0, e1 = np.stack(_565(c0), -1), np.stack(_565(c1), -1)
    four = ((c0 > c1) | separate_alpha)[:, None]
    p = np.zeros((len(blocks), 4, 4), np.int32)
    p[:, 0, :3], p[:, 1, :3] = e0, e1
    p[:, 2, :3] = np.where(four, (2 * e0 + e1) // 3, (e0 + e1) // 2)
    p[:, 3, :3] = np.where(four, (e0 + 2 * e1) // 3, 0)
    p[:, :3, 3] = 255
    p[:, 3, 3] = np.where(four[:, 0], 255, 0)
    idx = (lut[:, None] >> (2 * np.arange(16))) & 3
    return np.take_along_axis(p, idx[..., None], 1).astype(np.uint8)


def _bc3_alpha(blocks, sign):
    """decode_bc3_alpha over (nb, 8) blocks -> (nb, 16) values."""
    w = blocks.astype(np.int32)
    if sign:
        a0 = (w[:, 0] ^ 0x80)          # int8 + 128
        a1 = (w[:, 1] ^ 0x80)
    else:
        a0, a1 = w[:, 0], w[:, 1]
    a0, a1 = a0[:, None], a1[:, None]
    k = np.arange(1, 7)
    seven = np.concatenate([a0, a1, ((7 - k) * a0 + k * a1) // 7], 1)
    five = np.concatenate([a0, a1, ((5 - k[:4]) * a0 + k[:4] * a1) // 5,
                           np.zeros_like(a0), np.full_like(a0, 255)], 1)
    a = np.where(a0 > a1, seven, five)
    lut1 = w[:, 2] | (w[:, 3] << 8) | (w[:, 4] << 16)
    lut2 = w[:, 5] | (w[:, 6] << 8) | (w[:, 7] << 16)
    sh = 3 * np.arange(8)
    idx = np.concatenate([(lut1[:, None] >> sh) & 7,
                          (lut2[:, None] >> sh) & 7], 1)
    return np.take_along_axis(a, idx, 1).astype(np.uint8)


# ------------------------------------------------------------ BC6H, BC7 ----
def _tables():
    return (_T_SI2.ctypes.data, _T_SI3.ctypes.data, _T_AI[0].ctypes.data,
            _T_AI[1].ctypes.data, _T_AI[2].ctypes.data)


def _bc7(blocks):
    src = np.ascontiguousarray(blocks)
    out = np.zeros((len(src), 16, 4), np.uint8)
    library().lrt_bc7(src.ctypes.data, len(src), out.ctypes.data, *_tables())
    return out


def _bc6h(blocks, sign):
    src = np.ascontiguousarray(blocks)
    out = np.zeros((len(src), 16, 3), np.uint8)
    library().lrt_bc6h(src.ctypes.data, len(src), sign, out.ctypes.data,
                       _T_SI2.ctypes.data, _T_AI[0].ctypes.data,
                       _T_PACK.ctypes.data)
    return out


def _get_bits(v: int, bit: int, count: int) -> int:
    return (v >> bit) & ((1 << count) - 1)


def _subset(ns, p, i):
    if ns == 2:
        return 1 & (_SI2[p] >> i)
    if ns == 3:
        return 3 & (_SI3[p] >> (2 * i))
    return 0


def _bc7_plain(blocks):
    """lrt_bc7's plain Python version."""
    out = np.zeros((len(blocks), 16, 4), np.uint8)
    for k, blk in enumerate(blocks):
        v = int.from_bytes(bytes(blk), "little")
        if not blk[0]:
            out[k] = (0, 0, 0, 255)
            continue
        mode = (int(blk[0]) & -int(blk[0])).bit_length() - 1
        ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = _BC7_MODES[mode]
        bit = mode + 1

        def load(n):
            nonlocal bit
            x = _get_bits(v, bit, n)
            bit += n
            return x

        part, rot, isel = load(pb), load(rb), load(isb)
        nep = 2 * ns
        ep = [[0, 0, 0, 255] for _ in range(nep)]
        for c in range(3):
            for e in ep:
                e[c] = load(cb)
        if ab:
            for e in ep:
                e[3] = load(ab)
        nch = 4 if ab else 3
        if epb or spb:
            cb += 1
            ab += 1 if ab else 0
            for i in range(nep) if epb else range(0, nep, 2):
                p = load(1)
                for e in ([ep[i]] if epb else ep[i:i + 2]):
                    for c in range(nch):
                        e[c] = ((e[c] << 1) | p) & 0xFF
        for e in ep:
            for c in range(nch):
                q = (e[c] << (8 - (cb if c < 3 else ab))) & 0xFF
                e[c] = q | (q >> (cb if c < 3 else ab))
        cw = _W[ib]
        aw = _W[ib2 if ab and ib2 else ib]
        cbit, abit = bit, bit + 16 * ib - ns
        for i in range(16):
            s = _subset(ns, part, i) << 1
            n = ib
            if i == 0 or (ns == 2 and i == _AI0[part]) or \
                    (ns == 3 and i in (_AI1[part], _AI2[part])):
                n -= 1
            i0 = _get_bits(v, cbit, n)
            cbit += n
            s0 = s1 = cw[i0]
            if ab and ib2:
                n2 = ib2 - (i == 0)
                i1 = _get_bits(v, abit, n2)
                abit += n2
                if isel:
                    s0 = aw[i1]
                else:
                    s1 = aw[i1]
            e0, e1 = ep[s], ep[s + 1]
            px = [((64 - s0) * e0[c] + s0 * e1[c] + 32) >> 6 for c in range(3)]
            px.append(((64 - s1) * e0[3] + s1 * e1[3] + 32) >> 6)
            if rot:
                px[rot - 1], px[3] = px[3], px[rot - 1]
            out[k, i] = px
    return out


def _sext(x, prec):
    x &= 0xFFFF
    if x & (1 << (prec - 1)):
        x = (x | (-1 << prec)) & 0xFFFF
    return x


def _unquantize(v, prec, sign):
    if not sign:
        if prec >= 15 or v == 0:
            return v
        if v == (1 << prec) - 1:
            return 0xFFFF
        return ((v << 15) + 0x4000) >> (prec - 1)
    x = v - 0x10000 if v & 0x8000 else v
    if prec >= 16:
        return x
    s = x < 0
    x = abs(x)
    if x:
        x = 0x7FFF if x >= (1 << (prec - 1)) - 1 \
            else ((x << 15) + 0x4000) >> (prec - 1)
    return -x if s else x


def _half_to_8bit(h):
    """Pillow's half_to_float, clamp to [0, 1] and x 255 (float32)."""
    f = np.array([(h & 0x7FFF) << 13], np.uint32).view(np.float32)
    f = f * np.array([0x77800000], np.uint32).view(np.float32)
    if f[0] >= np.array([0x47800000], np.uint32).view(np.float32)[0]:
        f = (f.view(np.uint32) | np.uint32(255 << 23)).view(np.float32)
    f = (f.view(np.uint32) | np.uint32((h & 0x8000) << 16)).view(np.float32)
    x = f[0]
    if x < 0:
        return 0
    if x > 1:
        return 255
    return int(x * np.float32(255))


def _finalize(v, sign):
    """The value Pillow's bc6_finalize and bc6_clamp make of v."""
    if sign:
        h = (0x8000 | ((-v * 31) // 32)) if v < 0 else (v * 31) // 32
    else:
        h = (v * 31) // 64
    return _half_to_8bit(h & 0xFFFF)


def _bc6h_plain(blocks, sign):
    """lrt_bc6h's plain Python version."""
    out = np.zeros((len(blocks), 16, 3), np.uint8)
    for k, blk in enumerate(blocks):
        v = int.from_bytes(bytes(blk), "little")
        mode = int(blk[0]) & 0x1F
        ib = 3
        if mode & 3 < 2:
            mode, bit, nbits = mode & 1, 2, 75
        elif mode & 3 == 2:
            mode, bit, nbits = 2 + (mode >> 2), 5, 72
        else:
            mode, bit, nbits, ib = 10 + (mode >> 2), 5, 60, 4
        if mode > 13:
            continue
        ns, tr, pb, epb, rb, gb, bb = _BC6_MODES[mode]
        nep = 12 if ns == 2 else 6
        ep = [0] * 12
        for i in range(nbits):
            d = _PACK[mode][i]
            ep[d >> 4] |= ((v >> (bit + i)) & 1) << (d & 15)
        bit += nbits
        part = _get_bits(v, bit, pb)
        bit += pb
        if sign:
            ep[:3] = [_sext(e, epb) for e in ep[:3]]
        if sign or tr:
            for i in range(3, nep):
                ep[i] = _sext(ep[i], (rb, gb, bb)[i % 3])
        if tr:
            for i in range(3, nep):
                ep[i] = (ep[i] + ep[i % 3]) & ((1 << epb) - 1)
        u = [_unquantize(e, epb, sign) for e in ep[:nep]]
        cw = _W[ib]
        for i in range(16):
            s = _subset(ns, part, i) * 6
            n = ib - (i == 0 or (ns == 2 and i == _AI0[part]))
            w = cw[_get_bits(v, bit, n)]
            bit += n
            for c in range(3):
                out[k, i, c] = _finalize(
                    (u[s + c] * (64 - w) + u[s + 3 + c] * w) >> 6, sign)
    return out


