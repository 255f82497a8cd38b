"""The port's PNG reader (liverrenderer_tpu_torch/io/png.py) on the files
its first cut refused: 16-bit, 1-, 2- and 4-bit (grey and palette) and
Adam7-interlaced images, against the JAX package's read_image (PIL's
`Image.open(p).convert("RGB")`), pixel for pixel.

Files come from PIL where it writes them, and from a small numpy encoder
here (every colour type and bit depth, every row filter, plain or
interlaced).  PIL's one departure from the PNG specification is held too:
16-bit grey opens as "I;16" and converts to RGB by clipping every value
above 255 to 255, where every other 16-bit mode keeps the high byte.
"""
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from liverrenderer_tpu.io import image as jimage
from liverrenderer_tpu_torch.io import image as timage
from liverrenderer_tpu_torch.io.png import _ADAM7
from torch_threads import torch_threads_per_worker  # noqa: F401

# colour type -> (channels, bit depths)
TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
         4: (2, (8, 16)), 6: (4, (8, 16))}
CASES = [(ct, d) for ct, (_, ds) in TYPES.items() for d in ds]


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter_rows(rows, bpp):
    """Filter each row of raw bytes with type y % 5 (None, Sub, Up,
    Average, Paeth) -> filtered bytes with the type bytes."""
    rows = rows.astype(np.int32)
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for y, cur in enumerate(rows):
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        b = prev
        ft = y % 5
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = a
        elif ft == 2:
            pred = b
        elif ft == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        out.append(bytes([ft]) + ((cur - pred) & 0xFF).astype(np.uint8)
                   .tobytes())
        prev = cur
    return b"".join(out)


def _pack(px, depth):
    """(h, w, nch) samples -> (h, stride) raw bytes."""
    h = px.shape[0]
    flat = px.reshape(h, -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1) \
        .reshape(h, -1).astype(np.uint8)
    return np.packbits(bits, axis=1)


def encode_png(path, px, depth, ctype, interlace=False, palette=None):
    """Write (h, w, nch) integer samples as a PNG of that colour type and
    depth, every row filter in turn; Adam7 passes when `interlace`."""
    h, w, nch = px.shape
    bpp = max(1, nch * depth // 8)
    if interlace:
        data = b"".join(
            _filter_rows(_pack(px[y0::dy, x0::dx], depth), bpp)
            for x0, y0, dx, dy in _ADAM7 if w > x0 and h > y0)
    else:
        data = _filter_rows(_pack(px, depth), bpp)
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                       int(interlace)))
    if palette is not None:
        body += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + body
                + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b""))


def _samples(rng, h, w, ctype, depth):
    nch = TYPES[ctype][0]
    return rng.integers(0, 1 << depth, (h, w, nch)).astype(np.uint16)


def _same(path):
    """The port's read equals PIL's, raw and linearised."""
    for lin in (False, True):
        got = timage.read_image(str(path), lin)
        ref = jimage.read_image(str(path), lin)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("ctype,depth", CASES)
def test_every_type_and_depth_matches_pil(tmp_path, ctype, depth,
                                          interlace):
    """Every colour type at every depth, plain and Adam7, at sizes whose
    passes are ragged or empty."""
    rng = np.random.default_rng(ctype * 100 + depth)
    for h, w in ((13, 11), (3, 1), (1, 9)):
        px = _samples(rng, h, w, ctype, depth)
        pal = None
        if ctype == 3:
            # fewer entries than indices: indices past the palette
            n = max(1, (1 << depth) - 3)
            pal = rng.integers(0, 256, (n, 3))
        path = tmp_path / f"{h}x{w}.png"
        encode_png(path, px, depth, ctype, interlace, pal)
        _same(path)


def test_sixteen_bit_grey_clips_as_pil_does(tmp_path):
    """JAX-package behaviour (PIL): 16-bit grey (0, 250, 500, 750) reads
    as (0, 250, 255, 255), where 16-bit RGB keeps the high byte."""
    grey = np.array([[0, 250, 500, 750]], np.uint16)[..., None]
    encode_png(tmp_path / "g16.png", grey, 16, 0)
    got = timage.read_image(str(tmp_path / "g16.png"), False)
    np.testing.assert_array_equal(got[0, :, 0] * 255,
                                  np.float32([0, 250, 255, 255]))
    _same(tmp_path / "g16.png")
    rgb = np.repeat(grey, 3, -1)
    encode_png(tmp_path / "rgb16.png", rgb, 16, 2)
    got = timage.read_image(str(tmp_path / "rgb16.png"), False)
    np.testing.assert_array_equal(got[0, :, 0] * 255,
                                  np.float32([0, 0, 1, 2]))
    _same(tmp_path / "rgb16.png")


@pytest.mark.parametrize("mode,bits", [("1", None), ("P", 1), ("P", 2),
                                       ("P", 4), ("I;16", None),
                                       ("LA", None), ("RGBA", None)])
def test_pil_written_files(tmp_path, mode, bits):
    """Files PIL writes: 1-bit, low-bit palettes, 16-bit grey, grey and
    RGB with alpha."""
    rng = np.random.default_rng(5)
    h, w = 17, 10
    if mode == "1":
        im = Image.fromarray(rng.integers(0, 2, (h, w)).astype(bool))
    elif mode == "P":
        im = Image.fromarray(rng.integers(0, 1 << bits, (h, w))
                             .astype(np.uint8), "L").convert("P")
        im.putpalette(rng.integers(0, 256, 3 << bits).astype(np.uint8)
                      .tolist())
    elif mode == "I;16":
        im = Image.fromarray(rng.integers(0, 1 << 16, (h, w))
                             .astype(np.uint16))
    else:
        nch = len(mode)
        im = Image.fromarray(rng.integers(0, 256, (h, w, nch))
                             .astype(np.uint8), mode)
    path = tmp_path / "pil.png"
    im.save(path, bits=bits) if bits else im.save(path)
    _same(path)
