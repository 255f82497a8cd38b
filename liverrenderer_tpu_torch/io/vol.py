"""Mitsuba `.vol` grid files (counterpart of the JAX builder's `_load_vol`,
reference src/render/volumegrid.cpp).

Layout: a 48-byte header -- the bytes "VOL", a version byte, then
little-endian int32 encoding, xres, yres, zres, channels and six float32
bounding-box values -- followed by the voxels as float32, x fastest.

The reader follows the JAX package's: it does not look at the encoding
field and always reads float32 voxels, and it ignores the bounding box
(the grid's placement comes from the gridvolume's `to_world`).
"""
from __future__ import annotations

import struct

import numpy as np

HEADER_BYTES = 48
ENCODING_FLOAT32 = 1


def read_vol(path: str) -> np.ndarray:
    """The grid of a `.vol` file as a float32 (z, y, x, channels) array."""
    with open(path, "rb") as f:
        hdr = f.read(HEADER_BYTES)
    if len(hdr) < HEADER_BYTES or hdr[:3] != b"VOL":
        raise ValueError(f"{path}: not a .vol file")
    _encoding, xres, yres, zres, ch = struct.unpack_from("<iiiii", hdr, 4)
    data = np.fromfile(path, np.float32, offset=HEADER_BYTES)
    return data.reshape(zres, yres, xres, ch)


def write_vol(path: str, grid: np.ndarray, bbox=((0.0, 0.0, 0.0),
                                                  (1.0, 1.0, 1.0))):
    """Write a (z, y, x) or (z, y, x, channels) grid as a version-3,
    float32-encoded `.vol` file."""
    g = np.asarray(grid, np.float32)
    if g.ndim == 3:
        g = g[..., None]
    if g.ndim != 4:
        raise ValueError(f"grid must be (z, y, x[, c]), got {g.shape}")
    zres, yres, xres, ch = g.shape
    hdr = b"VOL" + bytes([3]) + struct.pack(
        "<iiiii", ENCODING_FLOAT32, xres, yres, zres, ch) \
        + struct.pack("<6f", *bbox[0], *bbox[1])
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(np.ascontiguousarray(g).tobytes())
