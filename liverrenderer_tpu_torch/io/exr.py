"""A small OpenEXR codec (counterpart of liverrenderer_tpu/io/exr.py):
single-part scanline files with no, ZIPS or ZIP compression and half,
float or uint pixels, read; ZIP-compressed half or float files, written.

`read_exr` returns R, G, B (alpha dropped), as the JAX package's pure
reader does; `read_exr_any` keeps alpha and orders the channels R, G, B(,
A), as the JAX package's reader does with its native library built
(io/image.read_exr_any).  PIZ, RLE, PXR24, B44 and DWA compression and
tiled, multi-part or deep files need OpenEXR itself and raise (ROADMAP
M9).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from ..errors import not_ported

MAGIC = 20000630

_PIX_UINT, _PIX_HALF, _PIX_FLOAT = 0, 1, 2
_PIX_SIZE = {_PIX_UINT: 4, _PIX_HALF: 2, _PIX_FLOAT: 4}
_PIX_NP = {_PIX_UINT: np.uint32, _PIX_HALF: np.float16,
           _PIX_FLOAT: np.float32}
_NONE, _ZIPS, _ZIP = 0, 2, 3
_COMPRESSION = {1: "RLE", 4: "PIZ", 5: "PXR24", 6: "B44", 7: "B44A",
                8: "DWAA", 9: "DWAB"}


def _read_cstr(buf, off):
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("latin1"), end + 1


def _reorder_unpredict(data: bytes) -> bytes:
    """Undo the ZIP codec's byte predictor, then its interleaving."""
    arr = np.frombuffer(data, np.uint8)
    if len(arr) > 1:
        deltas = arr[1:].astype(np.int64) - 128
        cs = np.cumsum(np.concatenate([arr[:1].astype(np.int64), deltas]))
        out = (cs % 256).astype(np.uint8)
    else:
        out = arr
    n = len(out)
    half = (n + 1) // 2
    result = np.empty(n, np.uint8)
    result[0::2] = out[:half]
    result[1::2] = out[half:]
    return result.tobytes()


def _predict_reorder(data: bytes) -> bytes:
    """The ZIP codec's interleaving and byte predictor (for writing)."""
    arr = np.frombuffer(data, np.uint8)
    n = len(arr)
    half = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[:half] = arr[0::2]
    inter[half:] = arr[1::2]
    out = np.empty(n, np.uint8)
    out[0] = inter[0]
    diff = inter[1:].astype(np.int16) - inter[:-1].astype(np.int16) + 128
    out[1:] = (diff % 256).astype(np.uint8)
    return out.tobytes()


def read_channels(path: str):
    """(channel names in file order, {name: (H, W) float32})."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    for bit, what in ((0x200, "tiled"), (0x800, "deep"),
                      (0x1000, "multi-part")):
        if version & bit:
            raise not_ported(f"{what} EXR files", "Queue 1 M9")
    off = 8
    channels = []
    compression = _NONE
    dw = None
    while True:
        name, off = _read_cstr(buf, off)
        if not name:
            break
        _, off = _read_cstr(buf, off)
        size = struct.unpack_from("<i", buf, off)[0]
        off += 4
        aval = buf[off:off + size]
        off += size
        if name == "channels":
            coff = 0
            while aval[coff] != 0:
                cname, coff = _read_cstr(aval, coff)
                ptype = struct.unpack_from("<i", aval, coff)[0]
                coff += 16
                channels.append((cname, ptype))
        elif name == "compression":
            compression = aval[0]
        elif name == "dataWindow":
            dw = struct.unpack("<4i", aval)
    if dw is None:
        raise ValueError(f"EXR file without a dataWindow: {path}")
    if compression not in (_NONE, _ZIPS, _ZIP):
        raise not_ported(
            f"{_COMPRESSION.get(compression, compression)}-compressed EXR "
            "files", "Queue 1 M9")
    xmin, ymin, xmax, ymax = dw
    w = xmax - xmin + 1
    h = ymax - ymin + 1
    lines_per_block = 16 if compression == _ZIP else 1
    n_blocks = (h + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{n_blocks}q", buf, off)
    bytes_per_line = sum(_PIX_SIZE[t] for _, t in channels) * w

    out = {c: np.zeros((h, w), np.float32) for c, _ in channels}
    for boff in offsets:
        y0 = struct.unpack_from("<i", buf, boff)[0] - ymin
        dsize = struct.unpack_from("<i", buf, boff + 4)[0]
        raw = buf[boff + 8: boff + 8 + dsize]
        nlines = min(lines_per_block, h - y0)
        if compression == _NONE or dsize == bytes_per_line * nlines:
            data = raw
        else:
            data = _reorder_unpredict(zlib.decompress(raw))
        pos = 0
        for ly in range(nlines):
            # a line holds every channel in name order
            for cname, ptype in sorted(channels):
                nb = _PIX_SIZE[ptype] * w
                out[cname][y0 + ly] = np.frombuffer(data[pos:pos + nb],
                                                    _PIX_NP[ptype])
                pos += nb
    return [c for c, _ in channels], out


def read_exr(path: str) -> np.ndarray:
    """(H, W, 3) float32: R, G, B (alpha dropped), or Y, or the first
    channel, as grey."""
    _, out = read_channels(path)
    if all(c in out for c in "RGB"):
        return np.stack([out["R"], out["G"], out["B"]], -1)
    if "Y" in out:
        return np.repeat(out["Y"][..., None], 3, -1)
    first = next(iter(out.values()))
    return np.repeat(first[..., None], 3, -1)


def read_exr_any(path: str) -> np.ndarray:
    """(H, W, C) float32 with alpha kept: R, G, B(, A) when three of them
    are present, Y as grey, else every channel in file order."""
    names, out = read_channels(path)
    order = [n for n in "RGBA" if n in out]
    if len(order) >= 3:
        return np.stack([out[n] for n in order], -1)
    if "Y" in out:
        return np.repeat(out["Y"][..., None], 3, -1)
    return np.stack([out[n] for n in names], -1)


def write_exr(path: str, img: np.ndarray, half: bool = True):
    """Write (H, W), (H, W, 1..4) float pixels (channels R, G, B, A) as a
    ZIP-compressed scanline EXR of half (default) or float channels."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    names = ["R", "G", "B", "A"][:c]
    ptype = _PIX_HALF if half else _PIX_FLOAT
    np_t = _PIX_NP[ptype]

    hdr = bytearray(struct.pack("<ii", MAGIC, 2))

    def attr(name, atype, val):
        hdr.extend(name.encode() + b"\x00" + atype.encode() + b"\x00"
                   + struct.pack("<i", len(val)) + val)

    chan = bytearray()
    for n in sorted(names):
        chan += n.encode() + b"\x00" + struct.pack("<iiii", ptype, 0, 1, 1)
    chan += b"\x00"
    attr("channels", "chlist", bytes(chan))
    attr("compression", "compression", bytes([_ZIP]))
    attr("dataWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
    attr("displayWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
    attr("lineOrder", "lineOrder", bytes([0]))
    attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
    attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    hdr += b"\x00"

    lines_per_block = 16
    n_blocks = (h + lines_per_block - 1) // lines_per_block
    table_off = len(hdr)
    out = hdr + b"\x00" * (8 * n_blocks)
    chan_order = sorted(range(c), key=lambda i: names[i])
    for bi in range(n_blocks):
        y0 = bi * lines_per_block
        block = img[y0:y0 + lines_per_block][..., chan_order]
        # line-major, then channel, then pixel
        raw = block.transpose(0, 2, 1).astype(np_t).tobytes()
        comp = zlib.compress(_predict_reorder(raw))
        if len(comp) >= len(raw):
            comp = raw
        struct.pack_into("<q", out, table_off + 8 * bi, len(out))
        out += struct.pack("<ii", y0, len(comp)) + comp
    with open(path, "wb") as f:
        f.write(bytes(out))
