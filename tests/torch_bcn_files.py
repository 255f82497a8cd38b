"""DDS, FTEX and BLP test files built by hand (numpy only, no JAX, no
port) for tests/test_torch_bcn.py and tests/test_torch_dds_blp_ftex.py,
and a small BC7 encoder (mode 6 only) that writes the committed floor
texture tests/data/torch_floor_bc7.dds."""
import struct

import numpy as np

DDPF_ALPHAPIXELS, DDPF_FOURCC, DDPF_PAL8 = 0x1, 0x4, 0x20
DDPF_RGB, DDPF_LUMINANCE = 0x40, 0x20000


def dds(w, h, body, flags=DDPF_FOURCC, fourcc=b"DX10", bitcount=0,
        masks=(0, 0, 0, 0), dxgi=None, header_size=124):
    """A DDS file: the 124-byte header with a pixel format, the DX10
    header when dxgi is given, then body."""
    fcc = struct.unpack("<I", fourcc)[0] if isinstance(fourcc, bytes) \
        else fourcc
    head = b"DDS " + struct.pack("<7I", header_size, 0x1007, h, w, 0, 0, 0)
    head += bytes(44) + struct.pack("<4I", 32, flags, fcc, bitcount)
    head += struct.pack("<4I", *masks) + struct.pack("<5I", 0x1000, 0, 0,
                                                     0, 0)
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + body


def random_blocks(n, size, rng, mode_bytes=None):
    b = rng.integers(0, 256, (n, size)).astype(np.uint8)
    if mode_bytes is not None:
        b[:len(mode_bytes), 0] = mode_bytes
    return b.tobytes()


_W4 = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64])


def bc7_mode6(img: np.ndarray) -> bytes:
    """(H, W, 4) uint8, H and W multiples of 4 -> BC7 mode-6 blocks:
    per-channel min/max endpoints (7 bits and a p-bit each), 4-bit
    indices on the line between them."""
    h, w = img.shape[:2]
    blocks = img.reshape(h // 4, 4, w // 4, 4, 4).transpose(0, 2, 1, 3, 4) \
        .reshape(-1, 16, 4).astype(np.int64)
    out = bytearray()
    for px in blocks:
        lo, hi = px.min(0), px.max(0)
        e = []
        for v in (lo, hi):
            p = int(round(float(np.mean(v & 1))))
            q = np.clip((v - p + 1) >> 1, 0, 127)
            e.append((q, p))
        e0 = (e[0][0] << 1) | e[0][1]
        e1 = (e[1][0] << 1) | e[1][1]
        d = (e1 - e0).astype(np.float64)
        t = ((px - e0) @ d) / max(float(d @ d), 1e-9)
        idx = np.abs(t[:, None] * 64 - _W4[None]).argmin(1)
        if idx[0] & 8:          # the anchor index has 3 bits: swap ends
            e = e[::-1]
            idx = 15 - idx
        bits, pos = 0, 0

        def put(v, n):
            nonlocal bits, pos
            bits |= (int(v) & ((1 << n) - 1)) << pos
            pos += n

        put(1 << 6, 7)
        for c in range(4):
            put(e[0][0][c], 7)
            put(e[1][0][c], 7)
        put(e[0][1], 1)
        put(e[1][1], 1)
        put(idx[0], 3)
        for i in idx[1:]:
            put(i, 4)
        out += bits.to_bytes(16, "little")
    return bytes(out)


def ftex(w, h, fmt, body, count=1, where=None, size=None):
    """An FTEX file with one mipmap of `body` in format `fmt`."""
    where = 32 if where is None else where
    head = b"FTEX" + struct.pack("<i2i2i2i", 0, w, h, 1, count, fmt, where)
    head = head.ljust(where, b"\0")
    return head + struct.pack("<i", len(body) if size is None else size) \
        + body


def blp2(w, h, body, encoding=1, alpha=0, alpha_enc=0, compression=1,
         palette=None, offset=None):
    """A BLP2 file: header, mipmap offsets and lengths, palette, body."""
    pal = palette if palette is not None else bytes(1024)
    off = 20 + 128 + len(pal) if offset is None else offset
    head = b"BLP2" + struct.pack("<i3bxII", compression, encoding, alpha,
                                 alpha_enc, w, h)
    head += struct.pack("<16I", off, *[0] * 15)
    head += struct.pack("<16I", len(body), *[0] * 15)
    return (head + pal).ljust(off, b"\0") + body


def blp1(w, h, body, compression=1, encoding=5, alpha=0, palette=None,
         jpeg_header=b""):
    """A BLP1 file: palette (compression 1) or JPEG header (0), then the
    mipmap (the JPEG body at offsets[0])."""
    head = b"BLP1" + struct.pack("<iIIIiI", compression, alpha, w, h,
                                 encoding, 0)
    if compression == 0:
        off = 28 + 128 + 4 + len(jpeg_header)
        pre = struct.pack("<I", len(jpeg_header)) + jpeg_header
    else:
        pre = palette if palette is not None else bytes(1024)
        off = 28 + 128 + len(pre)
    head += struct.pack("<16I", off, *[0] * 15)
    head += struct.pack("<16I", len(body), *[0] * 15)
    return head + pre + body


def committed_floor_dds() -> bytes:
    """tests/data/torch_floor_bc7.dds: floor_texture(256) (opaque) as BC7
    mode-6 blocks under a DX10 header (BC7_UNORM)."""
    import torch_xml_files as xf
    img = np.concatenate([xf.floor_texture(256),
                          np.full((256, 256, 1), 255, np.uint8)], -1)
    return dds(256, 256, bc7_mode6(img), dxgi=98)
