"""The port's PPM/PGM/PBM, BMP and TGA readers (liverrenderer_tpu_torch/
io/raster.py, through read_image) against the JAX package's read_image,
which reads them through PIL: equal bit for bit, on files written by PIL
and on hand-built bytes for what PIL does not write (P2/P3 at odd maxvals,
16-bit PPM, BMP RLE4/RLE8 with deltas and absolute runs, 4-bit palettes,
555/565 bit fields, top-down rows, OS/2 headers, colour-mapped and
run-length TGA, both origin bits).  What PIL refuses (a TGA packet past
its line, a 32-bit TGA colour map, short RLE data) the port refuses with
the same exception class; RGBE `.hdr` files, which PIL cannot open, raise
OSError in both packages.
"""
import struct

import numpy as np
import pytest
from PIL import Image

import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu.io import image as jimage
from liverrenderer_tpu_torch.io import raster
from torch_threads import torch_threads_per_worker  # noqa: F401

H, W = 23, 37


@pytest.fixture
def rng():
    return np.random.default_rng(18)


def _same(path, srgb=True):
    """The port reads the file as the JAX package does, bit for bit."""
    t = lrt.read_image(str(path), srgb_to_linear=srgb)
    j = jimage.read_image(str(path), srgb_to_linear=srgb)
    assert t.dtype == j.dtype and t.shape == j.shape
    np.testing.assert_array_equal(t, j)


# ------------------------------------------------------ written by PIL ----
_PIL_WRITES = [(f, m) for f in ("BMP", "TGA", "TGA_RLE", "PPM")
               for m in ("RGB", "RGBA", "L", "P", "1", "I16")
               if (f, m) != ("PPM", "P") and not (m == "I16" and f != "PPM")]


@pytest.mark.parametrize("fmt,mode", _PIL_WRITES)
def test_pil_written_files(tmp_path, rng, fmt, mode):
    rgb = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    if mode == "RGB":
        im = Image.fromarray(rgb)
    elif mode == "RGBA":
        im = Image.fromarray(np.dstack([rgb, rgb[..., :1]]))
    elif mode == "L":
        im = Image.fromarray(rgb[..., 0])
    elif mode == "P":
        im = Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE,
                                          colors=200)
    elif mode == "1":
        im = Image.fromarray(rgb[..., 0] > 128)
    else:
        im = Image.fromarray(rng.integers(0, 65536, (H, W)).astype(np.uint16))
    p = tmp_path / f"img.{fmt[:3].lower()}"
    kw = {"compression": "tga_rle"} if fmt == "TGA_RLE" else {}
    im.save(p, fmt.split("_")[0], **kw)
    try:
        jimage.read_image(str(p))
    except Exception as e:       # PIL cannot read back a run-length 1-bit
        with pytest.raises(type(e)):      # TGA: nor can the port
            lrt.read_image(str(p))
        return
    _same(p)


# ------------------------------------------------------------ PPM ----
@pytest.mark.parametrize("magic", ["P2", "P3", "P5", "P6"])
@pytest.mark.parametrize("maxval", [1, 15, 255, 300, 1000, 65535])
def test_ppm_maxvals(tmp_path, rng, magic, maxval):
    bands = 3 if magic in ("P3", "P6") else 1
    v = rng.integers(0, maxval + 1, (5, 7, bands))
    head = f"{magic}\n# a comment\n7 5\n{maxval}\n".encode()
    if magic in ("P2", "P3"):
        body = " ".join(map(str, v.ravel())).encode() + b"\n"
    else:
        body = v.astype(np.uint8 if maxval < 256 else ">u2").tobytes()
    p = tmp_path / "a.ppm"
    p.write_bytes(head + body)
    _same(p)


def test_pbm_plain_and_raw(tmp_path, rng):
    bits = rng.integers(0, 2, (5, 13))
    p1 = tmp_path / "a.pbm"
    p1.write_bytes(b"P1\n13 5\n" + "".join(map(str, bits.ravel())).encode())
    _same(p1)
    p4 = tmp_path / "b.pbm"
    p4.write_bytes(b"P4 13 5\n" + np.packbits(bits, axis=1).tobytes())
    _same(p4)


# ------------------------------------------------------------ BMP ----
def _bmp(w, h, bits, pixels: bytes, palette: bytes = b"", comp=0,
         masks=None, topdown=False, colors=0):
    """A BITMAPINFOHEADER (40 bytes; bit-field masks after it) file."""
    extra = b"" if masks is None else struct.pack("<3I", *masks)
    off = 14 + 40 + len(extra) + len(palette)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if topdown else h, 1, bits,
                       comp, len(pixels), 2835, 2835, colors, 0)
    return (b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off)
            + info + extra + palette + pixels)


def _rows(arr, bits):
    """Bottom-up rows padded to 4 bytes."""
    h = arr.shape[0]
    out = b""
    for y in range(h - 1, -1, -1):
        row = arr[y]
        if bits < 8:
            per = 8 // bits
            row = np.pad(row, (0, -len(row) % per)).reshape(-1, per)
            row = (row << (bits * np.arange(per - 1, -1, -1))).sum(1)
        b = np.asarray(row).astype(np.uint8).tobytes() if bits <= 8 \
            else row.tobytes()
        out += b + bytes(-len(b) % 4)
    return out


@pytest.mark.parametrize("bits", [1, 4, 8])
def test_bmp_palettes(tmp_path, rng, bits):
    n = 1 << bits
    idx = rng.integers(0, n, (H, W))
    pal = rng.integers(0, 256, (n, 4)).astype(np.uint8).tobytes()
    p = tmp_path / "pal.bmp"
    p.write_bytes(_bmp(W, H, bits, _rows(idx, bits), pal))
    _same(p)


@pytest.mark.parametrize("layout", ["555", "565", "555_fields", "32_bgra",
                                    "32_xbgr", "24_topdown"])
def test_bmp_direct_colour(tmp_path, rng, layout):
    if layout.startswith("555") or layout == "565":
        px = rng.integers(0, 1 << 16, (H, W)).astype("<u2")
        masks = {"555": None, "555_fields": (0x7C00, 0x3E0, 0x1F),
                 "565": (0xF800, 0x7E0, 0x1F)}[layout]
        data = _bmp(W, H, 16, _rows(px, 16), comp=3 if masks else 0,
                    masks=masks)
    elif layout.startswith("32"):
        px = rng.integers(0, 1 << 32, (H, W), dtype=np.uint64).astype("<u4")
        masks = (0xFF0000, 0xFF00, 0xFF) if layout == "32_bgra" \
            else (0xFF000000, 0xFF0000, 0xFF00)
        data = _bmp(W, H, 32, _rows(px, 32), comp=3, masks=masks)
    else:
        px = rng.integers(0, 256, (H, W * 3)).astype(np.uint8)
        rows = b"".join(r.tobytes() + bytes(-len(r) % 4) for r in px)
        data = _bmp(W, H, 24, rows, topdown=True)
    p = tmp_path / f"{layout}.bmp"
    p.write_bytes(data)
    _same(p)


def test_bmp_os2_header(tmp_path, rng):
    idx = rng.integers(0, 256, (H, W))
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8).tobytes()
    pix = _rows(idx, 8)
    off = 14 + 12 + len(pal)
    data = (b"BM" + struct.pack("<IHHI", off + len(pix), 0, 0, off)
            + struct.pack("<IHHHH", 12, W, H, 1, 8) + pal + pix)
    p = tmp_path / "os2.bmp"
    p.write_bytes(data)
    _same(p)


@pytest.mark.parametrize("rle4", [False, True])
def test_bmp_rle(tmp_path, rng, rle4):
    """Encoded runs (one clipped at the row's end), absolute runs
    (word-aligned), an end of line before the row is full, a delta (PIL
    reads two bytes more after its escape) and the end of bitmap."""
    w, h = 19, 6
    n = 16 if rle4 else 256
    pal = rng.integers(0, 256, (n, 4)).astype(np.uint8).tobytes()
    a, b = (int(v) for v in rng.integers(0, n, 2))
    pair = (a << 4 | b) if rle4 else a
    absolute = bytes(rng.integers(0, 256, 3 if rle4 else 5,
                                  dtype=np.uint8)) + b"\x00"
    eol = b"\x00\x00"
    stream = (bytes([7, pair]) + bytes([0, 6 if rle4 else 5]) + absolute
              + bytes([3, pair]) + eol                    # a short row
              + bytes([19, pair]) + eol                   # a full row
              + bytes([4, pair]) + b"\x00\x02\x00\x00\x03\x01"  # delta
              + bytes([30, pair]) + eol                   # clipped
              + bytes([19, pair]) + eol + bytes([19, pair])
              + b"\x00\x01")                              # end
    data = _bmp(w, h, 4 if rle4 else 8, stream, pal, comp=2 if rle4 else 1)
    p = tmp_path / "rle.bmp"
    p.write_bytes(data)
    _same(p)


def test_bmp_rle_short_data_raises_in_both(tmp_path, rng):
    pal = rng.integers(0, 256, (256, 4)).astype(np.uint8).tobytes()
    p = tmp_path / "short.bmp"
    p.write_bytes(_bmp(19, 6, 8, bytes([19, 3]) + b"\x00\x01", pal, comp=1))
    with pytest.raises(ValueError):
        jimage.read_image(str(p))
    with pytest.raises(ValueError, match="not enough"):
        lrt.read_image(str(p))


# ------------------------------------------------------------ TGA ----
def _tga(w, h, itype, depth, pixels, cmap=b"", cmap_start=0, cmap_depth=0,
         n_cmap=0, flags=0, ident=b""):
    head = struct.pack("<BBBHHBHHHHBB", len(ident), 1 if cmap else 0, itype,
                       cmap_start, n_cmap, cmap_depth, 0, 0, w, h, depth,
                       flags)
    return head + ident + cmap + pixels


def _tga_rle(px: np.ndarray, size: int, across=False) -> bytes:
    """Run packets (one pixel repeated) alternating with raw packets, each
    inside its line unless `across`."""
    h, w = px.shape[:2]
    flat = px.reshape(-1, size)
    out, i, k = b"", 0, 0
    while i < len(flat):
        room = len(flat) - i if across else w - i % w
        n = min(1 + (k * 37) % 128, room)
        if k % 2:
            out += bytes([0x80 | (n - 1)]) + flat[i].tobytes()
        else:
            out += bytes([n - 1]) + flat[i:i + n].tobytes()
        i += n
        k += 1
    return out


@pytest.mark.parametrize("itype,depth", [(2, 16), (2, 24), (2, 32), (3, 8),
                                         (10, 16), (10, 24), (11, 8)])
@pytest.mark.parametrize("flags", [0x00, 0x20, 0x10, 0x30])
def test_tga_truecolour_and_grey(tmp_path, rng, itype, depth, flags):
    size = depth // 8
    px = rng.integers(0, 256, (H, W, size)).astype(np.uint8)
    if itype == 2 and depth == 16:
        px[..., 1] |= 0x80          # the attribute bit set on half of them
    body = _tga_rle(px, size) if itype & 8 else px.tobytes()
    p = tmp_path / "a.tga"
    p.write_bytes(_tga(W, H, itype, depth, body, flags=flags,
                       ident=b"seeded"))
    _same(p)


@pytest.mark.parametrize("itype", [1, 9])
@pytest.mark.parametrize("cmap_depth", [16, 24])
def test_tga_colour_mapped(tmp_path, rng, itype, cmap_depth):
    start, n = 3, 200
    idx = rng.integers(start, start + n, (H, W, 1)).astype(np.uint8)
    cmap = rng.integers(0, 256, (n, cmap_depth // 8)).astype(np.uint8)
    body = _tga_rle(idx, 1) if itype & 8 else idx.tobytes()
    p = tmp_path / "cm.tga"
    p.write_bytes(_tga(W, H, itype, 8, body, cmap.tobytes(), start,
                       cmap_depth, n, flags=0x20))
    _same(p)


# ------------------------------------------------------- refusals ----
def test_rgbe_hdr_raises_oserror_in_both(tmp_path):
    """PIL cannot open Radiance RGBE files: the JAX package raises its
    UnidentifiedImageError (an OSError), the port OSError."""
    p = tmp_path / "sky.hdr"
    p.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 2 +X 2\n"
                  + bytes(16))
    with pytest.raises(OSError):
        jimage.read_image(str(p))
    with pytest.raises(OSError, match="cannot identify"):
        lrt.read_image(str(p))


@pytest.mark.parametrize("case", ["rle_across_lines", "cmap_32",
                                  "rle_1bit"])
def test_tga_refused_as_pil_refuses(tmp_path, rng, case):
    """A run-length packet past its line's end, a 32-bit colour map, and a
    run-length 1-bit file: PIL refuses each, and so does the port, with
    the same exception class."""
    if case == "rle_across_lines":
        px = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        data = _tga(W, H, 10, 24, _tga_rle(px, 3, across=True))
    elif case == "cmap_32":
        idx = rng.integers(0, 8, (H, W)).astype(np.uint8)
        data = _tga(W, H, 1, 8, idx.tobytes(), bytes(32), 0, 32, 8)
    else:
        data = _tga(W, H, 11, 1, bytes(H * 8))
    p = tmp_path / f"{case}.tga"
    p.write_bytes(data)
    with pytest.raises(Exception) as ref:
        jimage.read_image(str(p))
    with pytest.raises(ref.type):
        lrt.read_image(str(p))


def test_raster_readers_refuse_what_pil_refuses(rng):
    with pytest.raises(OSError, match="bitfields"):
        raster.read_bmp(_bmp(4, 4, 16, bytes(32), comp=3,
                             masks=(0xF000, 0xF00, 0xF0)))
    with pytest.raises(OSError, match="not a TGA"):
        raster.read_tga(_tga(4, 4, 2, 12, bytes(24)))


# ------------------------------------------------------------ writing ----
@pytest.mark.parametrize("ext", [".ppm", ".pgm", ".bmp", ".tga"])
@pytest.mark.parametrize("channels", [3, 4])
def test_write_image_bytes_match_jax(tmp_path, rng, ext, channels):
    """write_image after the ordered dither: the bytes PIL writes (P6,
    24/32-bit bottom-up BMP at 96 dpi, uncompressed TGA with its
    footer)."""
    img = (rng.random((H, W, channels)) * 1.4).astype(np.float32)
    a, b = tmp_path / f"t{ext}", tmp_path / f"j{ext}"
    lrt.write_image(str(a), img)
    jimage.write_image(str(b), img)
    assert a.read_bytes() == b.read_bytes()
    _same(a)


def test_grey_writers_match_pil(rng):
    """The writers' grey (H, W) forms: P5, an 8-bit BMP with a grey
    palette, a type 3 TGA."""
    import io
    grey = rng.integers(0, 256, (H, W)).astype(np.uint8)
    for fmt, enc in (("PPM", raster.encode_ppm), ("BMP", raster.encode_bmp),
                     ("TGA", raster.encode_tga)):
        f = io.BytesIO()
        Image.fromarray(grey).save(f, fmt)
        assert enc(grey) == f.getvalue(), fmt
