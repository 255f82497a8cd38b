"""The rest of TIFF in the port (liverrenderer_tpu_torch/io/tiff.py,
tiff_fax.py, zstd.py, tiff_ycbcr.py) against the JAX package's read_image,
which reads TIFF through Pillow 12.1 and its libtiff 4.7: equal bit for
bit (tolerance 0), or the same exception class at the same stage (open or
load).

- CCITT fax (compression 2, 3 with T4Options 1-D, 2-D and fill bits, 4,
  and 32771), written by libtiff itself (tests/torch_tiff_files.py), in
  both fill orders and photometrics, at an odd file offset, with flipped
  bits and cut strips (libtiff's bad-code and premature-EOF handling, G3
  data without EOLs); the C++ loop equals its plain version.
- LZMA and ZSTD with predictors 1-3 in strips, tiles and planes; the
  Zstandard decoder against the zstandard package's streams (raw, RLE and
  compressed blocks, checksums, content sizes) and on corrupted ones, C++
  against plain; a wrong checksum fails the strip as in libtiff.
- ThunderScan, old-style LZW (and a file mixing styles), the predictor
  depths and sample formats libtiff refuses, SGILog and WebP (refused at
  load), tiles that start inside a byte, uncompressed planar files of
  every mode, old-style JPEG with its tables in tags and the stream
  checks libtiff makes; CIELab as Pillow's LittleCMS transform converts
  it (its table held to LittleCMS's own pipeline through ctypes).
"""
import struct

import numpy as np
import pytest
from PIL import Image

import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.io import cielab, lzw, tiff, tiff_fax, zstd
import torch_jpeg_files as jf
import torch_raster_files as rf
import torch_tiff_files as tf
from test_torch_tiff import same_as_jax
from torch_threads import torch_threads_per_worker  # noqa: F401

TOL = 0           # bit for bit
RNG = np.random.default_rng(22)


def same_stage(data: bytes):
    """The port reads `data` as Pillow does, or fails at the same stage
    with the same class; returns the image or None."""
    want, got = tf.stage(data, True), tf.stage(data, False)
    assert want[0] == got[0], (want, got)
    if want[0] == "ok":
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=TOL)
        return got[1]
    assert want[1] == got[1], (want, got)
    return None


def _file(tmp_path, data):
    p = tmp_path / "f.tif"
    p.write_bytes(data)
    return p


# ------------------------------------------------------------ CCITT fax ----
_FAX_KINDS = {"rle": (2, {}), "rlew": (32771, {}), "g3_1d": (3, {}),
              "g3_2d": (3, {292: 1}), "g3_2d_fill": (3, {292: 5}),
              "g3_1d_fill": (3, {292: 4}), "g4": (4, {})}


@pytest.mark.parametrize("kind", sorted(_FAX_KINDS))
@pytest.mark.parametrize("photometric,fill", [(0, 1), (1, 2)])
def test_fax_written_by_libtiff(tmp_path, kind, photometric, fill):
    comp, t4 = _FAX_KINDS[kind]
    decoded = 0
    for shape, dens in (((37, 45), 0.3), ((9, 200), 0.7), ((5, 1), 0.5)):
        bits = (RNG.random(shape) < dens).astype(np.uint8)
        data = tf.write_libtiff(bits, comp, photometric,
                                {**t4, 258: 1, 266: fill}, rows_per_strip=16)
        decoded += same_as_jax(_file(tmp_path, data)) is not None
    assert decoded


@pytest.mark.parametrize("kind", ["rle", "g3_2d", "g4"])
def test_fax_tiles(tmp_path, kind):
    comp, t4 = _FAX_KINDS[kind]
    bits = (RNG.random((40, 50)) < 0.4).astype(np.uint8)
    data = tf.write_libtiff(bits, comp, 0, {**t4, 258: 1}, tile=(32, 16))
    assert same_as_jax(_file(tmp_path, data)) is not None


def test_fax_word_alignment_at_an_odd_offset(tmp_path):
    """Compression 32771 aligns rows to the data pointer's 16-bit words:
    the same strip at an even and an odd file offset."""
    bits = (RNG.random((12, 37)) < 0.4).astype(np.uint8)
    src = tf.write_libtiff(bits, 32771, 0, {258: 1})
    off = struct.unpack_from("<I", src, 4)[0]
    strip = src[8:off]
    for pad in (0, 1):
        data = tf.tiff_chunks((12, 37, 1), 1, 0, 32771, [strip],
                              offset_pad=pad)
        same_stage(data)


def _damaged(data: bytes, rng, cut: bool, flips: int) -> bytes:
    d = bytearray(data)
    ifd = struct.unpack_from("<I", d, 4)[0]
    for _ in range(flips):
        if ifd > 8:
            d[int(rng.integers(8, ifd))] ^= 1 << int(rng.integers(0, 8))
    if cut:
        n = struct.unpack_from("<H", d, ifd)[0]
        for i in range(n):
            at = ifd + 2 + 12 * i
            tag, typ, cnt, val = struct.unpack_from("<HHII", d, at)
            if tag == 279 and cnt == 1 and val > 1:
                struct.pack_into("<I", d, at + 8, int(rng.integers(1, val)))
    return bytes(d)


@pytest.mark.parametrize("kind", ["rle", "rlew", "g3_1d", "g3_2d",
                                  "g3_2d_fill"])
def test_fax_damaged_strips(kind):
    """Flipped bits and cut strips: libtiff's bad code words and short
    rows (the row ends, decoding goes on), its premature EOF (the strip
    fails, or G3 data without EOLs is decoded again from the strip's
    start), as Pillow reads them."""
    comp, t4 = _FAX_KINDS[kind]
    rng = np.random.default_rng(sorted(_FAX_KINDS).index(kind))
    for k in range(12):
        shape = (int(rng.integers(1, 20)), int(rng.integers(1, 60)))
        bits = (rng.random(shape) < rng.random()).astype(np.uint8)
        data = tf.write_libtiff(bits, comp, 0, {**t4, 258: 1})
        same_stage(_damaged(data, rng, cut=bool(k % 2), flips=k % 3))


def test_g4_strip_that_ends_early():
    """A G4 strip cut short decodes without error (Fax4Decode fails only a
    strip that gave no row): the rows before the cut equal Pillow's.  The
    rows after it keep what the strip buffer held, which in Pillow is
    whatever its heap gave the buffer (the port's is zeros at first), so
    they are not compared."""
    bits = (RNG.random((300, 256)) < 0.05).astype(np.uint8)
    data = bytearray(tf.write_libtiff(bits, 4, 0, {258: 1}))
    ifd = struct.unpack_from("<I", data, 4)[0]
    full = ifd - 8
    for frac in (0.3, 0.7):
        cut = int(full * frac)
        for i in range(struct.unpack_from("<H", data, ifd)[0]):
            at = ifd + 2 + 12 * i
            if struct.unpack_from("<H", data, at)[0] == 279:
                struct.pack_into("<I", data, at + 8, cut)
        # the rows the decoder writes: those not left at a marker value
        strip = np.full(32 * 300, 0x5A, np.uint8)
        runs = np.zeros(2 * tiff_fax.nruns(256, tiff_fax.G4), np.uint32)
        assert tiff_fax.decode(bytes(data[8:8 + cut]), tiff_fax.G4, 300, 256,
                               32, False, False, runs, strip,
                               np.zeros(1, np.int32)) == 1
        rows = int((strip.reshape(300, 32) != 0x5A).any(1).sum())
        assert 0 < rows < 300
        want, got = tf.stage(bytes(data), True), tf.stage(bytes(data), False)
        assert want[0] == got[0] == "ok"
        np.testing.assert_array_equal(got[1][:rows], want[1][:rows])


def _fax_stream(rng, kind):
    comp, t4 = _FAX_KINDS[kind]
    shape = (int(rng.integers(1, 12)), int(rng.integers(1, 80)))
    bits = (rng.random(shape) < rng.random()).astype(np.uint8)
    data = tf.write_libtiff(bits, comp, 0, {**t4, 258: 1})
    ifd = struct.unpack_from("<I", data, 4)[0]
    src = bytearray(data[8:ifd])
    for _ in range(int(rng.integers(0, 4))):
        if src:
            src[int(rng.integers(0, len(src)))] ^= 1 << int(rng.integers(0, 8))
    if rng.random() < 0.4 and len(src) > 1:
        src = src[:int(rng.integers(1, len(src)))]
    return bytes(src), tiff_fax.decoder_kind(comp, t4.get(292, 0)), shape


@pytest.mark.parametrize("kind", sorted(_FAX_KINDS))
def test_fax_native_equals_plain(kind):
    rng = np.random.default_rng(len(kind))
    for k in range(25):
        src, dk, (h, w) = _fax_stream(rng, kind)
        if k % 5 == 4:                    # noise
            src = bytes(rng.integers(0, 256, int(rng.integers(0, 30)),
                                     dtype=np.uint8))
        outs = []
        for fn in (tiff_fax.decode, tiff_fax._decode_plain):
            runs = np.zeros(2 * tiff_fax.nruns(w, dk), np.uint32)
            strip = np.full((w + 7) // 8 * h, 0x5A, np.uint8)
            flags = np.zeros(1, np.int32)
            r = fn(src, dk, h, w, (w + 7) // 8, bool(k & 1), bool(k & 2),
                   runs, strip, flags)
            outs.append((r, strip.tobytes(), runs.tobytes(), int(flags[0])))
        assert outs[0] == outs[1], (kind, k)


def test_fax_failed_compile_raises(tmp_path, monkeypatch):
    bad = tmp_path / "fax.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tiff_fax, "_SRC", bad)
    monkeypatch.setattr(tiff_fax, "_LIB", None)
    with pytest.raises(RuntimeError, match="CCITT fax decode"):
        tiff_fax.library()


# --------------------------------------------------------- LZMA, ZSTD ----
def _kind_samples(kind):
    if kind == "rgb8":
        return RNG.integers(0, 256, (21, 33, 3)).astype(np.uint8), 2
    if kind == "grey16":
        return RNG.integers(0, 700, (21, 33)).astype(np.uint16), 1
    if kind == "rgba8":
        return RNG.integers(0, 256, (21, 33, 4)).astype(np.uint8), 2
    return RNG.uniform(-5, 300, (21, 33)).astype(np.float32), 1


@pytest.mark.parametrize("comp", [34925, 50000])
@pytest.mark.parametrize("kind,predictor", [("rgb8", 1), ("rgb8", 2),
                                            ("grey16", 2), ("rgba8", 2),
                                            ("f32", 3)])
@pytest.mark.parametrize("layout", ["strips", "tiles", "planar"])
def test_lzma_zstd_layouts(tmp_path, comp, kind, predictor, layout):
    s, photo = _kind_samples(kind)
    if layout == "planar" and s.ndim == 2:
        layout = "strips"
    kw = dict(tile=(16, 16)) if layout == "tiles" else dict(rows_per_strip=8)
    if layout == "planar":
        kw["planar"] = 2
    extra = {338: [2]} if kind == "rgba8" else {}
    for order in ("II", "MM"):
        data = tf.write_libtiff(s, comp, photo, {317: predictor, **extra},
                                order=order, **kw)
        assert same_as_jax(_file(tmp_path, data)) is not None


def _zstd_data(kind, n, rng):
    if kind == 0:
        return bytes(rng.integers(0, 256, n, dtype=np.uint8))
    if kind == 1:
        return bytes(rng.integers(0, 4, n, dtype=np.uint8))
    if kind == 2:
        return (b"liver renderer, " * (n // 16 + 1))[:n]
    if kind == 3:
        return np.cumsum(rng.integers(-2, 3, n)).astype(np.uint8).tobytes()
    return bytes(n)


@pytest.mark.parametrize("level", [-5, 1, 3, 19])
@pytest.mark.parametrize("checksum", [False, True])
def test_zstd_frames_of_the_zstandard_package(level, checksum):
    """Frames libtiff does not write: every block type, Huffman literals in
    1 and 4 streams and treeless, FSE tables in all modes, checksums, with
    and without the content size; both versions equal the input."""
    zstandard = pytest.importorskip("zstandard")
    rng = np.random.default_rng(level + 40)
    for k in range(10):
        n = int(rng.choice([0, 1, 100, 3000, 40000]))
        d = _zstd_data(k % 5, n, rng)
        params = zstandard.ZstdCompressionParameters.from_level(
            level, write_checksum=checksum, write_content_size=bool(k & 1))
        c = zstandard.ZstdCompressor(compression_params=params).compress(d)
        assert zstd.decode(c, len(d)) == d
        if n <= 3000:
            assert zstd._decode_plain(c, len(d)) == d


def _zstd_crafted():
    """Frames libzstd refuses at once: a block whose RLE tables (LL code 0,
    OF code 1, ML code 52) and 98,303 sequences would append 65,539 bytes
    each past the block's 128 KiB; a single-segment frame whose content
    size is 2^63 + 5."""
    magic = bytes.fromhex("28b52ffd")
    raw = (8 << 3).to_bytes(3, "little") + bytes(range(1, 9))
    body = bytes([0x00, 0xFF, 0xFF, 0xFF, 0x54, 0, 1, 52, 0x01])
    seqs = (len(body) << 3 | 2 << 1 | 1).to_bytes(3, "little") + body
    huge = (bytes([0xE0]) + ((1 << 63) + 5).to_bytes(8, "little")
            + (5 << 3 | 1).to_bytes(3, "little") + b"abcde")
    return [magic + bytes([0x00, 0x38]) + raw + seqs, magic + huge]


def test_zstd_native_equals_plain_on_damaged_frames():
    for c in _zstd_crafted():
        for occ in (1 << 17, 1 << 20):
            assert zstd.decode(c, occ) is None
            assert zstd._decode_plain(c, occ) is None
    zstandard = pytest.importorskip("zstandard")
    rng = np.random.default_rng(7)
    for k in range(120):
        d = _zstd_data(k % 5, int(rng.choice([10, 500, 3000])), rng)
        params = zstandard.ZstdCompressionParameters.from_level(
            int(rng.choice([1, 9])), write_checksum=bool(k & 1),
            write_content_size=bool(k & 2))
        c = bytearray(zstandard.ZstdCompressor(
            compression_params=params).compress(d))
        occ = len(d)
        if k % 3 == 0:
            for _ in range(int(rng.integers(1, 4))):
                c[int(rng.integers(4, len(c)))] ^= 1 << int(rng.integers(0, 8))
        elif k % 3 == 1:
            c = c[:int(rng.integers(0, len(c) + 1))]
        else:
            occ = int(rng.integers(0, len(d) + 2))
        assert zstd.decode(bytes(c), occ) == zstd._decode_plain(bytes(c),
                                                                 occ), k


def test_zstd_checksum_and_content_size_in_a_tiff(tmp_path):
    """Strips written by the zstandard package: a checksum libzstd
    verifies (a wrong one fails the strip), a content size."""
    zstandard = pytest.importorskip("zstandard")
    s = RNG.integers(0, 256, (24, 30, 3)).astype(np.uint8)
    for checksum, content in ((True, True), (True, False), (False, True)):
        params = zstandard.ZstdCompressionParameters.from_level(
            3, write_checksum=checksum, write_content_size=content)
        strips = [zstandard.ZstdCompressor(compression_params=params)
                  .compress(s[y:y + 8].tobytes()) for y in range(0, 24, 8)]
        same_stage(tf.tiff_chunks(s.shape, 8, 2, 50000, strips, rows=8))
        if checksum:
            strips[1] = strips[1][:-1] + bytes([strips[1][-1] ^ 1])
            assert same_stage(tf.tiff_chunks(s.shape, 8, 2, 50000, strips,
                                             rows=8)) is None


def test_zstd_failed_compile_raises(tmp_path, monkeypatch):
    bad = tmp_path / "zstd.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(zstd, "_SRC", bad)
    monkeypatch.setattr(zstd, "_LIB", None)
    with pytest.raises(RuntimeError, match="Zstandard decode"):
        zstd.library()


def test_lzma_damaged_strip(tmp_path):
    s = RNG.integers(0, 256, (16, 20, 3)).astype(np.uint8)
    data = tf.write_libtiff(s, 34925, 2, {})
    for k in range(4):
        same_stage(_damaged(data, np.random.default_rng(k), cut=bool(k & 1),
                            flips=k // 2 + 1))


# ------------------------------------------- the rest of COMPRESSION_INFO --
@pytest.mark.parametrize("seed", range(4))
def test_thunderscan(seed):
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(1, 30)), int(rng.integers(1, 40))
    rows = int(rng.integers(1, h + 1))
    g = rng.integers(0, 16, (h, w)).astype(np.uint8)
    codes = [tf.thunderscan_rows(g[y:y + rows], rng)
             for y in range(0, h, rows)]
    img = same_stage(tf.tiff_chunks((h, w, 1), 4, 1, 32809, codes,
                                    rows=rows))
    assert img is not None
    np.testing.assert_array_equal(img[..., 0], g * 17)
    # a code stream that gives a row too many or too few pixels
    cut = [c[:-1] for c in codes]
    same_stage(tf.tiff_chunks((h, w, 1), 4, 1, 32809, cut, rows=rows))
    noise = [bytes(rng.integers(0, 256, 20, dtype=np.uint8)) for _ in codes]
    same_stage(tf.tiff_chunks((h, w, 1), 4, 1, 32809, noise, rows=rows))


@pytest.mark.parametrize("comp", [32809, 34676, 34677, 50001])
@pytest.mark.parametrize("photometric,bits", [(1, 8), (2, 8), (0, 1)])
def test_codecs_libtiff_refuses(tmp_path, comp, photometric, bits):
    """ThunderScan on other depths, SGILog outside LogL/LogLuv (which
    Pillow's mode table lacks), WebP (not configured in this libtiff):
    OSError at load."""
    s = RNG.integers(0, 2 if bits == 1 else 256,
                     (6, 10, 3 if photometric == 2 else 1)).astype(np.uint8)
    data = rf.write_tiff(s, photometric, compression=comp,
                         bits=bits if bits < 8 else None)
    assert same_stage(data) is None
    with pytest.raises(OSError):
        lrt.read_image(str(_file(tmp_path, data)))


@pytest.mark.parametrize("seed", range(3))
def test_old_style_lzw(seed):
    """LZWDecodeCompat, chosen by the first strip for every strip."""
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(1, 40)), int(rng.integers(1, 60))
    s = rng.integers(0, 256 if seed else 4, (h, w, 3)).astype(np.uint8)
    rows = int(rng.integers(1, h + 1))
    for style in ("old", "new_then_old", "old_then_new"):
        chunks = [tf.lzw_encode(
            s[y:y + rows].tobytes(),
            compat=style == "old" or (style == "new_then_old") == bool(k % 2))
            for k, y in enumerate(range(0, h, rows))]
        img = same_stage(tf.tiff_chunks(s.shape, 8, 2, 5, chunks, rows=rows))
        if style == "old":
            np.testing.assert_array_equal(img, s)


@pytest.mark.parametrize("k", range(4))
def test_lzw_compat_native_equals_plain(k):
    rng = np.random.default_rng(k + 60)
    raw = bytes(rng.integers(0, 3 if k % 2 else 256, 20000, dtype=np.uint8))
    for compat in (True, False):
        code = tf.lzw_encode(raw, compat)
        assert lzw.lzw_tiff(code, len(raw), compat) == raw
        assert lzw._lzw_tiff_plain(code, len(raw), compat) == raw
        cut = code[:len(code) // 2]
        assert lzw.lzw_tiff(cut, len(raw), compat) == \
            lzw._lzw_tiff_plain(cut, len(raw), compat)


@pytest.mark.parametrize("case", ["pred2_bits1", "pred2_bits2", "pred2_bits4",
                                  "pred3_uint16", "pred3_uint8",
                                  "pred3_int32", "pred5", "pred2_packbits"])
def test_predictors_libtiff_refuses(tmp_path, case):
    """PredictorSetup: horizontal differencing needs 8, 16, 32 or 64 bits,
    the floating-point predictor float samples; other predictors fail."""
    g = RNG.integers(0, 16, (9, 11)).astype(np.uint8)
    g16 = RNG.integers(0, 4000, (9, 11)).astype(np.uint16)
    if case.startswith("pred2_bits"):
        bits = int(case[-1])
        data = rf.write_tiff(g % (1 << bits), 1, compression=5, predictor=2,
                             bits=bits)
    elif case == "pred3_uint16":
        data = rf.write_tiff(g16, 1, compression=8, predictor=3)
    elif case == "pred3_uint8":
        data = rf.write_tiff(g, 1, compression=5, predictor=3)
    elif case == "pred3_int32":
        data = rf.write_tiff(g16.astype(np.int32), 1, compression=5,
                             predictor=3, sample_format=2)
    elif case == "pred5":
        data = rf.write_tiff(g, 1, compression=5, predictor=5)
    else:
        data = rf.write_tiff(g, 1, compression=32773, predictor=2)
    same_as_jax(_file(tmp_path, data))


@pytest.mark.parametrize("bits", [1, 2, 4, 12])
@pytest.mark.parametrize("compression", [1, 5])
def test_tiles_inside_a_byte(bits, compression):
    """Tiles whose width is not a whole number of bytes: Pillow's raw
    decoder places them pixel by pixel (an edge tile's stride rounded
    down); its libtiff decoder refuses tiles whose size fails its test."""
    rng = np.random.default_rng(bits)
    for tw in (1, 3, 4, 5, 6, 12):
        s = rng.integers(0, 1 << bits, (7, 11, 1)).astype(
            np.uint8 if bits < 8 else np.uint16)
        same_stage(rf.write_tiff(s, 1, bits=bits, tile=(tw, 4),
                                 compression=compression))


def _open_info_cases():
    out = []
    for key, (mode, raw) in sorted(tiff.OPEN_INFO.items(), key=str):
        order, photo, fmt, fill, bps, extra = key
        if len(set(bps)) == 1:
            out.append(key)
    return out


@pytest.mark.parametrize("key", _open_info_cases(), ids=str)
def test_uncompressed_planar_modes(key):
    """PlanarConfiguration 2 without compression in every mode of
    Pillow's table: each layer unpacked with one letter of the rawmode
    (1, 8 or 32 bits, no inversion or bit reversal), or Pillow's
    ValueError for a letter the mode has no unpacker for."""
    order, photo, fmt, fill, bps, extra = key
    bits, n = bps[0], len(bps)
    dt = {1: np.uint8, 2: np.uint8, 4: np.uint8, 8: np.uint8,
          12: np.uint16, 16: np.uint16, 32: np.uint32}[bits]
    if fmt == (3,):
        dt = np.float32
    elif fmt == (2,):
        dt = {8: np.int8, 16: np.int16, 32: np.int32}.get(bits, dt)
    rng = np.random.default_rng(bits * 10 + photo)
    s = rng.integers(0, 1 << min(bits, 16), (7, 11, n)).astype(dt)
    cmap = rng.integers(0, 65536, (1 << bits, 3)) if photo == 3 else None
    for planar, tile in ((2, None), (2, (8, 4)), (1, None)):
        same_stage(rf.write_tiff(
            s, photo, order=order, planar=planar, tile=tile,
            fill_order=fill if fill != 1 else None,
            sample_format=fmt[0] if fmt != (1,) else None, colormap=cmap,
            extra=extra, bits=bits if bits < 8 or bits == 12 else None))


@pytest.mark.parametrize("order", ["II", "MM"])
@pytest.mark.parametrize("compression", [1, 5, 32773])
@pytest.mark.parametrize("layout", ["strips", "tiles", "planar", "planar_tiles"])
def test_cielab(order, compression, layout):
    """Photometric CIELab: Pillow's "LAB" (signed a and b, or each plane's
    bytes as read) converted to RGB as its LittleCMS transform converts
    it (io/cielab.py)."""
    rng = np.random.default_rng(compression)
    s = rng.integers(0, 256, (9, 13, 3)).astype(np.uint8)
    kw = dict(planar=2 if layout.startswith("planar") else 1,
              tile=(8, 4) if layout.endswith("tiles") else None)
    assert same_stage(rf.write_tiff(s, 8, order=order,
                                    compression=compression,
                                    **kw)) is not None


def test_cielab_libtiff_codecs_and_orientation():
    s = RNG.integers(0, 256, (9, 13, 3)).astype(np.uint8)
    for comp in (34925, 50000, 8):
        assert same_stage(tf.write_libtiff(s, comp, 8, {})) is not None
    assert same_stage(rf.write_tiff(s, 8, orientation=6)) is not None


def _pillow_lab(lab):
    raw = lab.astype(np.uint8).copy()
    raw[:, 1:] ^= 128                    # the "LAB" rawmode's signed a, b
    im = Image.frombytes("LAB", (len(lab), 1), raw.tobytes())
    return np.asarray(im.convert("RGB"))[0]


def test_cielab_values_as_pillow_converts_them():
    """Every (a, b) at six lightnesses, and 50,000 random values."""
    a, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for light in (0, 1, 77, 128, 254, 255):
        lab = np.stack([np.full(65536, light), a.ravel(), b.ravel()], -1) \
            .astype(np.uint8)
        np.testing.assert_array_equal(cielab.lab_to_rgb(lab),
                                      _pillow_lab(lab))
    lab = RNG.integers(0, 256, (50000, 3)).astype(np.uint8)
    np.testing.assert_array_equal(cielab.lab_to_rgb(lab), _pillow_lab(lab))


def test_cielab_table_is_littlecms():
    """The 33^3 table equals LittleCMS's own pipeline (Pillow's copy,
    through ctypes, without optimisation) at the table's nodes."""
    import ctypes
    import glob
    import os
    import PIL
    from PIL import ImageCms  # noqa: F401 - loads the library it needs
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                        "pillow.libs")
    found = glob.glob(os.path.join(libs, "liblcms2*.so*"))
    if not found:
        pytest.skip("Pillow has no bundled LittleCMS here")
    lc = ctypes.CDLL(found[0])
    vp = ctypes.c_void_p
    lc.cmsCreateLab2Profile.restype = vp
    lc.cmsCreateLab2Profile.argtypes = [vp]
    lc.cmsCreate_sRGBProfile.restype = vp
    lc.cmsCreateTransform.restype = vp
    lc.cmsCreateTransform.argtypes = [vp, ctypes.c_uint32, vp,
                                      ctypes.c_uint32, ctypes.c_uint32,
                                      ctypes.c_uint32]
    lc.cmsDoTransform.argtypes = [vp, vp, vp, ctypes.c_uint32]
    lab16 = (10 << 16) | (3 << 3) | 2            # TYPE_Lab_16
    rgb16 = (4 << 16) | (3 << 3) | 2             # TYPE_RGB_16
    xform = lc.cmsCreateTransform(lc.cmsCreateLab2Profile(None), lab16,
                                  lc.cmsCreate_sRGBProfile(), rgb16, 0,
                                  0x0100)        # cmsFLAGS_NOOPTIMIZE
    q = np.floor(np.arange(33) * 65535.0 / 32 + 0.5).astype(np.uint16)
    grid = np.ascontiguousarray(np.stack(np.meshgrid(q, q, q, indexing="ij"),
                                         -1).reshape(-1, 3))
    out = np.zeros_like(grid)
    lc.cmsDoTransform(xform, grid.ctypes.data, out.ctypes.data, len(grid))
    np.testing.assert_array_equal(cielab.table().reshape(-1, 3), out)


# ------------------------------------------------------ old-style JPEG ----
def _smooth(h, w, seed):
    rng = np.random.default_rng(seed)
    return np.clip(np.cumsum(rng.integers(0, 256, (h, w, 3)), 1) // 8, 0,
                   255).astype(np.uint8)


@pytest.mark.parametrize("sampling", [(2, 2), (2, 1), (1, 1)])
@pytest.mark.parametrize("rows", [None, 16, 8, 24])
def test_ojpeg_tables_in_tags(sampling, rows):
    """Strips of entropy-coded data with JPEGQTables, JPEGDCTables and
    JPEGACTables: the stream libtiff builds (a restart interval of a
    strip's MCUs, an RST between strips; strips not a whole number of MCU
    rows fail)."""
    img = _smooth(40, 37, 3)
    for restart in (None, 0, 3) if rows else (None, 0, 100):
        same_stage(tf.ojpeg_tags_tiff(img, sampling, rows=rows,
                                      restart=restart))


@pytest.mark.parametrize("case", ["grey", "grey_rows8", "lossless_proc",
                                  "rgb_photometric", "no_qtables",
                                  "short_dc_table"])
def test_ojpeg_tables_in_tags_variants(case):
    img = _smooth(40, 37, 4)
    if case == "grey":
        data = tf.ojpeg_tags_tiff(img[..., 0], photometric=1)
    elif case == "grey_rows8":
        data = tf.ojpeg_tags_tiff(img[..., 0], photometric=1, rows=8)
    elif case == "lossless_proc":
        data = tf.ojpeg_tags_tiff(img, proc=14)   # JPEGProc is not read
    elif case == "rgb_photometric":
        data = tf.ojpeg_tags_tiff(img, (1, 1), photometric=2)
    elif case == "no_qtables":
        data = tf.ojpeg_tags_tiff(img, extra={519: ("I", [0])})
    else:
        data = tf.ojpeg_tags_tiff(
            img, tables=lambda q, dc, ac: (q, [d[:10] for d in dc], ac))
    same_stage(data)


def _retag(data, tag, val):
    d = bytearray(data)
    ifd = struct.unpack_from("<I", d, 4)[0]
    for i in range(struct.unpack_from("<H", d, ifd)[0]):
        at = ifd + 2 + 12 * i
        t, typ = struct.unpack_from("<HH", d, at)
        if t == tag:
            struct.pack_into("<I" if typ == 4 else "<H", d, at + 8, val)
    return bytes(d)


@pytest.mark.parametrize("case", ["width_smaller", "width_larger",
                                  "height_smaller", "height_larger",
                                  "grey_stream_three_samples",
                                  "three_components_one_sample"])
def test_ojpeg_stream_against_tags(case):
    """A stream whose size or component count differs from the tags: a
    stream taller than the image is read to its height, the rest fail."""
    img = _smooth(40, 37, 5)
    base = jf.tiff_ojpeg(img, (2, 2))
    if case == "width_smaller":
        data = _retag(base, 256, 32)
    elif case == "width_larger":
        data = _retag(base, 256, 48)
    elif case == "height_smaller":
        for h in (1, 15, 17, 33):
            same_stage(_retag(base, 257, h))
        return
    elif case == "height_larger":
        data = _retag(base, 257, 48)
    elif case == "grey_stream_three_samples":
        data = _retag(_retag(jf.tiff_ojpeg(img[..., 0], photometric=1),
                             277, 3), 262, 6)
    else:
        data = _retag(_retag(base, 277, 1), 258, 8)
    same_stage(data)


@pytest.mark.parametrize("photometric", [0, 1, 3, 5, 8])
def test_ojpeg_three_components_under_another_photometric(photometric):
    """TIFFRGBAImage has no three-sample form of these: OSError."""
    same_stage(tf.ojpeg_tags_tiff(_smooth(16, 16, 6), (1, 1),
                                  photometric=photometric))


@pytest.mark.parametrize("sampling", [
    ((2, 2), (2, 2), (2, 2)), ((2, 2), (2, 1), (1, 1)),
    ((2, 2), (1, 2), (1, 2)), ((3, 1), (1, 1), (1, 1)),
    ((4, 4), (1, 1), (1, 1)), ((1, 4), (1, 1), (1, 1)),
    ((4, 2), (1, 1), (1, 1)), ((1, 2), (1, 1), (1, 1))])
def test_ojpeg_chroma_libtiff_would_desubsample(sampling):
    """Chroma sampled other than 1 x 1, or luma factors outside libtiff's
    set (and past libjpeg's 10 blocks an MCU): refused as Pillow refuses
    them; the standard factors decode."""
    img = _smooth(40, 37, 7)
    stream = jf.huffman_jpeg([img[..., k] for k in range(3)], sampling)
    tags = {256: (4, [37]), 257: (4, [40]), 258: (3, [8, 8, 8]),
            259: (3, [6]), 262: (3, [6]), 277: (3, [3]), 278: (4, [40]),
            284: (3, [1]), 530: (3, [2, 2])}
    same_stage(jf._assemble(tags, [stream], False, 37, 40, "II", jif=True))


@pytest.mark.parametrize("sampling", [(2, 2), (2, 1), (1, 2), (4, 2),
                                      (4, 4), (4, 1), (1, 1)])
def test_ycbcr_tiles_of_any_width(sampling):
    """Deflate YCbCr tiles through TIFFRGBAImage: an edge tile's hidden
    units skipped as its put routine skips them (rounded down to whole
    units, and the 4 x 4 routine's 10-byte units)."""
    import zlib
    hs, vs = sampling
    rng = np.random.default_rng(hs * 10 + vs)
    for tw, th in ((3, 4), (5, 4), (6, 4), (16, 16), (9, 8)):
        for w, h in ((11, 7), (16, 9)):
            size = -(-tw // hs) * -(-th // vs) * (hs * vs + 2)
            n = -(-w // tw) * -(-h // th)
            chunks = [zlib.compress(bytes(rng.integers(0, 256, size,
                                                       dtype=np.uint8)))
                      for _ in range(n)]
            assert same_stage(tf.tiff_chunks(
                (h, w, 3), 8, 6, 8, chunks, tile=(tw, th),
                extra={530: ("H", [hs, vs])})) is not None
