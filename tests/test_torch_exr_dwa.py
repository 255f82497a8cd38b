"""The port's DWAA/DWAB decoder and its deep and subsampled files
(liverrenderer_tpu_torch/io/exr.py) against files written by the system
OpenEXR library (tests/torch_exr_writer.cpp) and read by the JAX package's
native reader (liverrenderer_tpu.io.image.read_exr_any, which reads
through the same library): equal bit for bit, NaN-aware.

DWA: scanline and tiled, both codecs at three levels, half and float
lossy channels (an R, G, B set through Y'CbCr, a lone Y, pLinear set and
unset), run-length (A, a uint id) and UNKNOWN (Z, float) channels, layer
prefixes, zeros, negatives, infinities and a NaN, at odd sizes with a data
window off the origin; the AC stream's Huffman loop in C++ and in plain
Python.  Deep scanline parts flatten as Imf::InputFile's compositor
flattens them; deep tiled parts, deep parts without Z or A, and
subsampled (luminance/chroma) files raise OSError in both packages.

The committed DWAA sky (tests/data/torch_sky_dwaa.exr, liver_proxy's
1,024 x 512 sky at DWA level 45) decodes as the native reader decodes it,
and the oracle's own decode lies within DWA_SKY_MAX_REL / DWA_SKY_MEAN_REL
of the PIZ sky: the lossy bound chip_smoke.py's card phase holds.
"""
import numpy as np
import pytest

from liverrenderer_tpu.io import image as jimage
from liverrenderer_tpu_torch.io import exr as texr
from test_torch_exr_codecs import (HERE, SKY, W, H, X0, Y0, _nan_equal,
                                   _native_available, exr_writer,  # noqa
                                   write_with_openexr)
from torch_threads import torch_threads_per_worker  # noqa: F401

SKY_DWA = HERE / "data" / "torch_sky_dwaa.exr"
# the oracle's DWAA-45 sky against the PIZ sky (measured: max 1.0178e-2,
# mean 6.98e-4 relative)
DWA_SKY_MAX_REL, DWA_SKY_MEAN_REL = 0.0102, 7.0e-4


def _same_as_native(path):
    _nan_equal(texr.read_exr_any(str(path)), jimage.read_exr_any(str(path)))


def _rgb(rng, h=H, w=W, scale=2.0):
    """Smooth fields plus noise (so blocks carry AC values), a few zeros,
    negatives, infinities and a NaN."""
    yy, xx = np.mgrid[0:h, 0:w]
    out = {}
    for i, c in enumerate("RGB"):
        v = scale * (1.1 + np.sin(xx / (3.0 + i) + yy / 5.0)) \
            + rng.normal(0, 0.2, (h, w))
        out[c] = v.astype(np.float16)
    out["R"][0, :3] = [0, -0.5, 3e4]
    out["G"][1, :2] = [np.inf, -np.inf]
    out["B"][2, 0] = np.nan
    return out


@pytest.mark.parametrize("codec", ["dwaa", "dwab", "dwaa:5", "dwab:200"])
@pytest.mark.parametrize("layout", ["scanline", "tiled", "mipmap_down"])
def test_dwa_rgba_matches_native(exr_writer, tmp_path, codec, layout):
    """An R, G, B set (Y'CbCr through the to-linear table) with A (RLE)
    and Z (UNKNOWN)."""
    _native_available()
    rng = np.random.default_rng(len(codec) * 7 + len(layout))
    chans = _rgb(rng)
    chans["A"] = rng.random((H, W)).astype(np.float16)
    chans["Z"] = rng.normal(0, 10, (H, W)).astype(np.float32)
    path = tmp_path / "rgba.exr"
    write_with_openexr(exr_writer, path, chans, codec, layout, (X0, Y0))
    _same_as_native(path)
    _, out = texr.read_channels(str(path))
    _nan_equal(out["Z"], chans["Z"])             # UNKNOWN is lossless
    _nan_equal(out["A"], chans["A"].astype(np.float32))


@pytest.mark.parametrize("linear", [(), ("Y",), ("R", "G", "B")])
def test_dwa_plinear_and_lone_channels(exr_writer, tmp_path, linear):
    """pLinear on a lone lossy channel skips the to-linear table; an R, G,
    B set takes it whatever its flags say."""
    _native_available()
    rng = np.random.default_rng(len(linear))
    chans = _rgb(rng, 61, 45)
    chans["Y"] = (rng.random((61, 45)) * 3).astype(np.float16)
    path = tmp_path / "lin.exr"
    write_with_openexr(exr_writer, path, chans, "dwaa", "scanline",
                       (3, 7), linear=linear)
    _same_as_native(path)
    names, out = texr.read_channels(str(path))
    ref = jimage.read_exr_any(str(path))      # R, G, B(, A) of the file
    assert "Y" in names and out["Y"].shape == ref.shape[:2]


def test_dwa_float_layers_and_uint(exr_writer, tmp_path):
    """Float lossy channels, two layers' R, G, B sets (each its own
    prefix), a lone G (no set), and a uint A (RLE)."""
    _native_available()
    rng = np.random.default_rng(11)
    base = _rgb(rng, 40, 33)
    chans = {f"diffuse.{c}": v.astype(np.float32) for c, v in base.items()}
    chans.update({f"spec.{c}": v[::-1].copy() for c, v in base.items()})
    chans["other.G"] = base["G"]
    chans["A"] = rng.integers(0, 2 ** 32, (40, 33),
                              dtype=np.uint64).astype(np.uint32)
    path = tmp_path / "layers.exr"
    write_with_openexr(exr_writer, path, chans, "dwab:60", "scanline",
                       (X0, Y0))
    names, out = texr.read_channels(str(path))
    assert names == sorted(chans)
    ref = jimage.read_exr_any(str(path))
    _nan_equal(np.stack([out[n] for n in names], -1), ref)
    _nan_equal(out["A"], chans["A"].astype(np.float32))


def test_dwa_huffman_native_equals_plain(monkeypatch):
    """The committed DWAA sky's AC streams through the C++ Huffman loop and
    its plain Python version."""
    native = texr.read_exr_any(str(SKY_DWA))
    monkeypatch.setattr(texr, "_huf_decode_native", texr._huf_decode_plain)
    _nan_equal(texr.read_exr_any(str(SKY_DWA)), native)


def test_dwa_ac_unpack_runs_and_end_of_block():
    """0xff00 ends a block, 0xffNN skips NN zeros, the last value written
    is each block's last position, and a block may end without 0xff00."""
    ac = np.array([0x3C00, 0xFF03, 0x4000, 0xFF00,            # block 0
                   0xFF00,                                    # block 1
                   *([0x3800] * 63),                          # block 2
                   0xFF3E, 0x0001], np.uint16)                # block 3
    out, last, used = texr._dwa_unpack_ac(ac, 4)
    assert used == len(ac)
    assert out[0, 1] == 0x3C00 and out[0, 5] == 0x4000 and last[0] == 5
    assert not out[1].any() and last[1] == 0
    assert (out[2, 1:] == 0x3800).all() and last[2] == 63
    assert out[3, 63] == 1 and last[3] == 63
    with pytest.raises(ValueError):
        texr._dwa_unpack_ac(ac[:-1], 4)


def test_committed_dwa_sky(exr_writer):
    """The committed DWAA sky: the native reader's decode, within the
    lossy bound of the PIZ sky."""
    got = texr.read_exr_any(str(SKY_DWA))
    assert SKY_DWA.stat().st_size < 400_000
    piz = texr.read_exr_any(str(SKY))
    _native_available()
    ref = jimage.read_exr_any(str(SKY_DWA))
    _nan_equal(got, ref)
    rel = np.abs(ref - piz) / np.maximum(np.abs(piz), 1e-6)
    assert rel.max() <= DWA_SKY_MAX_REL and rel.mean() <= DWA_SKY_MEAN_REL


# ---------------------------------------------------------------- deep ----
def _deep(rng, counts, chans):
    n = int(counts.sum())
    out = {}
    for name, kind in chans.items():
        if kind == "uint":
            out[name] = rng.integers(0, 99, n).astype(np.uint32)
        else:
            v = rng.random(n) * (1.3 if name == "A" else 1.0)
            out[name] = v.astype(np.float16 if kind == "half"
                                 else np.float32)
    return out


@pytest.mark.parametrize("codec", ["none", "rle", "zips"])
@pytest.mark.parametrize("chans", [
    {"A": "half", "B": "half", "G": "float", "R": "half", "Z": "float",
     "id": "uint"},
    {"A": "half", "Z": "float", "foo": "half"},
    {"A": "float", "R": "half", "G": "half", "B": "half", "Z": "float",
     "ZBack": "float"}])
def test_deep_scanline_composites_as_native(exr_writer, tmp_path, codec,
                                            chans):
    """Samples in stored order, every channel (Z too) summed by 'over' on
    A until A reaches 1; pixels without samples are 0."""
    _native_available()
    rng = np.random.default_rng(len(chans) + len(codec))
    counts = rng.integers(0, 5, (H, W))
    data = _deep(rng, counts, chans)
    path = tmp_path / "deep.exr"
    write_with_openexr(exr_writer, path, data, codec, "deep_scanline",
                       (X0, Y0), counts=counts)
    _same_as_native(path)


@pytest.mark.parametrize("case", ["deep_tiled", "no_z", "no_a", "yc"])
def test_files_the_native_reader_refuses(exr_writer, tmp_path, case):
    """A deep tiled part, deep data without Z or A, and a luminance/chroma
    file (2 x 2 subsampled RY, BY) raise OSError in both packages."""
    _native_available()
    rng = np.random.default_rng(5)
    path = tmp_path / f"{case}.exr"
    if case == "yc":
        chans = {c: rng.random((22, 36)).astype(np.float16) for c in "RGB"}
        write_with_openexr(exr_writer, path, chans, "zip", "yc", (4, -2))
    else:
        counts = rng.integers(0, 3, (H, W))
        kinds = {"A": "half", "R": "half", "Z": "float"}
        kinds.pop({"no_z": "Z", "no_a": "A"}.get(case, "R"))
        data = _deep(rng, counts, kinds)
        layout = "deep_tiled" if case == "deep_tiled" else "deep_scanline"
        write_with_openexr(exr_writer, path, data, "zips", layout, (X0, Y0),
                           counts=counts)
    with pytest.raises(OSError):
        jimage.read_exr_any(str(path))
    with pytest.raises(OSError):
        texr.read_exr_any(str(path))
