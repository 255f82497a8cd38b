"""The port's EXR codecs (liverrenderer_tpu_torch/io/exr.py) against files
written by the system OpenEXR library, read by the port and by the JAX
package's native reader (liverrenderer_tpu.io.image.read_exr_any, which
reads through the same library): equal bit for bit, NaN-aware, for every
codec (none, RLE, ZIPS, ZIP, PIZ, PXR24, B44, B44A), layout (scanline,
tiled one level, mip- and ripmaps rounding down and up, two parts) and
pixel type (half, float, uint), at odd sizes so that no chunk or tile is
full, with a data window away from the origin.  The lossless codecs also
give back the source arrays.

The writer is tests/torch_exr_writer.cpp, compiled here with g++ against
the system OpenEXR; without its headers or g++ the tests that need it
skip.  The committed PIZ sky (tests/data/torch_sky_piz.exr) needs neither.
"""
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from liverrenderer_tpu.io import image as jimage
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.io import exr as texr
from liverrenderer_tpu_torch.scene.liver_proxy import sky_map
from torch_threads import torch_threads_per_worker  # noqa: F401

HERE = Path(__file__).resolve().parent
SKY = HERE / "data" / "torch_sky_piz.exr"
SRC = HERE / "torch_exr_writer.cpp"
# native/Makefile's flags
CXXFLAGS = ["-O2", "-std=c++17", "-Wall", "-I/usr/include/OpenEXR",
            "-I/usr/include/Imath"]
LIBS = ["-lOpenEXR-3_1", "-lImath-3_1", "-lIex-3_1", "-lIlmThread-3_1",
        "-lz"]
LOSSLESS = ("none", "rle", "zips", "zip", "piz")
CODECS = LOSSLESS + ("pxr24", "b44", "b44a")
LAYOUTS = ("scanline", "tiled", "mipmap_down", "mipmap_up", "ripmap_down",
           "ripmap_up", "multipart")
W, H, X0, Y0 = 37, 23, 5, -3
_TYPE = {np.dtype(np.float16): "half", np.dtype(np.float32): "float",
         np.dtype(np.uint32): "uint"}


@pytest.fixture(scope="module")
def exr_writer(tmp_path_factory):
    """The helper, compiled into a temporary directory."""
    if not os.path.exists("/usr/include/OpenEXR/ImfOutputFile.h"):
        pytest.skip("the system OpenEXR headers are not installed")
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the OpenEXR writer")
    exe = tmp_path_factory.mktemp("exr_writer") / "exr_writer"
    subprocess.run(["g++", *CXXFLAGS, "-o", str(exe), str(SRC), *LIBS],
                   check=True, capture_output=True)
    return exe


def write_with_openexr(exe, path, channels, compression, layout="scanline",
                       origin=(0, 0), linear=(), counts=None):
    """channels: {name: (h, w) float16, float32 or uint32 array}; linear:
    the names flagged pLinear; a deep layout takes the (h, w) sample
    `counts` and each channel's samples as a flat array."""
    path = Path(path)
    h, w = (counts if counts is not None
            else next(iter(channels.values()))).shape
    man = path.with_suffix(".manifest")
    data = path.with_suffix(".raw")
    man.write_text("".join(f"{n} {_TYPE[a.dtype]} {int(n in linear)}\n"
                           for n, a in channels.items()))
    head = b"" if counts is None else counts.astype(np.uint32).tobytes()
    data.write_bytes(head + b"".join(np.ascontiguousarray(a).tobytes()
                                     for a in channels.values()))
    subprocess.run([str(exe), str(path), compression, layout,
                    str(origin[0]), str(origin[1]), str(w), str(h), str(man),
                    str(data)], check=True, capture_output=True)


def _nan_equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    assert same.all(), np.argwhere(~same)[:5]


def _native_available():
    from liverrenderer_tpu import _native
    if not _native.available():
        pytest.skip("the JAX package's native reader (liblrt.so) is not "
                    "built")


def _channels(seed):
    """Seeded half, float and uint channels at W x H: normal values,
    zeros, negatives, infinities and a NaN in the floats."""
    rng = np.random.default_rng(seed)
    f = (rng.standard_normal((H, W)) * 10 ** rng.uniform(-3, 3, (H, W)))
    f = f.astype(np.float32)
    f[0, :4] = [0.0, -0.0, np.inf, np.nan]
    hf = (rng.standard_normal((H, W)) * 4).astype(np.float16)
    hf[1, :3] = [np.inf, -np.inf, 0]
    u = rng.integers(0, 2 ** 32, (H, W), dtype=np.uint64).astype(np.uint32)
    return {"A": hf, "G": f, "R": hf[::-1].copy(), "Z": u}


def test_committed_piz_sky_is_the_sky():
    """The committed PIZ fixture decodes to sky_map(1024, 512) in half
    through the port's reader (its C++ Huffman loop) and the JAX
    package's native reader."""
    ref = sky_map(1024, 512).astype(np.float16).astype(np.float32)
    got = texr.read_exr_any(str(SKY))
    _nan_equal(got, ref)
    assert os.path.getsize(SKY) < 300_000
    _native_available()
    _nan_equal(jimage.read_exr_any(str(SKY)), ref)


def test_piz_huffman_native_equals_plain(monkeypatch):
    """The C++ Huffman loop and its plain Python version decode the
    committed sky's chunks to the same words."""
    with open(SKY, "rb") as f:
        buf = f.read()
    hdr, chunks = texr._chunks(buf, str(SKY))
    chans = sorted(hdr["channels"])
    native = [texr._piz(raw, chans, nx, ny)
              for _, _, nx, ny, raw in chunks[:6]]
    monkeypatch.setattr(texr, "_huf_decode_native", texr._huf_decode_plain)
    for a, (_, _, nx, ny, raw) in zip(native, chunks[:6]):
        b = texr._piz(raw, chans, nx, ny)
        for c in a:
            np.testing.assert_array_equal(a[c].view(np.uint16),
                                          b[c].view(np.uint16))


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_codec_layout_matches_native_reader(exr_writer, tmp_path, codec,
                                            layout):
    """Every codec in every layout: the port's read equals the native
    reader's bit for bit; the lossless codecs also give back the
    source."""
    _native_available()
    chans = _channels(LAYOUTS.index(layout) * 10 + CODECS.index(codec))
    path = tmp_path / f"{codec}_{layout}.exr"
    write_with_openexr(exr_writer, path, chans, codec, layout, (X0, Y0))
    got = texr.read_exr_any(str(path))
    _nan_equal(got, jimage.read_exr_any(str(path)))
    names, out = texr.read_channels(str(path))
    assert names == sorted(chans)
    if codec in LOSSLESS:
        for n, a in chans.items():
            _nan_equal(out[n], a.astype(np.float32))


@pytest.mark.parametrize("codec", ("piz", "b44", "b44a"))
def test_wide_half_range_and_plinear(exr_writer, tmp_path, codec):
    """More than 2^14 distinct half values (PIZ's 16-bit wavelet), and a
    pLinear half channel (B44's log table), against the native reader."""
    _native_available()
    rng = np.random.default_rng(7)
    every = np.arange(1 << 16, dtype=np.uint16)[rng.permutation(1 << 16)]
    wide = every.reshape(256, 256).view(np.float16)
    chans = {"B": wide, "G": wide[::-1].copy(), "R": wide.T.copy()}
    path = tmp_path / f"wide_{codec}.exr"
    write_with_openexr(exr_writer, path, chans, codec, "scanline",
                       linear=("G",) if codec != "piz" else ())
    _nan_equal(texr.read_exr_any(str(path)), jimage.read_exr_any(str(path)))
    if codec == "piz":
        _, out = texr.read_channels(str(path))
        for n, a in chans.items():
            _nan_equal(out[n], a.astype(np.float32))


def test_y_and_other_channel_sets(exr_writer, tmp_path):
    """Y alone reads as grey; channels without R, G, B in file order;
    alpha kept; read_exr drops alpha - as the native reader orders
    them."""
    _native_available()
    rng = np.random.default_rng(3)
    y = rng.standard_normal((H, W)).astype(np.float16)
    for chans in ({"Y": y}, {"X": y, "W": y[::-1].copy()},
                  {"A": y, "B": y, "G": y, "R": y}):
        path = tmp_path / ("_".join(chans) + ".exr")
        write_with_openexr(exr_writer, path, chans, "piz")
        _nan_equal(texr.read_exr_any(str(path)),
                   jimage.read_exr_any(str(path)))
    assert texr.read_exr(str(path)).shape == (H, W, 3)


def test_dwa_and_deep_still_raise(exr_writer, tmp_path):
    """DWA compression now decodes as the native reader decodes it
    (tests/test_torch_exr_dwa.py has the codec's cases); a file whose
    version claims deep data without a deep part type still raises
    OSError, as the native reader's does."""
    _native_available()
    chans = {"R": np.ones((H, W), np.float16)}
    path = tmp_path / "dwaa.exr"
    write_with_openexr(exr_writer, path, chans, "dwaa")
    _nan_equal(texr.read_exr_any(str(path)), jimage.read_exr_any(str(path)))
    deep = tmp_path / "deep.exr"
    write_with_openexr(exr_writer, deep, chans, "zip")
    buf = bytearray(deep.read_bytes())
    buf[5] |= 0x08                  # the version's deep flag
    deep.write_bytes(bytes(buf))
    with pytest.raises(OSError):
        jimage.read_exr_any(str(deep))
    with pytest.raises(OSError, match="deep"):
        texr.read_exr_any(str(deep))


def test_piz_sky_loads_as_an_envmap(tmp_path):
    """The main path's scene with the PIZ sky in place of its ZIP twin:
    load_file builds the same envmap bitmap."""
    import torch_xml_files as xf
    xml, _ = xf.write_proxy_files(str(tmp_path / "zip"), 8, 6, 1, 1,
                                  bump_res=16, sky=(1024, 512))
    piz, _ = xf.write_proxy_files(str(tmp_path / "piz"), 8, 6, 1, 1,
                                  bump_res=16, sky_file=SKY)
    a = lrt.load_file(xml, device="cpu")
    b = lrt.load_file(piz, device="cpu")
    assert np.array_equal(a.textures.bitmaps.numpy(),
                          b.textures.bitmaps.numpy())
