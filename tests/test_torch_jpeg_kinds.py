"""The JPEG kinds the port once refused (liverrenderer_tpu_torch/io/jpeg.py,
io/jpeg_arith.py, io/jpeg_lossless.py, through read_image) against the
JAX package, which reads them through Pillow 12.1 and libjpeg-turbo 3.1:
equal 8-bit values bit for bit (tolerance 0), or the same exception class
at the same stage.  Each decoded kind is also opened and converted by
Pillow on the same bytes, to show that Pillow decodes it.

- Arithmetic coding (tests/torch_jpeg_files.py's T.81 Annex D encoder):
  sequential colour at 4:2:0, 4:2:2 and 4:4:4 and grey, restart
  intervals, a DAC segment, progressive (DC and AC, first and refine
  scans, with restarts), a progressive file cut short (block smoothing),
  Pillow's Huffman file with its SOF0 edited to SOF9, and scans placed
  across and after Pillow's 64 KiB read blocks.  The C++ loop and its
  plain Python version give the same coefficients.
- Lossless (SOF3): predictors 1-7, the point transform, restarts, grey,
  RGB, CMYK and subsampled frames; a JFIF (YCbCr) one and an arithmetic
  one (SOF11) are refused as libjpeg-turbo refuses them.
- Four components: Pillow's CMYK file, Adobe YCCK (transform 2) and CMYK
  (transform 0, and no Adobe marker), a BLP1 file holding a YCCK stream.
- Block smoothing: Pillow's progressive files cut after each scan.
- Refusals: 12-bit and two-component files ("cannot identify"), the
  hierarchical frames ("broken data stream"), a JPG marker where the
  frame should be ("cannot identify"), a BLP1 file with a
  12-bit stream (the plugin's SyntaxError).
"""
import io

import numpy as np
import pytest
from PIL import Image

from liverrenderer_tpu_torch.io import jpeg, jpeg_arith
import torch_bcn_files as bf
import torch_jpeg_files as jf
from test_torch_tiff import same_as_jax
from torch_threads import torch_threads_per_worker  # noqa: F401

H, W = 37, 45


def _rgb(seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 5 + yy * 3) % 256, (xx * xx + yy) % 256,
                    (yy * 7) % 256], -1)
    return np.clip(img + rng.integers(-20, 20, img.shape), 0,
                   255).astype(np.uint8)


def _planes(seed, n=3, h=H, w=W):
    """YCbCr planes of an RGB image (plus a fourth, K-like, plane)."""
    ycc = [np.asarray(p, np.uint8) for p in jpeg._rgb_to_ycc(_rgb(seed, h,
                                                                  w))]
    if n == 4:
        ycc.append(ycc[0][::-1].copy())
    return ycc[:n]


def _pil(arr, **kw) -> bytes:
    f = io.BytesIO()
    Image.fromarray(arr).save(f, "JPEG", **kw)
    return f.getvalue()


def _check(tmp_path, data: bytes, decodes=True, name="a.jpg"):
    """The port's read_image against the JAX package's; `decodes`: Pillow
    decodes these bytes (else it raises, and so does the port)."""
    p = tmp_path / name
    p.write_bytes(data)
    if decodes:
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = same_as_jax(p)
    assert (got is not None) == decodes
    return got


# -------------------------------------------------------- arithmetic ----
_ARITH = {
    "seq_420": dict(),
    "seq_422": dict(sampling=((2, 1), (1, 1), (1, 1))),
    "seq_444": dict(sampling=((1, 1),) * 3, quality=92),
    "seq_grey": dict(n=1),
    "seq_restart": dict(restart=3),
    "seq_dac": dict(dac={(0, 0): 0x52, (1, 0): 2, (0, 1): 0x31,
                         (1, 1): 20}),
    "prog": dict(progressive=True),
    "prog_restart": dict(progressive=True, restart=2),
    "prog_grey": dict(n=1, progressive=True),
    "prog_no_jfif_rgb_ids": dict(progressive=True, jfif=False,
                                 ids=[82, 71, 66]),
}


def _arith(case, seed=3):
    kw = dict(_ARITH[case])
    n = kw.pop("n", 3)
    return jf.arith_jpeg(_planes(seed, n), **kw)


@pytest.mark.parametrize("case", sorted(_ARITH))
def test_arithmetic(tmp_path, case):
    data = _arith(case)
    _check(tmp_path, data)
    np.testing.assert_array_equal(
        jpeg.read_jpeg(data, arith_fn=jpeg_arith._scan_plain),
        jpeg.read_jpeg(data))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_arithmetic_progressive_cut(tmp_path, n):
    """Smoothing on an arithmetic-coded progressive file cut short."""
    _check(tmp_path, jf.scans_cut(_arith("prog", 4), n))


def test_sof9_edited_huffman_file(tmp_path):
    """Pillow's Huffman file with SOF0 made SOF9: libjpeg runs its
    arithmetic decoder on the Huffman bits (its 'Corrupt JPEG data'
    stops the rest of the image)."""
    data = bytearray(_pil(_rgb(1)))
    data[data.index(b"\xff\xc0") + 1] = 0xC9
    _check(tmp_path, bytes(data))


def _coefficients(data, fn):
    st = jpeg._new_state()
    jpeg._parse(data, st, None, fn)
    return st["coefs"]


@pytest.mark.parametrize("case", ["seq_restart", "prog_restart",
                                  "seq_dac"])
def test_arith_native_equals_plain(case):
    data = _arith(case, 6)
    for a, b in zip(_coefficients(data, jpeg_arith._scan_plain),
                    _coefficients(data, jpeg_arith._scan_native)):
        np.testing.assert_array_equal(a, b)


def test_arith_native_equals_plain_on_the_height_map():
    """A crop of the committed 1,024^2 height map, arithmetic-coded."""
    from pathlib import Path
    full = jpeg.read_jpeg((Path(__file__).parent / "data"
                           / "torch_height.jpg").read_bytes())
    data = jf.arith_jpeg([full[:64, :96, 0]], progressive=True, restart=5)
    for a, b in zip(_coefficients(data, jpeg_arith._scan_plain),
                    _coefficients(data, jpeg_arith._scan_native)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("where", ["before", "across", "after"])
def test_arith_pillow_feed(tmp_path, where):
    """Pillow feeds libjpeg 64 KiB at a time, and libjpeg's arithmetic
    decoder cannot wait for more: a scan that needs a byte past the
    blocks read by then is a "broken data stream"; one that ends before
    the first block's end, or starts after it, decodes (comment segments
    move the scan)."""
    import struct
    base = jf.arith_jpeg(_planes(16, 3, 64, 64), quality=90)
    sos = base.index(b"\xff\xda")
    start = sos + 2 + struct.unpack_from(">H", base, sos + 2)[0]
    scan = len(base) - start
    shift = {"before": jpeg.PIL_BLOCK - 100 - len(base),
             "across": jpeg.PIL_BLOCK - start - scan // 2,
             "after": jpeg.PIL_BLOCK + 100 - start}[where]
    pads = [60000, shift - 60004] if shift > 60004 else [shift - 4]
    data = base[:2] + b"".join(b"\xff\xfe" + struct.pack(">H", n + 2)
                               + bytes(n) for n in pads) + base[2:]
    _check(tmp_path, data, decodes=where != "across")


def test_arith_truncated_raises():
    data = _arith("seq_grey")
    with pytest.raises(OSError):
        jpeg.read_jpeg(data[:len(data) // 2])


def test_arith_failed_compile_raises(tmp_path, monkeypatch):
    bad = tmp_path / "jpeg_arith_broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(jpeg_arith, "_SRC", bad)
    monkeypatch.setattr(jpeg_arith, "_LIB", None)
    with pytest.raises(RuntimeError, match="JPEG arithmetic decode"):
        jpeg.read_jpeg(_arith("seq_grey"))


# ---------------------------------------------------------- lossless ----
_LOSSLESS = {f"grey_psv{k}": dict(n=1, psv=k) for k in range(1, 8)}
_LOSSLESS.update({
    "grey_pt3": dict(n=1, psv=1, pt=3),
    "rgb_ids123_pt2": dict(psv=4, pt=2, jfif=False),
    "rgb_ids_rgb": dict(psv=7, jfif=False, ids=[82, 71, 66]),
    "rgb_restart": dict(psv=6, restart_rows=2, jfif=False),
    "grey_restart": dict(n=1, psv=5, restart_rows=3),
    "cmyk": dict(n=4, psv=1, jfif=False),
    "sub_420": dict(sub=((2, 2), (1, 1), (1, 1)), psv=5, jfif=False),
    "sub_422": dict(sub=((2, 1), (1, 1), (1, 1)), psv=2, jfif=False),
    "sub_12": dict(sub=((1, 2), (1, 1), (1, 1)), psv=3, jfif=False),
    "jfif_ycc_refused": dict(psv=1, jfif=True),
})


@pytest.mark.parametrize("case", sorted(_LOSSLESS))
def test_lossless(tmp_path, case):
    kw = dict(_LOSSLESS[case])
    n, sub = kw.pop("n", 3), kw.pop("sub", None)
    planes = _planes(8, n)
    if sub:
        hmax = max(s[0] for s in sub)
        vmax = max(s[1] for s in sub)
        planes = [p[::vmax // v, ::hmax // h] for p, (h, v) in zip(planes,
                                                                    sub)]
        kw["sampling"] = sub
    _check(tmp_path, jf.lossless_jpeg(planes, **kw),
           decodes=case != "jfif_ycc_refused")


def test_lossless_arithmetic_is_refused(tmp_path):
    """SOF11: libjpeg-turbo has no lossless arithmetic decoder."""
    data = bytearray(jf.lossless_jpeg(_planes(9, 1), psv=1))
    data[data.index(b"\xff\xc3") + 1] = 0xCB
    _check(tmp_path, bytes(data), decodes=False)


# ----------------------------------------------------- four components ----
@pytest.mark.parametrize("kind", ["pil_cmyk", "ycck", "ycck_420",
                                  "adobe_cmyk", "plain_cmyk", "arith_ycck"])
def test_four_components(tmp_path, kind):
    planes = _planes(10, 4)
    if kind == "pil_cmyk":
        f = io.BytesIO()
        Image.fromarray(_rgb(10)).convert("CMYK").save(f, "JPEG")
        data = f.getvalue()
    elif kind == "arith_ycck":
        data = jf.arith_jpeg(planes, sampling=((1, 1),) * 4, jfif=False)
        data = data[:2] + b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" \
            b"\x02" + data[2:]
    else:
        samp = ((2, 2), (1, 1), (1, 1), (2, 2)) if kind == "ycck_420" \
            else ((1, 1),) * 4
        adobe = {"ycck": 2, "ycck_420": 2, "adobe_cmyk": 0}.get(kind)
        data = jf.huffman_jpeg(planes, samp, adobe=adobe)
    _check(tmp_path, data)


@pytest.mark.parametrize("adobe", [2, 0])
def test_blp1_four_component_stream(tmp_path, adobe):
    """Pillow's BLP plugin reads a four-component stream with libjpeg
    told it is CMYK (a YCCK stream unconverted), then as "BGR"."""
    data = jf.huffman_jpeg(_planes(11, 4, 16, 16), adobe=adobe)
    blp = bf.blp1(16, 16, data[200:], compression=0, jpeg_header=data[:200])
    _check(tmp_path, blp, name="c.blp")


# --------------------------------------------------- block smoothing ----
@pytest.mark.parametrize("grey", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 9])
def test_progressive_cut_smoothing(tmp_path, n, grey):
    """Pillow's progressive files cut after n scans: libjpeg-turbo's
    block smoothing of what the scans leave inexact."""
    img = _rgb(12)
    data = _pil(img[..., 0] if grey else img, progressive=True)
    if grey and n > 6:
        n = 6
    _check(tmp_path, jf.scans_cut(data, n))


# ----------------------------------------------------------- refusals ----
@pytest.mark.parametrize("edit", ["12-bit", "16-bit", "2-component",
                                  "5-component", "zero-height",
                                  "short-dqt"])
def test_header_refusals(tmp_path, edit):
    """What Pillow's JPEG opener gives up ends as "cannot identify"."""
    data = bytearray(_pil(_rgb(13)))
    sof = data.index(b"\xff\xc0")
    if edit.endswith("-bit"):
        data[sof + 4] = int(edit[:2])
    elif edit.endswith("component"):
        data[sof + 9] = int(edit[0])
    elif edit == "zero-height":
        data[sof + 5:sof + 7] = b"\x00\x00"
    else:
        dqt = data.index(b"\xff\xdb")
        data[dqt + 2:dqt + 4] = b"\x00\x20"
    _check(tmp_path, bytes(data), decodes=False)
    with pytest.raises(SyntaxError):
        jpeg.check_header(bytes(data))


@pytest.mark.parametrize("sof", [0xC5, 0xC6, 0xC7, 0xC8, 0xCD, 0xCE,
                                 0xCF])
def test_hierarchical_refusals(tmp_path, sof):
    """libjpeg-turbo refuses the hierarchical frames at load: Pillow's
    "broken data stream".  Pillow's opener skips a JPG marker (0xC8) as
    bare, finds no frame and gives the file up."""
    data = bytearray(_pil(_rgb(14)))
    data[data.index(b"\xff\xc0") + 1] = sof
    _check(tmp_path, bytes(data), decodes=False)
    if sof == 0xC8:
        with pytest.raises(SyntaxError):
            jpeg.read_jpeg(bytes(data))
        return
    with pytest.raises(OSError, match="broken data stream"):
        jpeg.read_jpeg(bytes(data))


def test_blp1_12_bit_stream(tmp_path):
    """The BLP plugin opens its JPEG directly: the opener's SyntaxError
    reaches the caller."""
    data = bytearray(_pil(_rgb(15, 16, 16)))
    data[data.index(b"\xff\xc0") + 4] = 12
    blp = bf.blp1(16, 16, bytes(data[200:]), compression=0,
                  jpeg_header=bytes(data[:200]))
    _check(tmp_path, blp, decodes=False, name="c.blp")


# ------------------------------------------------- the committed files ----
def _data(name):
    from pathlib import Path
    return Path(__file__).parent / "data" / name


@pytest.mark.parametrize("name", jf.COMMITTED)
def test_committed_files(tmp_path, name):
    """tests/data's arithmetic height maps, YCbCr JPEG-in-TIFF floor and
    CMYK JPEG are their writers' bytes; each decodes as Pillow decodes it,
    the floor and the CMYK file equal to their PNG twins, and the 1,024^2
    map within chip_smoke.py's bound of its 8-bit codes."""
    body = _data(name).read_bytes()
    assert body == jf.committed(name)
    if name.endswith(".png"):
        return
    got = _check(tmp_path, body, name="f" + name[-4:])
    if name.startswith(("torch_floor", "torch_cmyk")):
        twin = same_as_jax(_data(name[:-4] + ".png"))
        np.testing.assert_array_equal(got, twin)
    if name == "torch_height_arith.jpg":
        from liverrenderer_tpu_torch.scene.liver_proxy import BUMP, height_map
        codes = np.round(height_map(BUMP[0], 0) * 255.0).astype(np.int64)
        diff = np.abs(jpeg.read_jpeg(body)[..., 0].astype(np.int64) - codes)
        assert (diff.max(), round(float(diff.mean()), 4)) == (2, 0.1829)
