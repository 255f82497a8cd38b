"""The port's JPEG decoder and encoder (liverrenderer_tpu_torch/io/
jpeg.py, through read_image and write_image) against the JAX package,
which reads and writes JPEG through PIL (libjpeg-turbo): decoded pixels
equal bit for bit, and written files equal byte for byte.

Decoded: PIL's files at 4:4:4, 4:2:2 and 4:2:0, grey, qualities 5-100,
optimized Huffman tables, progressive (spectral selection and successive
approximation, refinement scans included), restart intervals (in blocks
and in rows, baseline and progressive), RGB with an Adobe marker, odd and
tiny sizes; the port's encoder's files at the samplings PIL does not
write (1h2v, 4h1v, 3h1v, mixed chroma factors); hand-edited bytes (fill
0xFFs before markers, an APPn segment between scans).  The C++ entropy
loop and its plain Python version give the same coefficients.  An
arithmetic-coded and a four-component (CMYK) file decode as the JAX
package decodes them; a 12-bit file is refused as Pillow refuses it
(tests/test_torch_jpeg_kinds.py holds the rest of those kinds).
"""
import io

import numpy as np
import pytest
from PIL import Image

import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu.io import image as jimage
from liverrenderer_tpu_torch.io import jpeg
from torch_threads import torch_threads_per_worker  # noqa: F401

H, W = 23, 37


def _image(seed, h=H, w=W):
    """Smooth colour gradients plus noise: chroma with structure."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 7) % 256, (yy * 11) % 256, ((xx + yy) * 5) % 256],
                   -1)
    return np.clip(img + rng.integers(-30, 30, img.shape), 0,
                   255).astype(np.uint8)


def _pil_jpeg(arr, **kw) -> bytes:
    f = io.BytesIO()
    Image.fromarray(arr).save(f, "JPEG", **kw)
    return f.getvalue()


def _check(tmp_path, data: bytes, plain=True):
    """The port reads the bytes as the JAX package does (linear and raw),
    with the C++ and the plain entropy loop."""
    p = tmp_path / "a.jpg"
    p.write_bytes(data)
    for srgb in (True, False):
        np.testing.assert_array_equal(lrt.read_image(str(p), srgb),
                                      jimage.read_image(str(p), srgb))
    if plain:
        np.testing.assert_array_equal(jpeg.read_jpeg(data, jpeg._scan_plain),
                                      jpeg.read_jpeg(data))


def _scans(data: bytes):
    """(Ss, Se, Ah, Al) of each scan header."""
    out, pos = [], 2
    while pos < len(data) - 1:
        if data[pos] != 0xFF or data[pos + 1] in (0x00, 0xFF) \
                or 0xD0 <= data[pos + 1] <= 0xD9:
            pos += 1
            continue
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] == 0xDA:
            seg = data[pos + 4:pos + 2 + n]
            ns = seg[0]
            out.append((seg[1 + 2 * ns], seg[2 + 2 * ns],
                        seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15))
        pos += 2 + n
    return out


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [5, 75, 100])
def test_pil_baseline(tmp_path, subsampling, quality):
    _check(tmp_path, _pil_jpeg(_image(quality), subsampling=subsampling,
                               quality=quality))


@pytest.mark.parametrize("opts", [
    {"optimize": True}, {"progressive": True},
    {"progressive": True, "subsampling": 0, "quality": 95},
    {"restart_marker_blocks": 3}, {"restart_marker_rows": 1},
    {"restart_marker_rows": 1, "progressive": True},
    {"keep_rgb": True}, {"keep_rgb": True, "progressive": True}])
def test_pil_options(tmp_path, opts):
    data = _pil_jpeg(_image(len(opts)), **opts)
    if opts.get("progressive"):       # refinement scans are in the file
        assert any(ah > 0 and ss > 0 for ss, _, ah, _ in _scans(data))
        assert any(ah > 0 and ss == 0 for ss, _, ah, _ in _scans(data))
    _check(tmp_path, data)


@pytest.mark.parametrize("progressive", [False, True])
def test_pil_grey(tmp_path, progressive):
    _check(tmp_path, _pil_jpeg(_image(3)[..., 1], progressive=progressive))


@pytest.mark.parametrize("size", [(1, 1), (2, 3), (3, 2), (1, 17), (17, 1),
                                  (16, 16), (33, 9)])
def test_pil_tiny_and_odd_sizes(tmp_path, size):
    h, w = size
    rng = np.random.default_rng(h * 100 + w)
    arr = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    _check(tmp_path, _pil_jpeg(arr))
    _check(tmp_path, _pil_jpeg(arr, progressive=True))


@pytest.mark.parametrize("sampling", [((1, 2), (1, 1), (1, 1)),
                                      ((4, 1), (1, 1), (1, 1)),
                                      ((3, 1), (1, 1), (1, 1)),
                                      ((2, 2), (1, 2), (2, 1)),
                                      ((1, 1), (1, 1), (2, 2))])
def test_samplings_pil_does_not_write(tmp_path, sampling):
    """1h2v fancy upsampling, and the replicating upsampler of the other
    integral factors, through files of the port's encoder."""
    _check(tmp_path, jpeg.encode_jpeg(_image(7, 41, 29), 90, sampling))


def test_fill_bytes_and_segments_between_scans(tmp_path):
    """0xFF fill bytes before a restart marker and before EOI, and a COM
    segment between progressive scans."""
    data = _pil_jpeg(_image(5), restart_marker_blocks=2, progressive=True)
    rst = data.index(b"\xff\xd0")
    eoi = len(data) - 2
    sos2 = data.index(b"\xff\xda", data.index(b"\xff\xda") + 2)
    edited = (data[:rst] + b"\xff\xff" + data[rst:sos2]
              + b"\xff\xfe\x00\x05abc" + data[sos2:eoi] + b"\xff\xff"
              + data[eoi:])
    _check(tmp_path, edited)


def test_plain_loop_is_the_native_loop_at_height_map_size():
    """The committed 1,024^2 height map: the C++ entropy loop against its
    plain version on its first 64 rows of blocks (a cropped copy)."""
    from pathlib import Path
    data = (Path(__file__).parent / "data" / "torch_height.jpg").read_bytes()
    full = jpeg.read_jpeg(data)
    assert full.shape == (1024, 1024, 3)
    crop = jpeg.encode_jpeg(full[:64, :96, 0])
    np.testing.assert_array_equal(jpeg.read_jpeg(crop, jpeg._scan_plain),
                                  jpeg.read_jpeg(crop))
    np.testing.assert_array_equal(
        full, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


@pytest.mark.parametrize("what", ["arithmetic", "12-bit", "cmyk"])
def test_what_it_lacks_raises(tmp_path, what):
    """The kinds this decoder once refused: the SOF9-edited Huffman file
    (libjpeg runs its arithmetic decoder on the Huffman bits) and
    Pillow's CMYK file now decode as the JAX package decodes them; a
    12-bit file is refused as Pillow refuses it, "cannot identify" (an
    OSError), and its header check gives the file up (SyntaxError)."""
    data = bytearray(_pil_jpeg(_image(1)))
    if what == "cmyk":
        f = io.BytesIO()
        Image.fromarray(_image(1)).convert("CMYK").save(f, "JPEG")
        data = bytearray(f.getvalue())
    else:
        sof = data.index(b"\xff\xc0")
        if what == "arithmetic":
            data[sof + 1] = 0xC9
        else:
            data[sof + 4] = 12
    if what == "12-bit":
        p = tmp_path / "a.jpg"
        p.write_bytes(bytes(data))
        with pytest.raises(OSError, match="cannot identify"):
            jimage.read_image(str(p))
        with pytest.raises(OSError, match="cannot identify"):
            lrt.read_image(str(p))
        with pytest.raises(SyntaxError, match="12-bit"):
            jpeg.read_jpeg(bytes(data))
        return
    _check(tmp_path, bytes(data), plain=False)


# --------------------------------------------------------------- writing ----
@pytest.mark.parametrize("ext", [".jpg", ".jpeg"])
@pytest.mark.parametrize("shape", [(23, 37, 3), (64, 48, 3), (1, 1, 3),
                                   (17, 9, 4)])
def test_write_image_jpeg_bytes_match_jax(tmp_path, ext, shape):
    """write_image's JPEG: the bytes PIL writes for the same dithered
    pixels (quality 75, 4:2:0, JFIF); RGBA raises OSError in both."""
    rng = np.random.default_rng(shape[0])
    img = (rng.random(shape) * 1.5).astype(np.float32)
    a, b = tmp_path / f"t{ext}", tmp_path / f"j{ext}"
    if shape[2] == 4:
        with pytest.raises(OSError):
            jimage.write_image(str(b), img)
        with pytest.raises(OSError):
            lrt.write_image(str(a), img)
        return
    lrt.write_image(str(a), img)
    jimage.write_image(str(b), img)
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("quality", [1, 30, 50, 90])
def test_encoder_matches_pil_at_other_qualities_and_grey(quality):
    arr = _image(quality, 45, 61)
    assert jpeg.encode_jpeg(arr, quality) == _pil_jpeg(arr, quality=quality)
    assert jpeg.encode_jpeg(arr[..., 0], quality) == \
        _pil_jpeg(arr[..., 0], quality=quality)
    assert jpeg.encode_jpeg(arr, quality, ((1, 1),) * 3) == \
        _pil_jpeg(arr, quality=quality, subsampling=0)
