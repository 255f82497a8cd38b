"""How the port identifies and refuses files as Pillow 12.1 does
(liverrenderer_tpu_torch/io/image.py), and the small formats it reads and
writes (io/legacy.py, io/ico.py, io/psd.py), each against the JAX
package's read_image / write_image, which go through Pillow: equal bit
for bit (tolerance 0), or the same exception class.

- The registry: the port's plugin order is Pillow's Image.ID, and its
  copy of each plugin's prefix test answers as Pillow's on every probe
  prefix.  A file Pillow opens is never an OSError in the port: for each
  format Pillow saves, in every mode it saves, the port returns the JAX
  package's array or raises NotImplementedError naming "Queue 1 M9".
  PCX, SGI, IM and DIB files (which the port once refused as "cannot
  identify") are read.  TGA is found by trial, as Pillow finds
  it, whatever the file's name; RGBE, text and noise raise OSError.
- The small formats: PCX (1, L, P, RGB at odd and even widths) and a
  DCX page, SGI verbatim and RLE at 8 and 16 bits, IM, Sun raster
  (standard, RGB order, RLE, palette, 1 and 8 bits), XBM, XPM (with an
  unused and a used "None" colour), MSP versions 1 and 2, QOI, ICO and
  CUR (BMP entries at 8, 24 and 32 bits, PNG entries, Pillow's choice
  among several), PSD (raw and RLE composites: grey, RGB, RGBA, CMYK,
  indexed, bitmap, CIELab; 16-bit is refused).
- Writing: .tif, .pcx, .sgi, .im, .dib and .qoi byte-equal to the JAX
  package's write_image at RGB, RGBA and grey; what Pillow refuses
  (an unknown extension, a format without a writer, XBM / MSP / Palm)
  the port refuses with the same exception class, and the WebP and AVIF
  writers, which the port lacks, raise NotImplementedError (M9).
"""
import io
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu.io import image as jimage
from liverrenderer_tpu_torch.io import image as timage
import torch_raster_files as rf
from test_torch_tiff import same_as_jax
from torch_threads import torch_threads_per_worker  # noqa: F401

RNG = np.random.default_rng(29)
RGB = RNG.integers(0, 256, (11, 13, 3)).astype(np.uint8)
RGB_EVEN = RNG.integers(0, 256, (11, 14, 3)).astype(np.uint8)
GREY = RNG.integers(0, 256, (11, 13)).astype(np.uint8)
BITS = RNG.integers(0, 2, (11, 13)).astype(np.uint8)
PAL = RNG.integers(0, 256, (256, 3)).astype(np.uint8)


def _pil_bytes(im, fmt, **kw):
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _read_equal_or_not_ported(path):
    """Pillow opens the file: the port reads it equally, or raises
    not_ported naming M9 (never OSError)."""
    ref = jimage.read_image(str(path), srgb_to_linear=False)
    try:
        img = lrt.read_image(str(path), srgb_to_linear=False)
    except NotImplementedError as e:
        assert "Queue 1 M9" in str(e)
        return False
    np.testing.assert_allclose(img, ref, rtol=0, atol=0)
    return True


# ----------------------------------------------------------- step 0 ----
@pytest.mark.parametrize("fmt", ["PCX", "SGI", "IM", "DIB"])
@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_files_the_port_called_unidentifiable(tmp_path, fmt, mode):
    """PIL-saved .pcx, .sgi, .im and .dib files: read, not refused."""
    p = tmp_path / f"probe.{fmt.lower()}"
    Image.fromarray(RGB).convert(mode).save(p, fmt)
    assert _read_equal_or_not_ported(p)


def test_registry_order_is_pillows():
    """Image.ID as a fresh process builds it in Image.open (preinit, then
    init); a process that imported a plugin module first holds another
    order, so a child process reads it."""
    out = subprocess.run(
        [sys.executable, "-c", "from PIL import Image; Image.preinit(); "
         "Image.init(); print(' '.join(Image.ID))"],
        capture_output=True, text=True, check=True).stdout.split()
    assert [f for f, _, _ in timage._OPEN] == out
    Image.init()
    for fmt, accept, _ in timage._OPEN:
        assert (accept is None) == (Image.OPEN[fmt][1] is None), fmt


def _probe_prefixes():
    rng = np.random.default_rng(30)
    magics = [b"BM", b"GIF87a", b"GIF89a", b"\xff\xd8\xff", b"P6", b"Pf",
              b"Py", b"P7 332", b"\x89PNG\r\n\x1a\n", b"BLP1", b"BUFR",
              b"ZCZC", b"\0\0\2\0", b"\0\0\1\0", b"\x0a\x05", b"\x0a\x01",
              struct.pack("<I", 0x3ADE68B1), b"DDS ", b"%!PS",
              struct.pack("<I", 0xC6D3D0C5), b"SIMPLE", b"FTEX",
              b"GRIB\0\0\0\x01", b"GRIB\0\0\0\x02", b"\x89HDF\r\n\x1a\n",
              b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a",
              b"icns", b"\x00" * 7 + b"\x04", b"\x00\x00\x01\xb3",
              b"II*\x00", b"MM\x00*", b"MM*\x00", b"II\x00*", b"II+\x00",
              b"MM\x00+", b"DanM", b"LinS", b"\x80\xe8\x00\x00", b"8BPS",
              b"qoif", b"\x01\xda", struct.pack(">I", 0x59A66A95),
              b"RIFF\0\0\0\0WEBPVP8 ", b"RIFF\0\0\0\0WEBPVP8L",
              b"RIFF\0\0\0\0WEBPVP9 ", b"\xd7\xcd\xc6\x9a\x00\x00",
              b"\x01\x00\x00\x00", b"  #define", b"/* XPM */",
              b"\0\0\0\x1cftypavif", b"\0\0\0\x1cftypmif1",
              struct.pack("<I", 40), struct.pack("<I", 124),
              struct.pack(">II", 28, 2),
              b"\x00\x00\x00\x14\x00\x00\x00\x01" + b"\x00" * 6 + b"\xaf\x12",
              b"\0" * 4 + b"\x11\xaf" + b"\0" * 10]
    out = [b"", b"B", b"P", b"\0\0"]
    for m in magics:
        out.append(m)
        out.append((m + bytes(rng.integers(0, 256, 16, dtype=np.uint8)))[:16])
    out += [bytes(rng.integers(0, 256, 16, dtype=np.uint8))
            for _ in range(200)]
    return out


def test_prefix_tests_answer_as_pillows():
    Image.init()
    for prefix in _probe_prefixes():
        for fmt, accept, _ in timage._OPEN:
            if accept is None:
                continue
            try:
                want = bool(Image.OPEN[fmt][1](prefix))
            except Exception:            # noqa: BLE001 - Pillow passes on
                want = False
            try:
                got = bool(accept(prefix))
            except (IndexError, struct.error):
                got = False
            assert got == want, (fmt, prefix)


def _saved_formats():
    Image.init()
    return sorted(Image.SAVE)


@pytest.mark.parametrize("fmt", _saved_formats())
def test_every_format_pillow_saves(tmp_path, fmt):
    """Each mode Pillow saves in `fmt`: equal, or not_ported (M9); never
    "cannot identify" where Pillow opens the file."""
    extensions = dict(Image.EXTENSION)
    for mode in ["RGB", "L", "1", "P", "RGBA", "LA", "I", "F", "CMYK",
                 "I;16"]:
        im = Image.fromarray(GREY.astype(np.uint16) * 250) \
            if mode == "I;16" else Image.fromarray(RGB).convert(mode)
        p = tmp_path / f"f_{mode.replace(';', '')}.bin"
        try:
            p.write_bytes(_pil_bytes(im, fmt))
            jimage.read_image(str(p))
        except Exception:                # noqa: BLE001 - Pillow cannot
            continue
        finally:      # Pillow's SPIDER writer registers the file's extension
            Image.EXTENSION.clear()
            Image.EXTENSION.update(extensions)
        ported = _read_equal_or_not_ported(p)
        # every mode of these (CMYK JPEG included) is ported
        assert ported or fmt not in ("JPEG", "JPEG2000", "MPO", "TIFF"), \
            (fmt, mode)


_ID_CASES = {
    "tga_named_bin": ("x.bin", lambda: _pil_bytes(Image.fromarray(RGB),
                                                   "TGA")),
    "grey_tga_named_png": ("x.png", lambda: _pil_bytes(
        Image.fromarray(GREY), "TGA")),
    "rgbe_hdr": ("x.hdr", lambda: b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                 b"-Y 2 +X 2\n" + bytes(16)),
    "noise": ("x.bin", lambda: bytes(RNG.integers(0, 256, 300,
                                                  dtype=np.uint8))),
    "zeros": ("x.bin", lambda: bytes(300)),
    "text": ("x.txt", lambda: b"hello world\nthis is text\n" * 5),
    "empty": ("x.jpg", lambda: b""),
}


@pytest.mark.parametrize("case", sorted(_ID_CASES))
def test_identification_by_content(tmp_path, case):
    name, make = _ID_CASES[case]
    p = tmp_path / name
    p.write_bytes(make())
    same_as_jax(p)


# ---------------------------------------------------- small formats ----
def _psd(mode, rle, **kw):
    ch = {"rgb": RGB.transpose(2, 0, 1),
          "rgba": np.concatenate([RGB, GREY[..., None]], -1).transpose(
              2, 0, 1),
          "grey": GREY[None], "grey_2ch": np.stack([GREY, GREY[::-1]]),
          "cmyk": RNG.integers(0, 256, (4, 11, 13)).astype(np.uint8),
          "indexed": GREY[None],
          "bitmap": np.packbits(BITS, axis=1)[None],
          "rgb16": RGB.transpose(2, 0, 1).astype(">u2"),
          "lab": RGB.transpose(2, 0, 1)}[mode]
    pmode = {"rgb": 3, "rgba": 3, "grey": 1, "grey_2ch": 1, "cmyk": 4,
             "indexed": 2, "bitmap": 0, "rgb16": 3, "lab": 9}[mode]
    bits = {"bitmap": 1, "rgb16": 16}.get(mode, 8)
    return rf.write_psd(ch, pmode, rle, bits=bits,
                        palette=PAL if mode == "indexed" else None)


def _small_cases():
    cases = {}
    for d, rgbo in ((24, False), (24, True), (32, False), (32, True)):
        for rle in (False, True):
            for img, tag in ((RGB, "odd"), (RGB_EVEN, "even")):
                cases[f"sun{d}_{'rgb' if rgbo else 'bgr'}_"
                      f"{'rle' if rle else 'raw'}_{tag}"] = \
                    (lambda i=img, d=d, r=rle, o=rgbo:
                     rf.write_sun(i, d, r, o))
    for rle in (False, True):
        t = "rle" if rle else "raw"
        cases[f"sun8_grey_{t}"] = lambda r=rle: rf.write_sun(GREY, 8, r)
        cases[f"sun8_palette_{t}"] = \
            lambda r=rle: rf.write_sun(GREY, 8, r, palette=PAL)
        cases[f"sun1_{t}"] = lambda r=rle: rf.write_sun(BITS, 1, r)
        for mode in ("rgb", "rgba", "grey", "grey_2ch", "cmyk", "indexed",
                     "bitmap", "rgb16", "lab"):
            cases[f"psd_{mode}_{t}"] = lambda m=mode, r=rle: _psd(m, r)
    for bpc in (1, 2):
        for img, tag in ((RGB, "rgb"), (GREY, "grey"),
                         (np.dstack([RGB, GREY]), "rgba")):
            a = img.astype(np.uint16) * 257 + 3 if bpc == 2 else img
            cases[f"sgi_rle_{bpc * 8}bit_{tag}"] = \
                lambda a=a, b=bpc: rf.write_sgi_rle(a, b)
        cases[f"sgi_raw_{bpc * 8}bit"] = lambda b=bpc: _pil_bytes(
            Image.fromarray(RGB), "SGI", bpc=b)
    pcx = _pil_bytes(Image.fromarray(RGB), "PCX")
    cases["dcx_page_0"] = lambda: struct.pack("<III", 0x3ADE68B1, 12, 0) \
        + pcx
    cases["dcx_without_pages"] = lambda: struct.pack("<II", 0x3ADE68B1, 0)
    for w in (13, 14):
        for mode in ("RGB", "L", "P", "1"):
            cases[f"pcx_{mode}_{w}"] = lambda m=mode, w=w: _pil_bytes(
                Image.fromarray(RNG.integers(0, 256, (9, w, 3)).astype(
                    np.uint8)).convert(m), "PCX")
    cases["msp_v1"] = lambda: _pil_bytes(
        Image.fromarray(BITS * 255).convert("1"), "MSP")
    cases["msp_v2"] = lambda: rf.write_msp2(BITS)
    cases["msp_v2_wide"] = lambda: rf.write_msp2(
        RNG.integers(0, 2, (9, 70)).astype(np.uint8))
    cases["xbm"] = lambda: _pil_bytes(
        Image.fromarray(BITS * 255).convert("1"), "XBM")
    idx = RNG.integers(0, 5, (7, 9)).astype(np.uint8)
    cols = RNG.integers(0, 256, (5, 3)).astype(np.uint8)
    cases["xpm"] = lambda: rf.write_xpm(idx, cols)
    cases["xpm_unused_none"] = lambda: rf.write_xpm(idx, cols, none_key=" ")
    cases["xpm_used_none"] = lambda: rf.write_xpm(
        idx, cols, none_key="z").replace(b'"..', b'"z.', 1)
    for mode in ("RGB", "RGBA", "L"):
        cases[f"qoi_{mode}"] = lambda m=mode: _pil_bytes(
            Image.fromarray(np.dstack([RGB, GREY])).convert(m)
            if m != "L" else Image.fromarray(RGB), "QOI")
        cases[f"im_{mode}"] = lambda m=mode: _pil_bytes(
            Image.fromarray(np.dstack([RGB, GREY])).convert(m), "IM")
    for w, h in ((16, 16), (13, 11)):
        sq = RNG.integers(0, 256, (h, w, 3)).astype(np.uint8)
        for bpp in (24, 32):
            cases[f"ico_bmp{bpp}_{w}x{h}"] = lambda s=sq, b=bpp, w=w, h=h: \
                rf.write_icon([(w, h, b, rf.dib_entry(s, b))])
            cases[f"cur_bmp{bpp}_{w}x{h}"] = lambda s=sq, b=bpp, w=w, h=h: \
                rf.write_icon([(w, h, b, rf.dib_entry(s, b))], cur=True)
        cases[f"ico_bmp8_{w}x{h}"] = lambda s=sq, w=w, h=h: rf.write_icon(
            [(w, h, 8, rf.dib_entry(s[..., 0], 8, PAL))])
        cases[f"ico_png_{w}x{h}"] = lambda s=sq, w=w, h=h: rf.write_icon(
            [(w, h, 32, _pil_bytes(Image.fromarray(s), "PNG"))])
    big = RNG.integers(0, 256, (24, 24, 3)).astype(np.uint8)
    small = RNG.integers(0, 256, (16, 16, 3)).astype(np.uint8)
    cases["ico_choice"] = lambda: rf.write_icon([
        (16, 16, 32, rf.dib_entry(small, 32)),
        (24, 24, 24, rf.dib_entry(big, 24)),
        (24, 24, 32, rf.dib_entry(big[::-1], 32))])
    cases["cur_choice"] = lambda: rf.write_icon([
        (16, 16, 32, rf.dib_entry(small, 32)),
        (24, 24, 24, rf.dib_entry(big, 24))], cur=True)
    cases["ico_pillow"] = lambda: _pil_bytes(Image.fromarray(big), "ICO",
                                             sizes=[(16, 16), (24, 24)])
    return cases


_SMALL = _small_cases()


@pytest.mark.parametrize("case", sorted(_SMALL))
def test_small_formats(tmp_path, case):
    p = tmp_path / "f.bin"
    p.write_bytes(_SMALL[case]())
    same_as_jax(p)


# ---------------------------------------------------------- writing ----
@pytest.mark.parametrize("ext", [".tif", ".tiff", ".pcx", ".sgi", ".bw",
                                 ".im", ".dib", ".qoi"])
@pytest.mark.parametrize("shape", [(5, 7, 3), (6, 8, 4), (1, 1, 3),
                                   (40, 52, 3)])
def test_writers_byte_equal(tmp_path, ext, shape):
    """The port's write_image writes JAX write_image's bytes (SGI and IM
    name the file inside: both under the same name)."""
    img = np.random.default_rng(31).uniform(0, 1.2, shape).astype(
        np.float32)
    img[:, : shape[1] // 2] = 0.25                 # runs for the RLEs
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "jax")
    a, b = tmp_path / "port" / f"out{ext}", tmp_path / "jax" / f"out{ext}"
    try:
        jimage.write_image(str(b), img)
    except Exception as e:               # noqa: BLE001 - Pillow refuses
        with pytest.raises(type(e)):
            lrt.write_image(str(a), img)
        return
    lrt.write_image(str(a), img)
    assert a.read_bytes() == b.read_bytes()
    same_as_jax(a)


@pytest.mark.parametrize("ext", [".pcx", ".sgi", ".im", ".qoi", ".tif"])
def test_grey_writes_are_pillows_l_mode(tmp_path, ext):
    """A (H, W) image: the bytes Pillow saves for the port's 8-bit grey
    pixels (mode L), or Pillow's refusal (QOI)."""
    img = np.random.default_rng(32).uniform(0, 1, (6, 9)).astype(np.float32)
    p = tmp_path / f"out{ext}"
    try:
        ref_px = None
        lrt.write_image(str(p), img)
    except ValueError:
        with pytest.raises(ValueError):
            Image.fromarray(np.zeros((6, 9), np.uint8)).save(
                tmp_path / f"pil{ext}")
        return
    ref_px = np.asarray(Image.open(p).convert("L"))
    q = tmp_path / "pil" / f"out{ext}"
    os.makedirs(q.parent)
    Image.fromarray(ref_px).save(q)
    assert p.read_bytes() == q.read_bytes()


_REFUSED = [".xbm", ".msp", ".palm", ".xyz", "", ".psd", ".cur", ".xpm",
            ".blp", ".bufr", ".wmf", ".h5"]


@pytest.mark.parametrize("ext", _REFUSED)
def test_pillows_refusals(tmp_path, ext):
    img = np.zeros((4, 5, 3), np.float32)
    with pytest.raises(Exception) as jax_err:
        jimage.write_image(str(tmp_path / f"j{ext}"), img)
    with pytest.raises(type(jax_err.value)):
        lrt.write_image(str(tmp_path / f"t{ext}"), img)
    assert not (tmp_path / f"t{ext}").exists()


@pytest.mark.parametrize("ext", [".webp", ".avif"])
def test_writers_still_to_port(tmp_path, ext):
    """Pillow writes these through libwebp's and libaom's encoders, whose
    sources the repository does not hold (ROADMAP M9); the other writers
    are tests/test_torch_pil_writers.py's."""
    with pytest.raises(NotImplementedError, match="Queue 1 M9"):
        lrt.write_image(str(tmp_path / f"t{ext}"),
                        np.zeros((4, 5, 3), np.float32))
