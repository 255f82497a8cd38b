"""The port's WebP reader (liverrenderer_tpu_torch/io/webp.py, vp8.py,
vp8l.py, through read_image) against the JAX package's read_image, which
reads WebP through Pillow (libwebp's WebPAnimDecoder): equal bit for bit
(tolerance 0) on files Pillow writes and on files libwebp's encoder
writes with settings Pillow does not expose (tests/torch_webp_files.py):
lossy at several qualities and sizes (1 x 1, odd widths, sizes that are
not multiples of 16), the simple and the normal loop filter with each
sharpness, 1-4 segments, 2-8 token partitions (a libwebp file re-encoded, as
libwebp 1.6 writes one), no filter; lossless with
and without a palette (2, 4, 16 and 256 colours), with the exact flag,
near-lossless and every method; lossy RGBA with raw and lossless ALPH and
each alpha filter, and alpha levels; VP8X with ICC, EXIF and XMP chunks;
animations whose first frame is smaller than the canvas.  The alpha
plane equals Pillow's RGBA.  Damaged files raise the exception class the
JAX package raises (OSError).  The C++ loops (VP8 frame, VP8L entropy
image, predictor) equal their plain Python versions.
"""
import io
import struct

import numpy as np
import pytest
from PIL import Image

import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.io import image as pimage
from liverrenderer_tpu_torch.io import vp8, vp8l, webp
import torch_webp_files as wf
from test_torch_tiff import same_as_jax
from torch_threads import torch_threads_per_worker  # noqa: F401


def smooth(h, w, c=3, seed=0):
    """A seeded image of sines plus noise (uint8)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / (5 + 3 * k) + y / (7 + k))
                    + rng.normal(0, 12, (h, w)) for k in range(c)], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def palette_image(h, w, n, seed=0):
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    return pal[rng.integers(0, n, (h, w))]


def pillow_webp(img, **kw):
    b = io.BytesIO()
    Image.fromarray(img).save(b, "WEBP", **kw)
    return b.getvalue()


def check(tmp_path, data, name="f.webp"):
    p = tmp_path / name
    p.write_bytes(data)
    return same_as_jax(p)


def frame_header(data):
    """(simple filter, level, sharpness, segments on, partitions) of a
    lossy file's frame header, read with the port's boolean decoder."""
    body = wf.image_chunks(data)
    off = body.index(b"VP8 ") + 8
    part0 = int.from_bytes(body[off:off + 3], "little") >> 5
    br = vp8._Bool(body[off + 10:off + 10 + part0])
    br.get(2)
    seg = br.get(1)
    if seg:
        upd_map = br.get(1)
        if br.get(1):
            br.get(1)
            for _ in range(4):
                if br.get(1):
                    br.sget(7)
            for _ in range(4):
                if br.get(1):
                    br.sget(6)
        if upd_map:
            for _ in range(3):
                if br.get(1):
                    br.get(8)
    simple, level, sharp = br.get(1), br.get(6), br.get(3)
    if br.get(1) and br.get(1):
        for _ in range(8):
            if br.get(1):
                br.sget(6)
    return simple, level, sharp, seg, 1 << br.get(2)


# ----------------------------------------------------------------- lossy ----
@pytest.mark.parametrize("quality", [0, 10, 50, 75, 95, 100])
def test_lossy_qualities(tmp_path, quality):
    check(tmp_path, pillow_webp(smooth(37, 53, seed=quality),
                                quality=quality))


@pytest.mark.parametrize("shape", [(1, 1), (1, 17), (17, 1), (2, 2),
                                   (33, 47), (100, 3), (16, 48), (65, 31)])
def test_lossy_sizes(tmp_path, shape):
    check(tmp_path, pillow_webp(smooth(*shape, seed=shape[0]), quality=70))


@pytest.mark.parametrize("config", [
    dict(filter_type=0, filter_strength=20),
    dict(filter_type=0, filter_strength=90, filter_sharpness=3),
    dict(filter_type=0, filter_strength=60, filter_sharpness=7),
    dict(filter_type=1, filter_strength=80, filter_sharpness=5),
    dict(filter_type=1, filter_strength=100, filter_sharpness=0,
         quality=20),
    dict(filter_strength=0),
    dict(segments=1, sns_strength=0),
    dict(segments=2, sns_strength=50),
    dict(segments=4, sns_strength=100, quality=40),
    dict(partitions=1), dict(partitions=2), dict(partitions=3, quality=90),
    dict(method=0), dict(method=6, autofilter=1),
    dict(use_sharp_yuv=1), dict(preprocessing=2),
])
def test_lossy_encoder_settings(tmp_path, config):
    data = wf.encode(smooth(70, 90, seed=3), **config)
    simple, level, sharp, _, parts = frame_header(data)
    if config.get("filter_strength", 1) and level:
        assert simple == (config.get("filter_type", 1) == 0)
        assert sharp == config.get("filter_sharpness", 0)
    if config.get("filter_strength", 1) == 0:
        assert level == 0
    # libwebp 1.6's encoder writes one token partition whatever this asks
    assert parts in (1, 1 << config.get("partitions", 0))
    check(tmp_path, data)


@pytest.mark.parametrize("log2_parts", [1, 2, 3])
def test_lossy_token_partitions(tmp_path, log2_parts):
    """2, 4 and 8 token partitions: a libwebp file's boolean decisions
    written again with the macroblock rows spread over the partitions
    (libwebp 1.6's encoder writes one); Pillow decodes it as the
    original."""
    data = wf.encode(smooth(70, 90, seed=5), quality=80, segments=4)
    body = wf.repartition(wf.image_chunks(data)[8:], log2_parts)
    assert frame_header(wf.riff(wf.chunk(b"VP8 ", body)))[4] \
        == 1 << log2_parts
    img = check(tmp_path, wf.riff(wf.chunk(b"VP8 ", body)))
    np.testing.assert_array_equal(img, check(tmp_path, data, "o.webp"))
    for x, y in zip(vp8.frame(body)[:3], vp8._frame_plain(body)[:3]):
        np.testing.assert_array_equal(x, y)


def test_lossy_noise_and_large(tmp_path):
    rng = np.random.default_rng(4)
    check(tmp_path, pillow_webp(rng.integers(0, 256, (48, 48, 3))
                                .astype(np.uint8), quality=90), "n.webp")
    check(tmp_path, pillow_webp(smooth(250, 130, seed=9), quality=75))


# -------------------------------------------------------------- lossless ----
@pytest.mark.parametrize("kw", [dict(quality=0, method=0),
                                dict(quality=50, method=4),
                                dict(quality=100, method=6)])
def test_lossless(tmp_path, kw):
    check(tmp_path, pillow_webp(smooth(37, 53, seed=1), lossless=True, **kw))


@pytest.mark.parametrize("ncol", [2, 3, 4, 11, 16, 17, 256])
def test_lossless_palette(tmp_path, ncol):
    check(tmp_path, pillow_webp(palette_image(21, 35, ncol, seed=ncol),
                                lossless=True))


@pytest.mark.parametrize("exact", [False, True])
def test_lossless_rgba_exact(tmp_path, exact):
    img = smooth(29, 31, 4, seed=2)
    img[::3, :, 3] = 0          # RGB under transparent pixels
    data = pillow_webp(img, lossless=True, exact=exact)
    check(tmp_path, data)
    assert_alpha_matches(data)


@pytest.mark.parametrize("config", [dict(near_lossless=60),
                                    dict(use_delta_palette=1),
                                    dict(quality=100, method=6,
                                         image_hint=3)])
def test_lossless_encoder_settings(tmp_path, config):
    img = smooth(40, 52, seed=6) if "use_delta_palette" not in config \
        else palette_image(40, 52, 200, seed=1)
    check(tmp_path, wf.encode(img, lossless=1, **config))


def test_lossless_noise(tmp_path):
    rng = np.random.default_rng(8)
    check(tmp_path, pillow_webp(rng.integers(0, 256, (33, 40, 3))
                                .astype(np.uint8), lossless=True))


# ----------------------------------------------------------------- alpha ----
def assert_alpha_matches(data):
    """The port's RGBA canvas against Pillow's RGBA (its RGB held to JAX
    by the callers)."""
    im = Image.open(io.BytesIO(data))
    ref = np.asarray(im.convert("RGBA"))
    cw, ch, frame = webp.demux(data)
    got = webp.first_frame(data, cw, ch, frame)
    if im.mode == "RGB":
        got = got.copy()
        got[..., 3] = 255
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("compression", [0, 1])
@pytest.mark.parametrize("filtering", [0, 1, 2])
def test_lossy_alpha(tmp_path, compression, filtering):
    img = smooth(40, 41, 4, seed=5)
    data = wf.encode(img, alpha_compression=compression,
                     alpha_filtering=filtering)
    assert b"ALPH" in data
    check(tmp_path, data)
    assert_alpha_matches(data)


@pytest.mark.parametrize("alpha_quality", [10, 60])
def test_lossy_alpha_levels(tmp_path, alpha_quality):
    data = pillow_webp(smooth(33, 35, 4, seed=7), quality=75,
                       alpha_quality=alpha_quality)
    check(tmp_path, data)
    assert_alpha_matches(data)


@pytest.mark.parametrize("filt", [0, 1, 2, 3])
def test_alpha_filters_by_hand(tmp_path, filt):
    """Raw ALPH chunks with each filter, the deltas written here."""
    rng = np.random.default_rng(filt)
    h, w = 9, 13
    base = pillow_webp(smooth(h, w, seed=filt), quality=80)
    alph = bytes([filt << 2]) + rng.integers(0, 256, h * w)\
        .astype(np.uint8).tobytes()
    data = wf.riff(wf.vp8x(0x10, w, h) + wf.chunk(b"ALPH", alph)
                   + wf.image_chunks(base))
    check(tmp_path, data)
    assert_alpha_matches(data)


@pytest.mark.parametrize("bad", ["reserved", "method", "short_raw",
                                 "levels"])
def test_alpha_header_refusals(tmp_path, bad):
    h, w = 6, 7
    base = pillow_webp(smooth(h, w), quality=80)
    head = {"reserved": 0x40, "method": 2, "short_raw": 0,
            "levels": 0x20}[bad]
    n = h * w - 1 if bad == "short_raw" else h * w
    data = wf.riff(wf.vp8x(0x10, w, h) + wf.chunk(b"ALPH", bytes([head])
                                                  + bytes(n))
                   + wf.image_chunks(base))
    check(tmp_path, data)


def test_alpha_dropped_without_the_flag(tmp_path):
    """A still VP8X file without the alpha flag: the demuxer drops ALPH,
    even one libwebp would refuse."""
    base = pillow_webp(smooth(6, 7), quality=80)
    data = wf.riff(wf.vp8x(0x00, 7, 6) + wf.chunk(b"ALPH", b"\xc0")
                   + wf.image_chunks(base))
    assert check(tmp_path, data) is not None


# -------------------------------------------------------------- container ----
def test_vp8x_metadata(tmp_path):
    img = smooth(24, 26, seed=11)
    icc = bytes(range(200))
    exif = b"Exif\x00\x00" + bytes(40)
    check(tmp_path, pillow_webp(img, quality=70, icc_profile=icc, exif=exif,
                                xmp=b"<x/>"), "a.webp")
    check(tmp_path, pillow_webp(img, lossless=True, icc_profile=icc),
          "b.webp")


@pytest.mark.parametrize("lossless", [False, True])
def test_animation_first_frame(tmp_path, lossless):
    """The first frame smaller than the canvas, at an offset; the second
    frame is not shown."""
    kw = dict(lossless=True) if lossless else dict(quality=70)
    f1 = pillow_webp(smooth(13, 17, seed=1), **kw)
    f2 = pillow_webp(smooth(30, 40, seed=2), **kw)
    data = wf.animation((40, 30), [(f1, 6, 4), (f2, 0, 0)],
                        background=0xFF00FF00)
    img = check(tmp_path, data)
    assert img[:4].max() == 0 and img[4:17, 6:23].max() > 0
    assert_alpha_matches(data)


def test_animation_pillow_writes(tmp_path):
    frames = [Image.fromarray(smooth(20, 24, seed=s)) for s in range(3)]
    b = io.BytesIO()
    frames[0].save(b, "WEBP", save_all=True, append_images=frames[1:],
                   duration=50, quality=60)
    check(tmp_path, b.getvalue())


def test_animation_with_alpha_frame(tmp_path):
    f1 = wf.encode(smooth(10, 12, 4, seed=3), alpha_filtering=2)
    data = wf.animation((20, 16), [(f1, 2, 2)])
    check(tmp_path, data)
    assert_alpha_matches(data)


def _damaged(kind):
    img = smooth(20, 30, seed=12)
    good = pillow_webp(img, quality=75)
    ll = pillow_webp(img, lossless=True)
    body = wf.image_chunks(good)[8:]
    llb = wf.image_chunks(ll)[8:]
    rng = np.random.default_rng(3)
    return {
        "truncated": good[:len(good) // 2],
        "riff_size_small": good[:4] + struct.pack("<I", 4) + good[8:],
        "bad_start_code": good[:23] + b"\x00" + good[24:],
        "partial_trailing_header": good[:4] + struct.pack(
            "<I", len(good) - 4) + good[8:] + b"abcd",
        "trailing_chunk": good[:4] + struct.pack(
            "<I", len(good) - 8 + 10) + good[8:] + wf.chunk(b"JUNK", b"xy"),
        "bytes_past_riff": good + b"zzzzzzz",
        "lossless_version": ll[:24] + bytes([ll[24] | 0x20]) + ll[25:],
        "vp8x_reserved_flag": wf.riff(wf.vp8x(0x01, 30, 20)
                                      + wf.image_chunks(good)),
        "vp8x_canvas_mismatch": wf.riff(wf.vp8x(0x00, 31, 20)
                                        + wf.image_chunks(good)),
        "vp8x_no_image": wf.riff(wf.vp8x(0x00, 30, 20)
                                 + wf.chunk(b"EXIF", b"abc")),
        "vp8x_two_images": wf.riff(wf.vp8x(0x00, 30, 20)
                                   + wf.image_chunks(good)
                                   + wf.image_chunks(good)),
        "tokens_cut": wf.riff(wf.chunk(b"VP8 ", body[:len(body) - 40])),
        "partition0_cut": wf.riff(wf.chunk(b"VP8 ", body[:30])),
        "lossless_cut": wf.riff(wf.chunk(b"VP8L", llb[:len(llb) - 20])),
        "lossless_garbage": wf.riff(wf.chunk(b"VP8L", llb[:5] + rng.integers(
            0, 256, len(llb) - 5).astype(np.uint8).tobytes())),
        "frame_outside_canvas": wf.animation((20, 16), [(good, 2, 0)]),
        "simple_then_alph": wf.riff(wf.image_chunks(good) + wf.chunk(
            b"ALPH", b"\x00" + bytes(600))),
        "anmf_before_anim": wf.riff(wf.vp8x(0x02, 30, 20) + wf.chunk(
            b"ANMF", bytes(15) + b"\0" + wf.image_chunks(good))),
    }[kind]


@pytest.mark.parametrize("kind", [
    "truncated", "riff_size_small", "bad_start_code",
    "partial_trailing_header", "trailing_chunk", "bytes_past_riff",
    "lossless_version", "vp8x_reserved_flag", "vp8x_canvas_mismatch",
    "vp8x_no_image", "vp8x_two_images", "tokens_cut", "partition0_cut",
    "lossless_cut", "lossless_garbage", "frame_outside_canvas",
    "simple_then_alph", "anmf_before_anim"])
def test_damaged_files(tmp_path, kind):
    check(tmp_path, _damaged(kind))


def test_identify_no_longer_raises_not_ported():
    data = pillow_webp(smooth(8, 8), quality=50)
    assert pimage.identify(data)().shape == (8, 8, 3)


# ------------------------------------------------- C++ against plain ----
@pytest.mark.parametrize("config", [dict(quality=75), dict(quality=20,
                         segments=4, filter_type=0, filter_strength=70),
                         dict(quality=95, partitions=2, filter_sharpness=4)])
def test_vp8_frame_plain_equals_cpp(config):
    body = wf.image_chunks(wf.encode(smooth(40, 56, seed=2), **config))[8:]
    a, b = vp8.frame(body), vp8._frame_plain(body)
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", ["plain", "palette", "alpha"])
def test_vp8l_plain_equals_cpp(kind):
    img = {"plain": smooth(23, 31, seed=4),
           "palette": palette_image(23, 31, 5, seed=2),
           "alpha": smooth(23, 31, 4, seed=4)}[kind]
    body = wf.image_chunks(pillow_webp(img, lossless=True))[8:]
    np.testing.assert_array_equal(vp8l.decode(body),
                                  vp8l.decode(body, plain=True))


def test_alpha_plane_plain_equals_cpp():
    data = wf.encode(smooth(20, 22, 4, seed=9), alpha_filtering=2)
    cw, ch, frame = webp.demux(data)
    np.testing.assert_array_equal(webp.first_frame(data, cw, ch, frame),
                                  webp.first_frame(data, cw, ch, frame,
                                                   plain=True))


def test_read_image_linear(tmp_path):
    """read_image's sRGB decode on a WebP, as the JAX package's."""
    p = tmp_path / "s.webp"
    p.write_bytes(pillow_webp(smooth(9, 10), quality=60))
    same_as_jax(p, srgb=True)
    assert lrt.read_image(str(p)).dtype == np.float32
