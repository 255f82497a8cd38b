"""The port's DDS, FTEX and BLP readers (liverrenderer_tpu_torch/io/dds.py,
ftex.py, blp.py, through read_image) and its DDS writer against the JAX
package's, which reads and writes them through Pillow: every header
branch of the three plugins equal bit for bit (tolerance 0) or raising
the exception class Pillow raises (DDS: header size, short header,
unknown flags, FourCC or DXGI format, luminance bit counts, a short DX10
header, short pixel data; FTEX: a format count other than 1, an unknown
format, a negative offset; BLP: unknown compressions and encodings,
short palettes, too little pixel data), and write_image(".dds") bytes
equal to the JAX package's."""
import io

import numpy as np
import pytest
from PIL import Image

import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu.io import image as jimage
from liverrenderer_tpu_torch.io import dds
import torch_bcn_files as bf
from test_torch_tiff import same_as_jax
from torch_threads import torch_threads_per_worker  # noqa: F401

RNG = np.random.default_rng(20)
W, H = 7, 5


def _check(tmp_path, data, name="f.bin"):
    p = tmp_path / name
    p.write_bytes(data)
    try:
        jimage.read_image(str(p), srgb_to_linear=False)
    except NotImplementedError:
        # Pillow's BLPFormatError is a NotImplementedError, as the port's
        with pytest.raises(NotImplementedError):
            lrt.read_image(str(p), srgb_to_linear=False)
        return None
    except Exception:             # noqa: BLE001 - held to the port below
        pass
    return same_as_jax(p)


def _raw(n):
    return RNG.integers(0, 256, n).astype(np.uint8).tobytes()


# ------------------------------------------------------------------- DDS ----
RGB_MASKS = {
    "bgr24": (24, (0xFF0000, 0xFF00, 0xFF), 0),
    "bgra32": (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000), 1),
    "rgb565": (16, (0xF800, 0x7E0, 0x1F), 0),
    "argb1555": (16, (0x7C00, 0x3E0, 0x1F, 0x8000), 1),
    "argb4444": (16, (0xF00, 0xF0, 0xF, 0xF000), 1),
    "rgb332": (8, (0xE0, 0x1C, 0x3), 0),
    "x8r8g8b8": (32, (0xFF0000, 0xFF00, 0xFF), 0),
    "holes": (16, (0xB000, 0x0F00, 0x0011), 0),
    "zero_mask": (32, (0xFF0000, 0, 0xFF, 0xFF000000), 1),
    "a2b10g10r10": (32, (0x3FF, 0xFFC00, 0x3FF00000, 0xC0000000), 1),
}


@pytest.mark.parametrize("name", sorted(RGB_MASKS))
def test_dds_rgb_masks(tmp_path, name):
    bits, masks, alpha = RGB_MASKS[name]
    flags = bf.DDPF_RGB | (bf.DDPF_ALPHAPIXELS if alpha else 0)
    body = _raw(W * H * bits // 8)
    _check(tmp_path, bf.dds(W, H, body, flags=flags, fourcc=0,
                            bitcount=bits, masks=tuple(masks) + (0,) * (
                                4 - len(masks))))


def test_dds_rgb_short_data_reads_zeros(tmp_path):
    body = _raw(W * H * 3 - 10)
    assert _check(tmp_path, bf.dds(W, H, body, flags=bf.DDPF_RGB, fourcc=0,
                                   bitcount=24, masks=(0xFF0000, 0xFF00,
                                                       0xFF, 0))) is not None


@pytest.mark.parametrize("kind", ["l8", "la16", "l16", "p8", "rgba_dx10",
                                  "rgba_dx10_srgb", "rgba_typeless"])
def test_dds_raw_modes(tmp_path, kind):
    if kind == "l8":
        data = bf.dds(W, H, _raw(W * H), flags=bf.DDPF_LUMINANCE, fourcc=0,
                      bitcount=8)
    elif kind in ("la16", "l16"):
        flags = bf.DDPF_LUMINANCE | (bf.DDPF_ALPHAPIXELS
                                     if kind == "la16" else 0)
        data = bf.dds(W, H, _raw(2 * W * H), flags=flags, fourcc=0,
                      bitcount=16)
    elif kind == "p8":
        data = bf.dds(W, H, _raw(1024) + _raw(W * H), flags=bf.DDPF_PAL8,
                      fourcc=0, bitcount=8)
    else:
        code = {"rgba_dx10": 28, "rgba_dx10_srgb": 29,
                "rgba_typeless": 27}[kind]
        data = bf.dds(W, H, _raw(4 * W * H), dxgi=code)
    _check(tmp_path, data)


@pytest.mark.parametrize("kind", [
    "header_size", "short_header", "no_flags", "alpha_only_flag",
    "unknown_fourcc", "dxt2", "unknown_dxgi", "bc4_snorm", "short_dx10",
    "short_blocks", "short_raw", "short_magic"])
def test_dds_refusals(tmp_path, kind):
    blocks = _raw(2 * 2 * 8)
    data = {
        "header_size": bf.dds(W, H, blocks, fourcc=b"DXT1", header_size=100),
        "short_header": bf.dds(W, H, b"", fourcc=b"DXT1")[:60],
        "no_flags": bf.dds(W, H, blocks, flags=0, fourcc=0),
        "alpha_only_flag": bf.dds(W, H, blocks, flags=2, fourcc=0),
        "unknown_fourcc": bf.dds(W, H, blocks, fourcc=b"ABCD"),
        "dxt2": bf.dds(W, H, blocks, fourcc=b"DXT2"),
        "unknown_dxgi": bf.dds(W, H, blocks, dxgi=2),
        "bc4_snorm": bf.dds(W, H, blocks, dxgi=81),
        "short_dx10": bf.dds(W, H, b"", fourcc=b"DX10") + b"\x47\0",
        "short_blocks": bf.dds(W, H, blocks[:20], fourcc=b"DXT1"),
        "short_raw": bf.dds(W, H, _raw(W * H - 3), flags=bf.DDPF_LUMINANCE,
                            fourcc=0, bitcount=8),
        "short_magic": b"DDS \x7c\0",
    }[kind]
    _check(tmp_path, data)


@pytest.mark.parametrize("size", [(1, 1), (4, 4), (9, 6)])
def test_dds_pillow_writes_bcn(tmp_path, size):
    """DXT1/3/5 and BC5 as Pillow's encoder writes them."""
    img = RNG.integers(0, 256, size[::-1] + (4,)).astype(np.uint8)
    for fmt, mode in (("DXT1", "RGBA"), ("DXT3", "RGBA"), ("DXT5", "RGBA"),
                      ("BC2", "RGBA"), ("BC3", "RGBA"), ("BC5", "RGB")):
        b = io.BytesIO()
        Image.fromarray(img).convert(mode).save(b, "DDS", pixel_format=fmt)
        _check(tmp_path, b.getvalue(), f"{fmt}.dds")


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 3), (5, 7, 4), (1, 1, 3)])
def test_dds_write_bytes_match_jax(tmp_path, shape):
    img = RNG.uniform(0, 1.2, shape).astype(np.float32)
    if len(shape) == 2:
        # the JAX writer's dither is (H, W, 1); encode_8bit's L path
        px = (img * 200).astype(np.uint8)
        b = io.BytesIO()
        Image.fromarray(px).save(b, "DDS")
        assert dds.encode_dds(px) == b.getvalue()
        return
    jp, tp = tmp_path / "j.dds", tmp_path / "t.dds"
    jimage.write_image(str(jp), img)
    lrt.write_image(str(tp), img)
    assert tp.read_bytes() == jp.read_bytes()
    same_as_jax(tp)


# ------------------------------------------------------------------ FTEX ----
@pytest.mark.parametrize("kind", ["dxt1", "rgb", "dxt1_short", "rgb_short",
                                  "count2", "format5", "negative_where",
                                  "where_past_end", "negative_size",
                                  "short_header"])
def test_ftex(tmp_path, kind):
    dxt = _raw(2 * 2 * 8)
    rgb = _raw(W * H * 3)
    data = {
        "dxt1": bf.ftex(W, H, 0, dxt),
        "rgb": bf.ftex(W, H, 1, rgb),
        "dxt1_short": bf.ftex(W, H, 0, dxt[:17]),
        "rgb_short": bf.ftex(W, H, 1, rgb[:-5]),
        "count2": bf.ftex(W, H, 0, dxt, count=2),
        "format5": bf.ftex(W, H, 5, dxt),
        "negative_where": bf.ftex(W, H, 0, dxt)[:28] + b"\xfc\xff\xff\xff"
        + bf.ftex(W, H, 0, dxt)[32:],
        "where_past_end": bf.ftex(W, H, 0, dxt)[:28] + b"\xff\x00\x00\x00"
        + bf.ftex(W, H, 0, dxt)[32:],
        "negative_size": bf.ftex(W, H, 1, rgb, size=-1),
        "short_header": b"FTEX\0\0\0\0\x07\0\0\0",
    }[kind]
    _check(tmp_path, data, "f.ftc")


# ------------------------------------------------------------------- BLP ----
def _bgra_palette(alpha=True):
    pal = RNG.integers(0, 256, (256, 4)).astype(np.uint8)
    if not alpha:
        pal[:, 3] = 0
    return pal.tobytes()


@pytest.mark.parametrize("kind", [
    "blp2_palette", "blp2_palette_alpha", "blp2_dxt1", "blp2_dxt1_alpha",
    "blp2_dxt3", "blp2_dxt3_alpha", "blp2_dxt5", "blp2_dxt5_alpha",
    "blp2_dxt1_odd", "blp2_dxt5_4x4", "blp1_palette4", "blp1_palette5_alpha",
    "blp1_jpeg", "pillow_blp2", "pillow_blp1"])
def test_blp(tmp_path, kind):
    pal = _bgra_palette()
    w, h = (W, H) if "odd" in kind or "palette" in kind or "jpeg" in kind \
        else (8, 8) if "4x4" not in kind else (4, 4)
    nb = ((w + 3) // 4) * ((h + 3) // 4)
    alpha = int(kind.endswith("alpha"))
    if kind.startswith("pillow"):
        b = io.BytesIO()
        Image.fromarray(RNG.integers(0, 256, (H, W, 3)).astype(np.uint8)) \
            .convert("P").save(b, "BLP", blp_version=kind[-4:].upper())
        data = b.getvalue()
    elif kind.startswith("blp2_palette"):
        data = bf.blp2(w, h, _raw(w * h), encoding=1, alpha=alpha,
                       palette=pal)
    elif kind.startswith("blp2_dxt"):
        enc = {"1": 0, "3": 1, "5": 7}[kind[8]]
        size = 8 if enc == 0 else 16
        data = bf.blp2(w, h, _raw(nb * size), encoding=2, alpha=alpha,
                       alpha_enc=enc, palette=pal)
    elif kind.startswith("blp1_palette"):
        data = bf.blp1(w, h, _raw(w * h), encoding=int(kind[12]),
                       alpha=8 * alpha, palette=pal)
    else:
        b = io.BytesIO()
        Image.fromarray(RNG.integers(0, 256, (h, w, 3)).astype(np.uint8)) \
            .save(b, "JPEG", quality=80)
        jpg = b.getvalue()
        data = bf.blp1(w, h, jpg[300:], compression=0, jpeg_header=jpg[:300])
    _check(tmp_path, data, "f.blp")


@pytest.mark.parametrize("kind", [
    "blp2_jpeg", "blp2_encoding3", "blp2_alpha_encoding2", "blp1_comp2",
    "blp1_encoding3", "short_palette", "short_pixels", "short_dxt",
    "short_header", "blp1_cmyk_jpeg"])
def test_blp_refusals(tmp_path, kind):
    pal = _bgra_palette()
    if kind == "blp1_cmyk_jpeg":
        b = io.BytesIO()
        Image.new("CMYK", (W, H), (10, 20, 30, 40)).save(b, "JPEG")
        jpg = b.getvalue()
        p = tmp_path / "c.blp"
        p.write_bytes(bf.blp1(W, H, jpg[200:], compression=0,
                              jpeg_header=jpg[:200]))
        # Pillow decodes a 4-component JPEG, its BLP plugin as plain
        # "CMYK" and then "BGR": the port reads it the same
        assert _check(tmp_path, p.read_bytes(), "c.blp") is not None
        return
    data = {
        "blp2_jpeg": bf.blp2(W, H, _raw(40), compression=0, palette=pal),
        "blp2_encoding3": bf.blp2(W, H, _raw(W * H * 4), encoding=3,
                                  palette=pal),
        "blp2_alpha_encoding2": bf.blp2(8, 8, _raw(64), encoding=2,
                                        alpha_enc=2, palette=pal),
        "blp1_comp2": bf.blp1(W, H, _raw(W * H), compression=2, palette=pal),
        "blp1_encoding3": bf.blp1(W, H, _raw(W * H), encoding=3,
                                  palette=pal),
        "short_palette": bf.blp1(W, H, b"", palette=pal[:500]),
        "short_pixels": bf.blp2(W, H, _raw(W * H - 4), palette=pal),
        "short_dxt": bf.blp2(8, 8, _raw(20), encoding=2, palette=pal),
        "short_header": b"BLP2\x01\0\0\0\x01",
    }[kind]
    _check(tmp_path, data, "f.blp")
