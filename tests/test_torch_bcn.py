"""The port's BCn block decoders (liverrenderer_tpu_torch/io/bcn.py) against
Pillow's BcnDecode.c, through DDS files the JAX package reads with
Pillow: random blocks of every BC format and DXGI code, bit for bit
(tolerance 0), with image sizes that are not multiples of 4 (the blocks'
parts past the edges dropped), every BC7 mode byte (0 included) and
every BC6H mode, reserved ones included.  The C++ BC6H and BC7 loops
equal their plain Python versions on the same blocks.  BLP2's DXT1/3/5
are Pillow's own Python decoders (BlpImagePlugin.decode_dxt1/3/5), not
BcnDecode.c: the port's `blp.dxt1/3/5` equal them on random blocks."""
import numpy as np
import pytest
from PIL import BlpImagePlugin

from liverrenderer_tpu_torch.io import bcn, blp
import torch_bcn_files as bf
from test_torch_tiff import same_as_jax
from torch_threads import torch_threads_per_worker  # noqa: F401

W, H = 18, 13                 # 5 x 4 blocks, parts of the last cut off
NB = 5 * 4
# (DXGI code or FourCC, block bytes, BcnDecode n, pixel format)
FORMATS = {
    "bc1_typeless": (70, 8, 1, "BC1"), "bc1_unorm": (71, 8, 1, "BC1"),
    "bc2_typeless": (73, 16, 2, "BC2"), "bc2_unorm": (74, 16, 2, "BC2"),
    "bc3_typeless": (76, 16, 3, "BC3"), "bc3_unorm": (77, 16, 3, "BC3"),
    "bc4_typeless": (79, 8, 4, "BC4"), "bc4_unorm": (80, 8, 4, "BC4"),
    "bc5_typeless": (82, 16, 5, "BC5"), "bc5_unorm": (83, 16, 5, "BC5"),
    "bc5_snorm": (84, 16, 5, "BC5S"), "bc6h_uf16": (95, 16, 6, "BC6H"),
    "bc6h_sf16": (96, 16, 6, "BC6HS"), "bc7_typeless": (97, 16, 7, "BC7"),
    "bc7_unorm": (98, 16, 7, "BC7"), "bc7_srgb": (99, 16, 7, "BC7"),
    "dxt1": (b"DXT1", 8, 1, "DXT1"), "dxt3": (b"DXT3", 16, 2, "DXT3"),
    "dxt5": (b"DXT5", 16, 3, "DXT5"), "bc4u": (b"BC4U", 8, 4, "BC4"),
    "ati1": (b"ATI1", 8, 4, "BC4"), "bc5u": (b"BC5U", 16, 5, "BC5"),
    "bc5s": (b"BC5S", 16, 5, "BC5S"), "ati2": (b"ATI2", 16, 5, "BC5"),
}
# first bytes that reach every BC7 mode (and none) and every BC6H mode
BC7_MODES = [0, 1, 2, 4, 8, 16, 32, 64, 128, 3, 0x80, 0xFF]
BC6_MODES = [0, 1, 2, 3, 6, 7, 10, 11, 14, 15, 18, 19, 22, 23, 26, 27, 30,
             31]


def _body(name, seed):
    code, size, n, _ = FORMATS[name]
    rng = np.random.default_rng(seed)
    modes = BC7_MODES if n == 7 else BC6_MODES if n == 6 else None
    if modes is not None:
        modes = [(m + 32 * int(rng.integers(0, 8))) & 0xFF if n == 6 else m
                 for m in modes]
    return bf.random_blocks(NB, size, rng, modes)


def _file(name, body):
    code = FORMATS[name][0]
    if isinstance(code, bytes):
        return bf.dds(W, H, body, fourcc=code)
    return bf.dds(W, H, body, dxgi=code)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(FORMATS))
def test_random_blocks_match_pillow(tmp_path, name, seed):
    p = tmp_path / f"{name}.dds"
    p.write_bytes(_file(name, _body(name, seed)))
    assert same_as_jax(p) is not None


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("n,fmt", [(6, "BC6H"), (6, "BC6HS"), (7, "BC7")])
def test_cpp_equals_plain(n, fmt, seed):
    name = {"BC6H": "bc6h_uf16", "BC6HS": "bc6h_sf16", "BC7": "bc7_unorm"}
    body = _body(name[fmt], 10 + seed)
    np.testing.assert_array_equal(bcn.decode(body, W, H, n, fmt),
                                  bcn.decode(body, W, H, n, fmt, plain=True))


def test_bc7_floor_encoder_round_trip(tmp_path):
    """tests/torch_bcn_files.bc7_mode6 (the committed floor's encoder)
    writes blocks Pillow and the port decode alike, near the input."""
    import torch_xml_files as xf
    img = np.concatenate([xf.floor_texture(32),
                          np.full((32, 32, 1), 255, np.uint8)], -1)
    p = tmp_path / "f.dds"
    p.write_bytes(bf.dds(32, 32, bf.bc7_mode6(img), dxgi=98))
    same_as_jax(p)
    got = bcn.decode(bf.bc7_mode6(img), 32, 32, 7, "BC7")
    assert np.abs(got[..., :3].astype(int) - img[..., :3]).max() <= 12


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["dxt1", "dxt1_alpha", "dxt3", "dxt5"])
def test_blp_dxt_match_pillows_python(kind, seed):
    size = 8 if kind.startswith("dxt1") else 16
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, (6, size)).astype(np.uint8)
    if kind.startswith("dxt1"):
        # both colour orders, so both DXT1 block kinds
        blocks[::2, 1] = 0xFF
        blocks[1::2, 1] = 0
        blocks[1::2, 3] = 0xFF
    alpha = kind == "dxt1_alpha"
    ref = {"dxt1": lambda d: BlpImagePlugin.decode_dxt1(d, alpha=False),
           "dxt1_alpha": lambda d: BlpImagePlugin.decode_dxt1(d, alpha=True),
           "dxt3": BlpImagePlugin.decode_dxt3,
           "dxt5": BlpImagePlugin.decode_dxt5}[kind](blocks.tobytes())
    got = {"dxt1": lambda b: blp.dxt1(b, False),
           "dxt1_alpha": lambda b: blp.dxt1(b, True),
           "dxt3": blp.dxt3, "dxt5": blp.dxt5}[kind](blocks)
    c = got.shape[-1]
    rows = got.reshape(6, 4, 4, c).transpose(1, 0, 2, 3)
    for j in range(4):
        assert rows[j].tobytes() == bytes(ref[j])
