"""The port's GIF reader (liverrenderer_tpu_torch/io/gif.py, through
read_image) against the JAX package's read_image, which reads GIF through
Pillow: the first frame equal bit for bit (tolerance 0) on files Pillow
writes and on files tests/torch_raster_files.py builds (global and local
colour tables, grey-ramp tables Pillow reads as mode "L", no table,
frame offsets inside and past the logical screen, interlace, the
transparency index under convert("RGB"), GIF87a, minimum code sizes up
to 8, a table past 4,096 entries without a clear, clears mid-stream) and
on damaged streams (no end code, a stream cut inside a sub-block or
before the frame is full, a code past the table, a code size of 13),
where Pillow raises the port raises the same exception class.  The C++
LZW loop equals its plain version on each file.  Writing GIF gives the
JAX package's bytes.
"""
import io

import numpy as np
import pytest
from PIL import Image

import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu.io import image as jimage
from liverrenderer_tpu_torch.io import gif, lzw
import torch_raster_files as rf
from test_torch_tiff import same_as_jax
from torch_threads import torch_threads_per_worker  # noqa: F401

RNG = np.random.default_rng(28)
PAL = RNG.integers(0, 256, (16, 3)).astype(np.uint8)
PAL256 = RNG.integers(0, 256, (256, 3)).astype(np.uint8)
GREY = np.repeat(np.arange(16, dtype=np.uint8)[:, None], 3, 1)
IDX = RNG.integers(0, 16, (21, 17)).astype(np.uint8)
BIG = RNG.integers(0, 256, (90, 120)).astype(np.uint8)
CODES = rf.lzw_encode_gif(IDX.tobytes(), 4)

_BUILT = {
    "global": dict(palette=PAL),
    "grey_ramp_global": dict(palette=GREY),
    "no_table": dict(),
    "local": dict(local=PAL),
    "local_over_grey_global": dict(palette=GREY, local=PAL),
    "grey_local_over_global": dict(palette=PAL, local=GREY),
    "offset": dict(palette=PAL, offset=(3, 5)),
    "offset_larger_screen": dict(palette=PAL, offset=(3, 5),
                                 screen=(40, 40)),
    "offset_past_screen": dict(palette=PAL, offset=(3, 5), screen=(10, 10)),
    "interlace": dict(palette=PAL, interlace=True),
    "transparency_outside_frame": dict(palette=PAL, transparency=5,
                                       offset=(2, 2)),
    "transparency_0": dict(palette=PAL, transparency=0, offset=(2, 2)),
    "gif87a": dict(palette=PAL, version=b"GIF87a"),
    "min_code_size_8": dict(palette=PAL, min_size=8),
    "clear_mid_stream": dict(palette=PAL, clear_every=40),
    "background_index": dict(palette=PAL, background=7, offset=(1, 1)),
    "no_end_code": dict(palette=PAL, min_size=4,
                        stream=rf.sub_blocks(CODES[:-1])),
    "cut_before_full": dict(palette=PAL, min_size=4,
                            stream=rf.sub_blocks(CODES[:len(CODES) // 2])),
    "cut_no_trailer": dict(palette=PAL, min_size=4, trailer=False,
                           stream=rf.sub_blocks(CODES[:len(CODES) // 2])),
    "no_terminator": dict(palette=PAL, min_size=4, trailer=False,
                          stream=rf.sub_blocks(CODES)[:-1]),
    "cut_inside_block": dict(palette=PAL, min_size=4, trailer=False,
                             stream=rf.sub_blocks(CODES)[:30]),
    "code_past_table": dict(palette=PAL, min_size=4,
                            stream=rf.sub_blocks(b"\x10\xff\xff\xff")),
    "code_size_13": dict(palette=PAL, min_size=13,
                         stream=rf.sub_blocks(CODES)),
    "early_end_code": dict(palette=PAL, min_size=4, stream=rf.sub_blocks(
        rf.lzw_encode_gif(IDX[:5].tobytes(), 4))),
    "early_end_code_then_64k": dict(palette=PAL, min_size=4, stream=(
        rf.sub_blocks(rf.lzw_encode_gif(IDX[:5].tobytes(), 4))
        + rf.sub_blocks(bytes(70000)))),
}


def _both_loops(path):
    """same_as_jax, then the plain LZW loop in the C++ one's place: the same
    image or the same exception."""
    img = same_as_jax(path)
    data = path.read_bytes()
    native = lzw.lzw_gif
    try:
        lzw.lzw_gif = lzw._lzw_gif_plain
        if img is None:
            with pytest.raises(Exception) as plain_err:
                gif.read_gif(data)
            with pytest.raises(type(plain_err.value)):
                lzw.lzw_gif = native
                gif.read_gif(data)
        else:
            plain = gif.read_gif(data)
            lzw.lzw_gif = native
            np.testing.assert_array_equal(plain, gif.read_gif(data))
    finally:
        lzw.lzw_gif = native


@pytest.mark.parametrize("name", sorted(_BUILT))
def test_built_files(tmp_path, name):
    kw = dict(_BUILT[name])
    idx = IDX
    p = tmp_path / "f.gif"
    p.write_bytes(rf.write_gif(idx, **kw))
    _both_loops(p)


@pytest.mark.parametrize("interlace", [False, True])
def test_full_table_without_clear(tmp_path, interlace):
    """256 colours, 10,800 pixels of noise: the table fills at 4,096 and
    the encoder sends no clear (Pillow's deferred clear)."""
    p = tmp_path / "f.gif"
    p.write_bytes(rf.write_gif(BIG, palette=PAL256, min_size=8,
                               interlace=interlace))
    _both_loops(p)


@pytest.mark.parametrize("shape", [(7, 9), (33, 40)])
@pytest.mark.parametrize("mode", ["RGB", "L", "P", "1"])
@pytest.mark.parametrize("extra", ["", "interlace", "transparency"])
def test_pil_written_files(tmp_path, shape, mode, extra):
    a = RNG.integers(0, 256, shape + (3,)).astype(np.uint8)
    kw = {"interlace": {"interlace": True},
          "transparency": {"transparency": 3}}.get(extra, {})
    p = tmp_path / "f.gif"
    Image.fromarray(a).convert(mode).save(p, **kw)
    _both_loops(p)


def test_writing_gif_is_not_ported(tmp_path):
    """Writing GIF was refused until the port had Pillow's quantisers;
    now write_image writes the JAX package's bytes, which read back
    alike (tests/test_torch_pil_writers.py holds the writer)."""
    img = np.zeros((4, 4, 3), np.float32)
    img[1:3, 1:3] = 0.5
    lrt.write_image(str(tmp_path / "o.gif"), img)
    jimage.write_image(str(tmp_path / "j.gif"), img)
    assert (tmp_path / "o.gif").read_bytes() \
        == (tmp_path / "j.gif").read_bytes()
    same_as_jax(tmp_path / "o.gif")


def test_pil_written_animation_frame_0(tmp_path):
    """A two-frame animation with a local table on frame 1: frame 0 is
    read."""
    frames = [Image.fromarray(RNG.integers(0, 256, (12, 10, 3)).astype(
        np.uint8)) for _ in range(2)]
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:])
    p = tmp_path / "anim.gif"
    p.write_bytes(buf.getvalue())
    _both_loops(p)
