"""The ICNS writer (liverrenderer_tpu_torch/io/icns.py with io/resample.py)
against the JAX package's write_image, which saves through Pillow 12.1:
the container byte for byte outside its PNG entries (the magic, the table
of contents, the entries' codes and order, each length matching its
entry), and every entry's decoded pixels and mode equal (Pillow's PNG
entries are zlib-ng's deflate bytes, the port's the standard zlib's).
Each file holds six sizes up to 1,024^2, so the cases sit in a file of
their own (the other writers: tests/test_torch_pil_writers.py).
"""
import io
import struct

import numpy as np
import pytest
from PIL import Image

import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu.io import image as jimage
from liverrenderer_tpu_torch.io import image as timage
from test_torch_pil_writers import _image
from torch_threads import torch_threads_per_worker  # noqa: F401


def _entries(data: bytes):
    """(the header and table of contents with the lengths zeroed, [(code,
    entry)])."""
    assert data[:4] == b"icns"
    assert struct.unpack(">I", data[4:8])[0] == len(data)
    toc_len = struct.unpack(">I", data[12:16])[0]
    head = bytearray(data[:8 + toc_len])
    head[4:8] = bytes(4)
    for o in range(16, 8 + toc_len, 8):
        head[o + 4:o + 8] = bytes(4)
    pos, out, k = 8 + toc_len, [], 16
    while pos < len(data):
        code, size = data[pos:pos + 4], struct.unpack(">I",
                                                      data[pos + 4:pos + 8])[0]
        assert data[k:k + 8] == data[pos:pos + 8]      # the TOC's entry
        out.append((code, data[pos + 8:pos + size]))
        pos, k = pos + size, k + 8
    return bytes(head), out


def _assert_icns_equal(got: bytes, want: bytes):
    gh, ge = _entries(got)
    wh, we = _entries(want)
    assert gh == wh
    assert [c for c, _ in ge] == [c for c, _ in we]
    for (code, a), (_, b) in zip(ge, we):
        ia, ib = Image.open(io.BytesIO(a)), Image.open(io.BytesIO(b))
        assert (ia.mode, ia.size) == (ib.mode, ib.size), code
        np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib),
                                      err_msg=code.decode())


@pytest.mark.parametrize("shape", [(37, 53, 4), (40, 52, 3), (37, 53)])
def test_icns_matches_jax(tmp_path, shape):
    """RGBA (through premultiplied RGBa) and RGB against the JAX
    write_image; a (H, W) image against Pillow's save of the port's grey
    pixels (mode L)."""
    img = _image(shape if len(shape) == 3 else shape + (3,))
    if len(shape) == 2:
        img = img[..., 0]
    a = tmp_path / "port.icns"
    lrt.write_image(str(a), img)
    b = tmp_path / "ref.icns"
    if len(shape) == 2:
        Image.fromarray(timage.dither_8bit(img)).save(b)
    else:
        jimage.write_image(str(b), img)
    _assert_icns_equal(a.read_bytes(), b.read_bytes())
