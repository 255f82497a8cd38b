"""The Pillow 12.1 plugins of io/pil_open.py, io/fits.py, io/fli.py and
io/icns.py, held to the JAX package's reader (Image.open, then
convert("RGB")) on short headers: the port passes a file on where Pillow
gives it up, raises the class Pillow raises at the same stage (open or
load), and otherwise decodes the same pixels (FITS, FLI, GBR, ICNS, IMT,
IPTC, JPEG 2000, McIdas, PCD, PIXAR, SPIDER, XV thumbnails).

- The stubs (BUFR, GRIB, HDF5, and WMF/EMF here) raise Pillow's "cannot
  find loader" OSError at load, MPEG "cannot load this image", an IPTC
  record without image data the same; EPS without Ghostscript Pillow's
  OSError at load, and through a `gs` on the path the page it writes.
- Each header of tests/torch_tiff_files.stub_headers, and mutations of it
  (bytes changed, cut, inserted), reach the same stage and class.
"""
import os
import stat

import numpy as np
import pytest
from PIL import EpsImagePlugin

from liverrenderer_tpu_torch.io import image as timage
import torch_tiff_files as tf
from torch_threads import torch_threads_per_worker  # noqa: F401

HEADERS = tf.stub_headers()


def _agrees(data: bytes) -> bool:
    """The port agrees with Pillow on `data`: the same stage and class,
    or the same pixels."""
    want, got = tf.stage(data, True), tf.stage(data, False)
    if want[0] == "ok":
        return got[0] == "ok" and np.array_equal(got[1], want[1])
    return want == got


@pytest.mark.parametrize("name", sorted(HEADERS))
def test_headers(name):
    assert _agrees(HEADERS[name]), (name, tf.stage(HEADERS[name], True),
                                    tf.stage(HEADERS[name], False))


@pytest.mark.parametrize("name", ["bufr", "grib", "hdf5", "wmf_standard",
                                  "emf"])
def test_stub_load_raises_cannot_find_loader(name):
    fn = timage.identify(HEADERS[name])
    with pytest.raises(OSError, match="cannot find loader"):
        fn()


@pytest.mark.parametrize("name", sorted(HEADERS))
def test_mutated_headers(name):
    rng = np.random.default_rng(sorted(HEADERS).index(name))
    base = HEADERS[name]
    for _ in range(40):
        d = bytearray(base)
        for _ in range(int(rng.integers(1, 4))):
            op = rng.integers(0, 3)
            if op == 0 and d:
                d[int(rng.integers(0, len(d)))] = int(rng.integers(0, 256))
            elif op == 1:
                d = d[:int(rng.integers(0, len(d) + 1))]
            else:
                at = int(rng.integers(0, len(d) + 1))
                d[at:at] = bytes(rng.integers(0, 256, int(rng.integers(1, 5)),
                                              dtype=np.uint8))
        assert _agrees(bytes(d)), (name, bytes(d)[:60],
                                   tf.stage(bytes(d), True),
                                   tf.stage(bytes(d), False))


def test_eps_through_ghostscript(tmp_path, monkeypatch):
    """A `gs` on the path: Pillow's command line, and the page it writes
    read back (here a stand-in that writes a PPM of the size asked)."""
    gs = tmp_path / "gs"
    gs.write_text(
        "#!/usr/bin/env python3\n"
        "import sys\n"
        "if sys.argv[1:] == ['--version']:\n"
        "    print('10.0'); sys.exit(0)\n"
        "g = [a for a in sys.argv if a.startswith('-g')][0][2:]\n"
        "w, h = map(int, g.split('x'))\n"
        "out = [a for a in sys.argv if a.startswith('-sOutputFile=')][0]\n"
        "out = out.split('=', 1)[1]\n"
        "px = bytes((x * 37 + y * 11) % 256 for y in range(h)"
        " for x in range(w) for _ in range(3))\n"
        "open(out, 'wb').write(b'P6\\n%d %d\\n255\\n' % (w, h) + px)\n")
    gs.chmod(gs.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(EpsImagePlugin, "gs_binary", None)
    for name in ("eps", "eps_image_data", "eps_dos"):
        want = tf.stage(HEADERS[name], True)
        got = tf.stage(HEADERS[name], False)
        assert want[0] == got[0] == "ok", (want, got)
        np.testing.assert_array_equal(got[1], want[1])
