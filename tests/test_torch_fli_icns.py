"""FLI / FLC animations and ICNS icons, held to the JAX package's
read_image (Pillow 12.1) bit for bit on files tests/torch_rare_files
writes, and to Pillow's exception class where it refuses them.

- FLI and FLC: the first frame over every chunk kind (COLOR_256 and
  COLOR_64 palettes, BLACK, BRUN, COPY, LC, SS2 with skipped lines and the
  odd last byte, a postage stamp), the header's refusals (no frames, a
  prefix chunk, an unknown chunk), every cut of a file and single-byte
  mutations of it (Image.open of the bytes, tests/torch_tiff_files.stage);
  the C++ frame loop (csrc/fli.cpp) equal to its plain version
  (`fli._frame_plain`) on every buffer the feeder hands it.
- ICNS: the best size's RLE (is32, il32, ih32, it32) and raw entries and
  their masks, PNG entries (also one smaller than its slot, and one whose
  size no slot allows), JPEG 2000 entries (a JP2 file and a codestream,
  decoded; a malformed JP2 box, SyntaxError in both), and cuts and
  mutations of a file.
"""
import io

import numpy as np
import pytest
from PIL import Image

import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu.io import image as jimage
from liverrenderer_tpu_torch.io import fli
import torch_j2k_files as j2f
import torch_rare_files as rf
import torch_tiff_files as tf
from test_torch_rare_formats import _same
from torch_threads import torch_threads_per_worker  # noqa: F401

RNG = np.random.default_rng(24)
W, H = 10, 6
PAL = RNG.integers(0, 256, (256, 3)).astype(np.uint8)
A = RNG.integers(0, 8, (H, W)).astype(np.uint8)
B = A.copy()
B[2, 3:8] = 7
B[4, 0:4] = RNG.integers(0, 255, 4)
B[5, 9] = 200
ZERO = np.zeros_like(B)


def _frames():
    """name -> (frames, flc, prefix, n_frames)."""
    col = (4, rf.fli_palette(PAL))
    return {
        "brun": ([[col, (15, rf.fli_brun(A))]], True, None, None),
        "brun_fli": ([[col, (15, rf.fli_brun(A))]], False, None, None),
        "copy_64": ([[(11, rf.fli_palette(PAL // 4)), (16, A.tobytes())]],
                    True, None, None),
        "copy_64_wraps": ([[(11, rf.fli_palette(PAL)), (16, A.tobytes())]],
                          False, None, None),
        "black_lc": ([[col, (13, b""), (12, rf.fli_lc(ZERO, B))]], True,
                     None, None),
        "lc_partial_palette": ([[(4, rf.fli_palette(PAL[:40], 3)),
                                 (12, rf.fli_lc(ZERO, B))]], True, None,
                               None),
        "ss2": ([[col, (7, rf.fli_ss2(ZERO, B))]], True, None, None),
        "ss2_odd_byte": ([[col, (7, rf.fli_ss2(ZERO, B, True))]], True, None,
                         None),
        "stamp_then_two_frames": ([[(18, bytes(20)), col,
                                    (15, rf.fli_brun(A))],
                                   [(12, rf.fli_lc(A, B))]], True, None,
                                  None),
        "all_kinds": ([[col, (15, rf.fli_brun(A)), (12, rf.fli_lc(A, B)),
                        (7, rf.fli_ss2(A, B)), (16, B.tobytes())]], True,
                      None, None),
        "prefix_chunk": ([[col, (15, rf.fli_brun(A))]], True, bytes(10),
                         None),
        "no_frames": ([[(15, rf.fli_brun(A))]], True, None, 0),
        "unknown_chunk": ([[(99, bytes(10))]], True, None, None),
        "copy_short": ([[col, (16, A.tobytes()[:-5])]], True, None, None),
    }


FRAMES = _frames()
REFUSED = {"prefix_chunk", "no_frames", "unknown_chunk", "copy_short"}


def _fli(name):
    frames, flc, prefix, n = FRAMES[name]
    return rf.fli(frames, W, H, flc, prefix=prefix, n_frames=n)


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_fli_first_frame(tmp_path, name):
    ref = _same(tmp_path, _fli(name), "f.flc", ok=name not in REFUSED)
    if name == "all_kinds":                       # the COPY chunk wins
        np.testing.assert_array_equal(ref * 255, PAL[B] / 1.0)


def _agree(data):
    want, got = tf.stage(data, True), tf.stage(data, False)
    if want[0] == "ok":
        return got[0] == "ok" and np.array_equal(got[1], want[1])
    return want == got


def test_fli_cuts_and_mutations():
    good = _fli("all_kinds")
    for cut in range(0, len(good), 5):
        assert _agree(good[:cut]), cut
    rng = np.random.default_rng(7)
    for _ in range(150):
        d = bytearray(good)
        k = int(rng.integers(128, len(d)))
        d[k] = int(rng.integers(0, 256))
        assert _agree(bytes(d)), k


def test_fli_plain_loop_equals_cpp():
    """Every buffer the feeder hands the decoder, on every file above and
    on cuts and mutations of one: the same return, error and pixels."""
    files = [_fli(n) for n in sorted(FRAMES)]
    good = _fli("all_kinds")
    rng = np.random.default_rng(8)
    for k in range(60):
        d = bytearray(good)
        d[int(rng.integers(128, len(d)))] = int(rng.integers(0, 256))
        files += [bytes(d), good[:128 + 16 + 3 * k]]
    for data in files:
        framesize = int.from_bytes(data[128:132], "little") \
            if len(data) >= 132 else 0
        for buf in (data[128:128 + framesize], data[128:]):
            imgs, outs = [], []
            for fn in (fli.frame, fli._frame_plain):
                img = np.zeros((H, W), np.uint8)
                outs.append(fn(buf, img))
                imgs.append(img)
            assert outs[0] == outs[1]
            np.testing.assert_array_equal(imgs[0], imgs[1])


# ---------------------------------------------------------------- ICNS ----
def _png(img):
    b = io.BytesIO()
    Image.fromarray(img).save(b, "PNG")
    return b.getvalue()


S16 = np.kron(RNG.integers(0, 256, (4, 4, 3)), np.ones((4, 4, 1))) \
    .astype(np.uint8)
M16 = RNG.integers(0, 256, (16, 16)).astype(np.uint8)
S32 = RNG.integers(0, 256, (32, 32, 4)).astype(np.uint8)
S48 = np.kron(RNG.integers(0, 256, (6, 6, 3)), np.ones((8, 8, 1))) \
    .astype(np.uint8)
S128 = np.kron(RNG.integers(0, 256, (8, 8, 3)), np.ones((16, 16, 1))) \
    .astype(np.uint8)
ICNS = {
    "is32_rle": ([(b"is32", rf.icns_rgb(S16))], True),
    "is32_rle_mask": ([(b"is32", rf.icns_rgb(S16)),
                       (b"s8mk", M16.tobytes())], True),
    "is32_raw": ([(b"is32", rf.icns_rgb(S16, rle=False))], True),
    "il32_beats_is32": ([(b"is32", rf.icns_rgb(S16)),
                         (b"il32", rf.icns_rgb(S32[..., :3]))], True),
    "ih32_h8mk": ([(b"ih32", rf.icns_rgb(S48)),
                   (b"h8mk", bytes(48 * 48))], True),
    "it32_t8mk": ([(b"it32", rf.icns_rgb(S128, it32=True)),
                   (b"t8mk", bytes(128 * 128))], True),
    "icp4_png_rgba": ([(b"icp4", _png(S32[:16, :16]))], True),
    "icp5_png_over_il32": ([(b"il32", rf.icns_rgb(S32[..., :3])),
                            (b"icp5", _png(S32[..., :3]))], True),
    "ic11_png": ([(b"ic11", _png(S32))], True),
    "ic07_png_smaller": ([(b"ic07", _png(S32))], True),
    "short_mask": ([(b"is32", rf.icns_rgb(S16)),
                    (b"s8mk", M16.tobytes()[:-3])], False),
    "mask_only": ([(b"s8mk", M16.tobytes())], False),
    "it32_bad_signature": ([(b"it32", b"\1" + rf.icns_rgb(
        S128, it32=True)[1:])], False),
    "ic07_png_odd_size": ([(b"ic07", _png(RNG.integers(
        0, 256, (33, 33, 3)).astype(np.uint8)))], False),
    "ic07_unknown": ([(b"ic07", bytes(40))], False),
}


@pytest.mark.parametrize("name", sorted(ICNS))
def test_icns(tmp_path, name):
    entries, ok = ICNS[name]
    _same(tmp_path, rf.icns(entries), "f.icns", ok=ok)


def test_icns_jpeg2000_entry(tmp_path):
    """A JP2 entry and a codestream entry decode as Pillow decodes them;
    a malformed JP2 box is SyntaxError in both packages."""
    px = RNG.integers(0, 256, (128, 128, 3)).astype(np.uint8)
    for entry in (j2f.pillow(px), j2f.pillow(px, no_jp2=True),
                  j2f.pillow(px[..., 0], irreversible=True)):
        ref = _same(tmp_path, rf.icns([(b"ic07", entry)]), "f.icns")
        assert ref.std() > 0.1
    p = tmp_path / "bad.icns"
    p.write_bytes(rf.icns([(b"ic07", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
                            + bytes(40))]))
    with pytest.raises(SyntaxError):
        lrt.read_image(str(p), False)
    with pytest.raises(SyntaxError):     # Pillow's OpenJPEG reads the box
        jimage.read_image(str(p), False)


def test_icns_cuts_and_mutations():
    good = rf.icns(ICNS["is32_rle_mask"][0])
    for cut in range(0, len(good), 7):
        assert _agree(good[:cut]), cut
    rng = np.random.default_rng(9)
    for _ in range(150):
        d = bytearray(good)
        k = int(rng.integers(0, len(d)))
        d[k] = int(rng.integers(0, 256))
        assert _agree(bytes(d)), k
