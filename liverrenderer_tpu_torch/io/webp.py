"""WebP files, as Pillow 12.1 opens them through libwebp 1.6's
WebPAnimDecoder (no PIL, no libwebp): the first frame on its canvas.

The container is checked as WebPDemux checks it: the RIFF size (a file
shorter than it fails, bytes past it are ignored), simple files (one
`VP8 ` or `VP8L` chunk, its size consistent with the frame header, any
chunk after it skipped), and VP8X files with their canvas, flags (bits
outside the five defined ones fail), ICCP/EXIF/XMP and unknown chunks
(skipped), ALPH before a `VP8 ` chunk (dropped when the alpha flag is
off, as the demuxer drops it), and ANIM/ANMF: the first frame is a key
frame, decoded at its offset on a zeroed canvas; the canvas outside it
reads (0, 0, 0).  A still frame must fill its canvas, an animation's
frames must lie inside it.  The bitstreams are decoded by io/vp8l.py
(lossless) and io/vp8.py (lossy); ALPH is raw or VP8L-compressed with
the none, horizontal, vertical and gradient filters (`alpha_plane`).
Every failure raises OSError, as Pillow's decoder object does.
"""
from __future__ import annotations

import struct

import numpy as np

from . import vp8, vp8l

_MAX_PAYLOAD = 0xFFFFFFFF - 8 - 1
_ALPHA_FLAG, _ANIM_FLAG, _VALID_FLAGS = 0x10, 0x02, 0x3E
_OK, _MORE, _ERROR = 0, 1, 2


def _u24(b: bytes, o: int) -> int:
    return b[o] | (b[o + 1] << 8) | (b[o + 2] << 16)


def _fail(why: str):
    return OSError(f"could not create decoder object ({why})")


class _Frame:
    def __init__(self):
        self.x = self.y = 0
        self.alpha = None      # (offset, size) of the ALPH chunk
        self.image = None      # (offset, size) of the VP8/VP8L chunk
        self.lossless = False
        self.width = self.height = 0
        self.num = 0


def _features(chunk: bytes):
    """WebPGetFeatures on one `VP8 `/`VP8L` chunk -> (w, h, lossless)."""
    size = struct.unpack_from("<I", chunk, 4)[0]
    body = chunk[8:]
    if chunk[:4] == b"VP8L":
        w, h, _ = vp8l.header(body)
        return w, h, True
    w, h = vp8.header(body, size)
    return w, h, False


def _store_frame(buf: bytes, pos: int, end: int, num: int, min_size: int,
                 frame: _Frame):
    """StoreFrame: the ALPH and image chunks from `pos` -> (status, pos)."""
    if end - pos < 8 or end - pos < min_size:
        return _MORE, pos
    alphas = images = 0
    status = _OK
    while True:
        start = pos
        tag = buf[pos:pos + 4]
        size = struct.unpack_from("<I", buf, pos + 4)[0]
        pos += 8
        if size > _MAX_PAYLOAD:
            return _ERROR, pos
        padded = size + (size & 1)
        avail = min(padded, end - pos)
        if padded > end - pos:
            return _ERROR, pos
        done = False
        if tag == b"ALPH" and not alphas:
            alphas = 1
            frame.alpha = (start, 8 + avail)
            frame.num = num
            pos += avail
        elif tag in (b"VP8 ", b"VP8L") and not images:
            if tag == b"VP8L" and alphas:
                return _ERROR, pos
            try:
                frame.width, frame.height, frame.lossless = \
                    _features(buf[start:start + 8 + avail])
            except (OSError, struct.error, IndexError):
                return _ERROR, pos
            images = 1
            frame.image = (start, 8 + avail)
            frame.num = num
            pos += avail
        else:
            pos = start
            done = True
        if pos == end:
            done = True
        elif end - pos < 8:
            status = _MORE
        if done or status != _OK:
            return status, pos


def demux(data: bytes):
    """WebPDemux on a whole file -> (canvas w, h, the first frame);
    OSError where libwebp returns no demuxer."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise _fail("not a complete RIFF header")
    riff = struct.unpack_from("<I", data, 4)[0]
    if riff < 8 or riff > _MAX_PAYLOAD:
        raise _fail("an invalid RIFF size")
    end = riff + 8
    if len(data) < end:
        raise _fail("a truncated file")
    buf = data[:end]
    pos = 12
    frames = []
    tag = buf[12:16]
    if tag in (b"VP8 ", b"VP8L"):
        f = _Frame()
        status, pos = _store_frame(buf, pos, end, 1, 0, f)
        if status != _OK or f.image is None or f.width <= 0:
            raise _fail("an invalid image chunk")
        f.alpha = None          # a simple file has no alpha flag
        return f.width, f.height, f
    # VP8X
    size = struct.unpack_from("<I", buf, 16)[0]
    if size > _MAX_PAYLOAD or size < 10:
        raise _fail("an invalid VP8X chunk")
    size += size & 1
    if size > end - 20:
        raise _fail("an invalid VP8X chunk")
    flags = buf[20]
    cw, ch = 1 + _u24(buf, 24), 1 + _u24(buf, 27)
    if cw * ch >= 1 << 32:
        raise _fail("a canvas too large")
    pos = 20 + size
    if end - pos < 8:
        raise _fail("no chunk after VP8X")
    anim = bool(flags & _ANIM_FLAG)
    anims = 0
    while True:
        start = pos
        tag = buf[pos:pos + 4]
        size = struct.unpack_from("<I", buf, pos + 4)[0]
        pos += 8
        if size > _MAX_PAYLOAD:
            raise _fail("an invalid chunk size")
        padded = size + (size & 1)
        if padded > end - pos:
            raise _fail("a chunk past the end of the file")
        if tag == b"VP8X":
            raise _fail("a second VP8X chunk")
        if tag in (b"ALPH", b"VP8 ", b"VP8L"):
            if anims or anim or frames:
                raise _fail("a still image in an animation")
            f = _Frame()
            status, pos = _store_frame(buf, start, end, 1, 0, f)
            if status != _OK:
                raise _fail("an invalid image chunk")
            if not flags & _ALPHA_FLAG:
                f.alpha = None
            if f.image is None:
                raise _fail("a frame without an image")
            frames.append(f)
        elif tag == b"ANIM":
            if padded < 6:
                raise _fail("a short ANIM chunk")
            anims += 1
            pos += padded
        elif tag == b"ANMF":
            if not anims:
                raise _fail("ANMF before ANIM")
            if padded < 16:
                raise _fail("a short ANMF chunk")
            f = _Frame()
            f.x, f.y = 2 * _u24(buf, pos), 2 * _u24(buf, pos + 3)
            if (1 + _u24(buf, pos + 6)) * (1 + _u24(buf, pos + 9)) >= 1 << 32:
                raise _fail("a frame too large")
            pos += 16
            mark = pos
            status, pos = _store_frame(buf, pos, end, len(frames) + 1,
                                       padded - 16, f)
            if status != _OK or pos - mark > padded - 16:
                raise _fail("an invalid frame")
            if anim and f.num > 0:
                if frames and frames[-1].image is None:
                    raise _fail("a frame after an incomplete one")
                frames.append(f)
        else:
            pos += padded
        if pos == end:
            break
        if end - pos < 8:
            raise _fail("a partial chunk header")
    if not frames or flags & ~_VALID_FLAGS & 0xFF:
        raise _fail("no frame, or invalid flags")
    for f in frames:
        if f.image is None:
            raise _fail("a frame without an image")
        if f.alpha is not None and f.alpha[0] > f.image[0]:
            raise _fail("ALPH after the image")
        if anim:
            if f.x + f.width > cw or f.y + f.height > ch:
                raise _fail("a frame outside the canvas")
        elif (f.x, f.y, f.width, f.height) != (0, 0, cw, ch):
            raise _fail("a still frame that does not fill its canvas")
    return cw, ch, frames[0]


def open_webp(data: bytes):
    """WebPImageFile._open -> a function that decodes the first frame."""
    cw, ch, frame = demux(data)
    return lambda: first_frame(data, cw, ch, frame)[..., :3]


def first_frame(data: bytes, cw: int, ch: int, frame: _Frame,
                plain: bool = False) -> np.ndarray:
    """WebPAnimDecoderGetNext of frame 1 -> the (ch, cw, 4) RGBA canvas."""
    off, size = frame.image
    body = data[off + 8:off + size]
    declared = struct.unpack_from("<I", data, off + 4)[0]
    if declared > len(body):
        raise OSError("failed to read next frame (a truncated bitstream)")
    if frame.lossless:
        argb = vp8l.decode(body, plain)
        rgba = np.stack([(argb >> s) & 0xFF for s in (16, 8, 0, 24)],
                        -1).astype(np.uint8)
    else:
        rgb = vp8.decode(body, plain)
        h, w = rgb.shape[:2]
        a = np.full((h, w, 1), 255, np.uint8)
        if frame.alpha is not None:
            aoff, _ = frame.alpha
            asize = struct.unpack_from("<I", data, aoff + 4)[0]
            a = alpha_plane(data[aoff + 8:aoff + 8 + asize], w, h,
                            plain)[..., None]
        rgba = np.concatenate([rgb, a], -1)
    h, w = rgba.shape[:2]
    canvas = np.zeros((ch, cw, 4), np.uint8)
    canvas[frame.y:frame.y + h, frame.x:frame.x + w] = rgba
    return canvas


def alpha_plane(payload: bytes, w: int, h: int,
                plain: bool = False) -> np.ndarray:
    """An ALPH chunk's payload -> the (h, w) alpha plane, as libwebp's
    ALPHDecode: header byte (method 0 raw / 1 lossless, filter, levels
    pre-processing, reserved 0), then the rows unfiltered in order."""
    if len(payload) <= 1:
        raise OSError("failed to read next frame (a short ALPH chunk)")
    method, filt = payload[0] & 3, (payload[0] >> 2) & 3
    pre, rsrv = (payload[0] >> 4) & 3, payload[0] >> 6
    if method > 1 or pre > 1 or rsrv:
        raise OSError("failed to read next frame (an invalid ALPH header)")
    if method == 0:
        if len(payload) - 1 < w * h:
            raise OSError("failed to read next frame (short raw alpha)")
        deltas = np.frombuffer(payload, np.uint8, w * h, 1).reshape(h, w)
    else:
        deltas = vp8l.decode_alpha(payload[1:], w, h, plain)
    return unfilter(deltas, filt)


def unfilter(deltas: np.ndarray, filt: int) -> np.ndarray:
    """WebPUnfilters[filt] row by row (0 none, 1 horizontal, 2 vertical,
    3 gradient); the first row of every filter is horizontal from 0."""
    if filt == 0:
        return deltas.copy()
    d = deltas.astype(np.int64)
    out = np.zeros_like(d)
    out[0] = np.cumsum(d[0]) & 0xFF
    for y in range(1, d.shape[0]):
        prev = out[y - 1]
        if filt == 1:
            out[y] = (np.cumsum(d[y]) + prev[0]) & 0xFF
        elif filt == 2:
            out[y] = (prev + d[y]) & 0xFF
        else:
            row = out[y]
            left, tl = prev[0], prev[0]
            for x in range(d.shape[1]):
                g = left + prev[x] - tl
                left = (d[y, x] + min(max(g, 0), 255)) & 0xFF
                tl = prev[x]
                row[x] = left
    return out.astype(np.uint8)
