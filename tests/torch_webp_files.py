"""WebP test files for the port's decoder (tests/test_torch_webp.py,
tests/test_torch_m9c_slice.py), written by the libwebp that Pillow
bundles (no JAX, no port).

`encode` calls libwebp's advanced encoder API through ctypes, so a test
reaches settings Pillow's WebP writer does not expose: the simple loop
filter, the filter strength and sharpness, 1-4 segments, spatial noise
shaping, the token-partition count (libwebp 1.6 writes one partition
whatever it asks), raw or lossless alpha and each alpha
filter.  `animation` wraps bitstreams of still files in VP8X / ANIM /
ANMF chunks with the frame offsets a test chooses, `chunk` and `riff`
build the containers by hand, and `repartition` spreads a lossy frame's
macroblock rows over 2-8 token partitions (the port's plain decoder
records the boolean decisions, RFC 6386's encoder writes them again).
"""
import ctypes
import glob
import os
import struct

import numpy as np
import PIL

_LIB = None
# WebPConfig's int/float fields in order (libwebp 1.6 encode.h)
_CONFIG = ("lossless", "quality", "method", "image_hint", "target_size",
           "target_PSNR", "segments", "sns_strength", "filter_strength",
           "filter_sharpness", "filter_type", "autofilter",
           "alpha_compression", "alpha_filtering", "alpha_quality", "pass",
           "show_compressed", "preprocessing", "partitions",
           "partition_limit", "emulate_jpeg_size", "thread_level",
           "low_memory", "near_lossless", "exact", "use_delta_palette",
           "use_sharp_yuv", "qmin", "qmax")
_FLOATS = {"quality", "target_PSNR"}


class _Writer(ctypes.Structure):
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)),
                ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t),
                ("pad", ctypes.c_uint32)]


def _lib():
    global _LIB
    if _LIB is None:
        from PIL import _webp  # noqa: F401 - loads libwebp's dependencies
        root = os.path.dirname(os.path.dirname(PIL.__file__))
        path = sorted(glob.glob(os.path.join(root, "pillow.libs",
                                             "libwebp-*.so*")))[0]
        _LIB = ctypes.CDLL(path)
    return _LIB


def encode(img: np.ndarray, **config) -> bytes:
    """(H, W, 3 or 4) uint8 -> a WebP file from WebPEncode with libwebp's
    default config (quality 75) changed by `config` (WebPConfig fields)."""
    lib = _lib()
    cfg = (ctypes.c_int32 * 64)()
    assert lib.WebPConfigInitInternal(cfg, 0, ctypes.c_float(75.0), 0x0210)
    for k, v in config.items():
        i = _CONFIG.index(k)
        if k in _FLOATS:
            ctypes.cast(ctypes.byref(cfg, 4 * i),
                        ctypes.POINTER(ctypes.c_float))[0] = float(v)
        else:
            cfg[i] = int(v)
    assert lib.WebPValidateConfig(cfg), config
    pic = (ctypes.c_uint8 * 512)()
    assert lib.WebPPictureInitInternal(pic, 0x0210)
    h, w, c = img.shape
    struct.pack_into("<iiii", pic, 0, int(config.get("lossless", 0)), 0, w, h)
    px = np.ascontiguousarray(img, np.uint8)
    imp = lib.WebPPictureImportRGBA if c == 4 else lib.WebPPictureImportRGB
    assert imp(pic, px.ctypes.data_as(ctypes.c_void_p), w * c)
    wr = _Writer()
    lib.WebPMemoryWriterInit(ctypes.byref(wr))
    # WebPPicture.writer and .custom_ptr
    struct.pack_into("<QQ", pic, 96,
                     ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value,
                     ctypes.addressof(wr))
    ok = lib.WebPEncode(cfg, pic)
    out = ctypes.string_at(wr.mem, wr.size)
    lib.WebPPictureFree(pic)
    lib.WebPMemoryWriterClear(ctypes.byref(wr))
    assert ok, "WebPEncode failed"
    return out


def chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("<I", len(payload)) + payload \
        + (b"\0" if len(payload) & 1 else b"")


def riff(chunks: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WEBP" + chunks


def image_chunks(data: bytes) -> bytes:
    """The ALPH / VP8 / VP8L chunks of a still WebP file."""
    pos, out = 12, b""
    while pos + 8 <= len(data):
        tag = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        end = pos + 8 + size + (size & 1)
        if tag in (b"ALPH", b"VP8 ", b"VP8L"):
            out += data[pos:end]
        pos = end
    return out


def vp8x(flags: int, w: int, h: int) -> bytes:
    return chunk(b"VP8X", bytes([flags, 0, 0, 0])
                 + (w - 1).to_bytes(3, "little")
                 + (h - 1).to_bytes(3, "little"))


def animation(canvas, frames, background=0, loop=0, flags=0x12) -> bytes:
    """frames: (still WebP file, x, y) -> an animated WebP (ANIM + ANMF);
    x and y even."""
    body = vp8x(flags, *canvas) + chunk(b"ANIM",
                                        struct.pack("<IH", background, loop))
    for data, x, y in frames:
        img = image_chunks(data)
        w, h = _size(data)
        body += chunk(b"ANMF", (x // 2).to_bytes(3, "little")
                      + (y // 2).to_bytes(3, "little")
                      + (w - 1).to_bytes(3, "little")
                      + (h - 1).to_bytes(3, "little")
                      + (100).to_bytes(3, "little") + b"\0" + img)
    return riff(body)


def _size(data: bytes):
    from PIL import Image
    import io
    return Image.open(io.BytesIO(data)).size


# ------------------------------------------ the committed card files ----
def height_codes(res: int) -> np.ndarray:
    """bench.py's height map at `res`^2 as the 8-bit codes of
    tests/data/torch_height.png/.tif/.jpg."""
    from liverrenderer_tpu_torch.scene.liver_proxy import height_map
    return np.round(height_map(res, 0) * 255.0).astype(np.uint8)


def committed_webp(name: str) -> bytes:
    """The bytes of tests/data/<name>, as Pillow (libwebp 1.6) writes
    them: torch_height.webp (the 1,024^2 height codes, lossy, quality 75),
    torch_height32.webp (the 32^2 codes), torch_height_crop.webp (the
    codes' top-left 256^2), torch_alpha64.webp (a seeded 64^2 RGBA
    image, lossless) and torch_anim.webp (two lossy frames, the first 48 x 40
    with alpha at (8, 12) on a 64^2 canvas)."""
    from PIL import Image
    import io

    def save(img, **kw):
        b = io.BytesIO()
        Image.fromarray(img).save(b, "WEBP", **kw)
        return b.getvalue()

    if name == "torch_height.webp":
        return save(height_codes(1024), quality=75)
    if name == "torch_height32.webp":
        return save(height_codes(32), quality=75)
    if name == "torch_height_crop.webp":
        return save(np.ascontiguousarray(height_codes(1024)[:256, :256]),
                    quality=75)
    y, x = np.mgrid[0:64, 0:64]
    noise = np.random.default_rng(0).integers(-20, 21, (64, 64, 4))
    rgba = (np.stack([x * 4, y * 4, (x + y) * 2, 255 - 3 * np.abs(x - y)],
                     -1) + noise).clip(0, 255).astype(np.uint8)
    if name == "torch_alpha64.webp":
        return save(rgba, lossless=True)
    assert name == "torch_anim.webp"
    first = save(np.ascontiguousarray(rgba[:40, :48]), quality=70)
    second = save(np.ascontiguousarray(rgba[..., :3][::-1]), quality=70)
    return animation((64, 64), [(first, 8, 12), (second, 0, 0)])


# ------------------------------------ token partitions, re-encoded ----
def _bool_encode(decisions) -> bytes:
    """RFC 6386's boolean encoder (section 7.3) over (prob, bit) pairs,
    flushed as the RFC flushes it."""
    out = bytearray()
    rng, bottom, count = 255, 0, 24

    def carry():
        i = len(out) - 1
        while i >= 0 and out[i] == 255:
            out[i] = 0
            i -= 1
        out[i] += 1

    for prob, bit in decisions:
        split = 1 + (((rng - 1) * prob) >> 8)
        if bit:
            bottom += split
            rng -= split
        else:
            rng = split
        while rng < 128:
            rng <<= 1
            if bottom & (1 << 31):
                carry()
            bottom = (bottom << 1) & 0xFFFFFFFF
            count -= 1
            if not count:
                out.append((bottom >> 24) & 0xFF)
                bottom &= (1 << 24) - 1
                count = 8
    if bottom & (1 << (32 - count)):
        carry()
    v = (bottom << (count & 7)) & 0xFFFFFFFF
    for _ in range(count >> 3):
        v = (v << 8) & 0xFFFFFFFF
    for _ in range(4):
        out.append(v >> 24)
        v = (v << 8) & 0xFFFFFFFF
    return bytes(out)


def repartition(body: bytes, log2_parts: int) -> bytes:
    """A one-partition VP8 key frame (a `VP8 ` chunk's payload) re-encoded
    with 2^log2_parts token partitions: the boolean decisions of the
    port's plain decoder are recorded (each token read with its
    macroblock row) and written again, partition 0 with the new count."""
    import sys
    from liverrenderer_tpu_torch.io import vp8

    readers = []

    class Recorder(vp8._Bool):
        def __init__(self, data):
            super().__init__(data)
            self.log = []
            readers.append(self)

        def bit(self, prob):
            b = super().bit(prob)
            f = sys._getframe(1)
            while f is not None and f.f_code.co_name != "_frame_plain":
                f = f.f_back
            row = f.f_locals.get("mb_y", -1) if f is not None else -1
            self.log.append((prob, b, row))
            return b

    orig = vp8._Bool
    vp8._Bool = Recorder
    try:
        vp8._frame_plain(body)
    finally:
        vp8._Bool = orig
    part0, tokens = readers
    # partition 0: the 2-bit partition count follows the filter header;
    # it is the only get(2) made with probability 128 before the
    # quantiser, found as the decisions the original count produced
    dec = [(p, b) for p, b, _ in part0.log]
    idx = _count_position(body)
    assert dec[idx][1] == 0 and dec[idx + 1][1] == 0
    dec[idx] = (128, (log2_parts >> 1) & 1)
    dec[idx + 1] = (128, log2_parts & 1)
    p0 = _bool_encode(dec)
    n = 1 << log2_parts
    parts = [_bool_encode([(p, b) for p, b, row in tokens.log
                           if row % n == k]) for k in range(n)]
    tag = (int.from_bytes(body[:3], "little") & 0x1F) | (len(p0) << 5)
    sizes = b"".join(len(q).to_bytes(3, "little") for q in parts[:-1])
    return tag.to_bytes(3, "little") + body[3:10] + p0 + sizes \
        + b"".join(parts)


def _count_position(body: bytes) -> int:
    """The index, among partition 0's boolean decisions, of the first of
    the two bits that give log2 of the token-partition count."""
    from liverrenderer_tpu_torch.io import vp8
    part0 = int.from_bytes(body[:3], "little") >> 5
    br = vp8._Bool(body[10:10 + part0])
    n = 0

    def get(k):
        nonlocal n
        n += k
        return br.get(k)

    def sget(k):
        nonlocal n
        v = get(k)
        n += 1
        return -v if br.bit(0x80) else v

    get(2)
    if get(1):
        upd = get(1)
        if get(1):
            get(1)
            for _ in range(8):
                if get(1):
                    sget(7 if _ < 4 else 6)
        if upd:
            for _ in range(3):
                if get(1):
                    get(8)
    get(1 + 6 + 3)
    if get(1) and get(1):
        for _ in range(8):
            if get(1):
                sget(6)
    return n
