"""JPEG 2000 files for the tests: Pillow's writer (OpenJPEG 2.5.4) over
its options, and a composer, from the port's own tier-1 and tier-2, of
what Pillow's writer cannot make.

- `pillow(px, **opts)`: Image.fromarray(px).save(..., "JPEG2000", **opts)
  (reversible or irreversible, quality_layers, tile_size / tile_offset /
  offset, precinct_size, the five progressions, codeblock_size,
  num_resolutions, mct, signed, comment, plt, no_jp2, the cinema modes).
- `compose(...)`: a lossless codestream of integer components with the
  switches turned on: the six code-block style switches, SOP / EPH,
  several layers, any progression with POC entries, PPM or PPT packet
  headers, several tile-parts, RGN (max-shift of a whole component),
  COC / QCC, per-component subsampling and precision
  (1 to 16 bits, signed), RCT.  `jp2(...)` wraps a codestream in JP2
  boxes (colr, pclr / cmap, cdef).
- `files()`: every file the tests read, by name.
- `committed(name)`: the bytes of tests/data/<name> as written here.

Pillow is the reference for every file: the tests read each one through
the JAX package (Pillow) and through the port.
"""
from __future__ import annotations

import io
import struct

import numpy as np

from liverrenderer_tpu_torch.io import j2k_dwt, j2k_t1, j2k_t2, jpeg2000


def pillow(px: np.ndarray, mode: str = None, **opts) -> bytes:
    from PIL import Image
    im = Image.fromarray(px)
    if mode:
        im = im.convert(mode)
    b = io.BytesIO()
    im.save(b, format="JPEG2000", **opts)
    return b.getvalue()


def _seg(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def _spcod(numres, cblk, sty, prec_exps) -> bytes:
    b = bytes([numres - 1, cblk[0] - 2, cblk[1] - 2, sty, 1])
    if prec_exps is not None:
        b += bytes((py << 4) | px for px, py in prec_exps[:numres])
    return b


def _sqcd(numres, prec, guard) -> bytes:
    gains = [0] + [1, 1, 2] * (numres - 1)
    return bytes([guard << 5] + [(prec + g) << 3 for g in gains])


def compose(comps, prec=8, signed=False, sub=None, numres=3, cblk=(4, 4),
            sty=0, sop=False, eph=False, layers=1, prg=0, pocs=None,
            prec_exps=None, ppm=False, ppt=False, roi=None, coc=None,
            qcc=None, mct=False, parts=1, guard=2) -> bytes:
    """A one-tile lossless codestream at the origin.

    comps: (h_c, w_c) integer samples of each component (already
    subsampled by `sub`, a (dx, dy) a component); prec / signed: an int
    or one a component; coc: {component: (numres, cblk, sty)}; qcc:
    {component: guard bits}; roi: (component, shift): every coefficient
    of the component shifted up (max-shift with no background); pocs:
    [(resno0, compno0, layno1, resno1, compno1, order)]."""
    n = len(comps)
    precs = [prec] * n if np.isscalar(prec) else list(prec)
    sgnd = [signed] * n if np.isscalar(signed) else list(signed)
    sub = sub or [(1, 1)] * n
    h = comps[0].shape[0] * sub[0][1]
    w = comps[0].shape[1] * sub[0][0]
    for c, (dx, dy) in zip(comps, sub):
        assert c.shape == (-(-h // dy), -(-w // dx)), "component size"
    coc = coc or {}
    qcc = qcc or {}
    csty = (1 if prec_exps is not None else 0) | (2 if sop else 0) \
        | (4 if eph else 0)
    main = b"\xff\x4f" + _seg(0xFF51, struct.pack(
        ">HIIIIIIIIH", 0, w, h, 0, 0, w, h, 0, 0, n) + b"".join(
        bytes([(p - 1) | (0x80 if s else 0), dx, dy])
        for p, s, (dx, dy) in zip(precs, sgnd, sub)))
    main += _seg(0xFF52, bytes([csty, prg]) + struct.pack(">H", layers)
                 + bytes([1 if mct else 0])
                 + _spcod(numres, cblk, sty, prec_exps))
    for c, (nr, cb, st) in sorted(coc.items()):
        main += _seg(0xFF53, bytes([c, 1 if prec_exps is not None else 0])
                     + _spcod(nr, cb, st, prec_exps))
    main += _seg(0xFF5C, _sqcd(numres, precs[0], guard))
    for c, g in sorted(qcc.items()):
        nr = coc.get(c, (numres,))[0]
        main += _seg(0xFF5D, bytes([c]) + _sqcd(nr, precs[c], g))
    if roi:
        main += _seg(0xFF5E, bytes([roi[0], 0, roi[1]]))
    if pocs:
        main += _seg(0xFF5F, b"".join(
            struct.pack(">BBHBBB", *p) for p in pocs))
    # the geometry, as the port's reader builds it from this header
    cs = jpeg2000.Codestream(main + b"\xff\x90", 0)
    cs.read_header()
    tcp = cs.tcps[0]
    tile = jpeg2000.tile_geometry(cs, 0, tcp)
    samples = []
    for c, (a, p, s) in enumerate(zip(comps, precs, sgnd)):
        samples.append(a.astype(np.int64) - (0 if s else 1 << (p - 1)))
    if mct:
        r, g, b = samples[:3]
        samples[:3] = [(r + 2 * g + b) >> 2, b - g, r - g]
    tree = []
    for c, comp in enumerate(tile["comps"]):
        tccp = comp["tccp"]
        nres = tccp["numres"]
        ll, details = j2k_dwt.forward_53(samples[c], [(0, 0)] * nres)
        arrays = [[ll]] + [list(d) for d in details]
        res_out = []
        for r, res in enumerate(comp["res"]):
            bands = []
            for band, arr in zip(res["bands"], arrays[r]):
                arr = arr.copy()
                if roi and roi[0] == c:
                    arr <<= roi[1]
                numbps = band["numbps"]
                precincts = []
                for prc in band["precincts"]:
                    cblks = []
                    for cb in prc["cblks"]:
                        blk = arr[cb["y0"] - band["y0"]:cb["y1"] - band["y0"],
                                  cb["x0"] - band["x0"]:cb["x1"] - band["x0"]]
                        nb, passes, data = j2k_t1.encode_block(
                            blk, band["bandno"], tccp["cblksty"])
                        if roi and roi[0] == c and nb:
                            nb -= roi[1]
                        cblks.append(_layers(nb, passes, data, layers))
                    precincts.append(dict(cblks=cblks, incl=prc["incl"],
                                          imsb=prc["imsb"]))
                bands.append(dict(numbps=numbps, empty=band["empty"],
                                  precincts=precincts))
            res_out.append(bands)
        tree.append(res_out)
    packets = []
    for k, (lay, r, c, p) in enumerate(j2k_t2.packets(tile, tcp)):
        bands = [b for b in tree[c][r] if not b["empty"]]
        head = j2k_t2.write_header(bands, p, lay).flush()
        if eph:
            head += b"\xff\x92"
        body = b"".join(cb["layers"][lay][2] for b in bands
                        for cb in b["precincts"][p]["cblks"])
        if sop:
            body = struct.pack(">HHH", 0xFF91, 4, k & 0xFFFF) + body
        packets.append((head, body))
    groups = [packets[i * len(packets) // parts:
                      (i + 1) * len(packets) // parts] for i in range(parts)]
    if ppm:
        stream = b"".join(struct.pack(">I", len(b"".join(h for h, _ in g)))
                          + b"".join(h for h, _ in g) for g in groups)
        main += b"".join(_seg(0xFF60, bytes([z]) + stream[o:o + 60000])
                         for z, o in enumerate(range(0, len(stream), 60000)))
    out = main
    for i, g in enumerate(groups):
        hdr = b""
        if ppt:
            hdr = _seg(0xFF61, bytes([i]) + b"".join(h for h, _ in g))
        if ppm or ppt:
            data = b"".join(body for _, body in g)
        else:
            data = b"".join(_join(h, body, sop) for h, body in g)
        out += _seg(0xFF90, struct.pack(">HIBB", 0, 12 + len(hdr) + 2
                                        + len(data), i, parts))
        out += hdr + b"\xff\x93" + data
    return out + b"\xff\xd9"


def _join(head: bytes, body: bytes, sop: bool) -> bytes:
    """A packet in the tile data: SOP (which `body` starts with) comes
    before the header."""
    if sop:
        return body[:6] + head + body[6:]
    return head + body


def _layers(nb, passes, data, layers) -> dict:
    """A code-block's passes spread over `layers` layers: (passes,
    [(length, terminated)], bytes) a layer."""
    out, k0, prev = [], 0, 0
    for lay in range(layers):
        k1 = (lay + 1) * len(passes) // layers
        lens, pr = [], prev
        for rate, term in passes[k0:k1]:
            lens.append((rate - pr, term))
            pr = rate
        out.append((k1 - k0, lens, data[prev:pr]))
        prev, k0 = pr, k1
    return dict(numbps=nb, layers=out)


def jp2(codestream: bytes, nc: int, enumcs: int = 16, bpc: int = 7,
        pclr=None, cdef=None, colr: bytes = None, size=None) -> bytes:
    """JP2 boxes around a codestream: ihdr (size: the codestream's), colr
    (method 1 with `enumcs`, or the body `colr`), pclr + cmap (pclr:
    (n, channels) uint8 entries, every channel 8 bits, each mapped from
    component 0), cdef ([(channel, type, association)])."""
    if size is None:
        size = struct.unpack_from(">II", codestream, 8)
    w, h = size

    def box(t, b):
        return struct.pack(">I", 8 + len(b)) + t + b
    head = box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))
    head += box(b"colr", colr if colr is not None
                else struct.pack(">BBBI", 1, 0, 0, enumcs))
    if pclr is not None:
        ne, npc = pclr.shape
        head += box(b"pclr", struct.pack(">HB", ne, npc) + bytes([7] * npc)
                    + pclr.astype(np.uint8).tobytes())
        head += box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, i)
                                      for i in range(npc)))
    if cdef:
        head += box(b"cdef", struct.pack(">H", len(cdef)) + b"".join(
            struct.pack(">HHH", *d) for d in cdef))
    return (box(b"jP  ", b"\r\n\x87\n") + box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + box(b"jp2h", head) + box(b"jp2c", codestream))


# ------------------------------------------------------ committed files ----
FLOOR_OPTS = dict(irreversible=True, mct=1, quality_layers=[40, 20, 10],
                  tile_size=(128, 128), tile_offset=(8, 4), offset=(32, 16),
                  precinct_size=(64, 64), progression="RPCL", no_jp2=True)


def committed(name: str) -> bytes:
    """The bytes of tests/data/<name> as written here:

    - torch_height_j2k.jp2: liver_proxy's 1,024^2 height map (BUMP, seed
      0) as 8-bit codes, lossless, as Pillow saves it with its defaults
      (and io/jpeg2000.encode_jpeg2000 writes it);
    - torch_height32_j2k.jp2: the 32^2 map, the same way;
    - torch_floor.j2k: torch_xml_files.floor_texture(256) as a lossy
      codestream (9/7, ICT, layers at rates 40, 20 and 10, 128^2 tiles
      offset by (8, 4) under an image offset of (32, 16), 64^2 precincts,
      RPCL), by Pillow's writer;
    - torch_floor_j2k.png: Pillow's decode of torch_floor.j2k, written by
      io/png.write_png."""
    import os
    import tempfile

    from PIL import Image

    from liverrenderer_tpu_torch.io.png import write_png
    from liverrenderer_tpu_torch.scene.liver_proxy import BUMP, height_map
    from torch_xml_files import floor_texture
    if name.startswith("torch_height"):
        res = 32 if "32" in name else BUMP[0]
        codes = np.round(height_map(res, 0) * 255.0).astype(np.uint8)
        return pillow(codes)
    j2k = pillow(floor_texture(256), **FLOOR_OPTS)
    if name.endswith(".j2k"):
        return j2k
    px = np.asarray(Image.open(io.BytesIO(j2k)).convert("RGB"))
    fd, path = tempfile.mkstemp(suffix=".png")
    os.close(fd)
    try:
        write_png(path, px)
        with open(path, "rb") as fh:
            return fh.read()
    finally:
        os.unlink(path)


# ------------------------------------------------------------ the files ----
def files() -> dict:
    """name -> the bytes of every JPEG 2000 file the tests read (a name
    ending in _fails is one Pillow refuses at load)."""
    from torch_xml_files import floor_texture
    rng = np.random.default_rng(24)
    h, w = 20, 27
    yy, xx = np.mgrid[0:40, 0:52]
    smooth = np.stack([(xx * 5) % 256, (yy * 3 + xx) % 256,
                       (xx * yy // 7) % 256], -1).astype(np.uint8)
    grey = rng.integers(0, 256, (h, w)).astype(np.uint8)
    rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    rgba = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    big = rng.integers(0, 256, (70, 66)).astype(np.uint8)
    i16 = rng.integers(0, 65536, (h, w)).astype(np.uint16)
    tiles = dict(tile_size=(24, 20), tile_offset=(3, 5), offset=(7, 9))
    out = {
        "rev_L": pillow(grey), "rev_L_j2k": pillow(grey, no_jp2=True),
        "rev_RGB": pillow(rgb), "rev_RGBA": pillow(rgba),
        "rev_LA": pillow(np.stack([grey, grey[::-1]], -1)),
        "rev_I16": _pillow_i16(i16),
        "irr_RGB": pillow(smooth, irreversible=True),
        "irr_mct": pillow(smooth, irreversible=True, mct=1),
        "irr_L_odd_offset": pillow(smooth[..., 1], irreversible=True,
                                   offset=(3, 5), tile_size=(64, 64)),
        "rct": pillow(smooth, mct=1),
        "layers": pillow(smooth, irreversible=True,
                         quality_layers=[30, 10, 4]),
        "layers_db": pillow(smooth, quality_mode="dB",
                            quality_layers=[30, 40]),
        "tiles": pillow(smooth, irreversible=True, **tiles),
        "tiles_rev": pillow(smooth, **tiles),
        "precincts_fails": pillow(smooth, precinct_size=(16, 16),
                            codeblock_size=(8, 8)),
        "cblk_8x32": pillow(smooth, codeblock_size=(8, 32)),
        "res1": pillow(grey, num_resolutions=1),
        "res7": pillow(big, num_resolutions=7),
        "signed": pillow(smooth, signed=True),
        "comment_plt": pillow(smooth, comment="made for the port", plt=True),
    }
    for cinema in ("cinema2k-24", "cinema2k-48", "cinema4k-24"):
        out[cinema] = pillow(np.repeat(smooth, 2, 0)[:64, :52],
                             cinema_mode=cinema)
    for prg in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        out["prog_" + prg] = pillow(
            smooth, progression=prg, precinct_size=(32, 32),
            codeblock_size=(8, 8), quality_layers=[20, 6, 2],
            irreversible=prg in ("RPCL", "CPRL"), **tiles)
    g = grey.astype(np.int64)
    c3 = [rgb[..., k].astype(np.int64) for k in range(3)]
    styles = dict(lazy=j2k_t1.LAZY, reset=j2k_t1.RESET,
                  termall=j2k_t1.TERMALL, vsc=j2k_t1.VSC,
                  pterm=j2k_t1.PTERM, segsym=j2k_t1.SEGSYM, all=63)
    for nm, sty in styles.items():
        out["sty_" + nm] = compose([g], sty=sty, layers=3)
    half = [rng.integers(0, 256, (10, 14)) for _ in range(2)]
    out.update({
        "sop_eph": compose(c3, sop=True, eph=True, layers=2),
        "poc": compose(c3, layers=2, pocs=[(0, 0, 1, 2, 3, 1),
                                           (1, 0, 2, 3, 3, 2)]),
        "poc_cprl": compose(c3, layers=2, prg=4, prec_exps=[(2, 2)] * 3,
                            pocs=[(0, 1, 2, 3, 3, 0), (0, 0, 2, 3, 1, 4)]),
        "ppm": compose(c3, ppm=True, layers=2, parts=2),
        "ppt": compose(c3, ppt=True, layers=2, parts=2, sop=True, eph=True),
        "tile_parts": compose(c3, parts=3, layers=2),
        "rgn": compose(c3, roi=(1, 4)),
        "coc_qcc": compose(c3, coc={1: (2, (3, 5), j2k_t1.LAZY)},
                           qcc={2: 3}),
        "rct_composed": compose(c3, mct=True),
        "prec1": compose([g & 1], prec=1),
        "prec5": compose([g >> 3], prec=5),
        "prec12": compose([g * 16 + 5], prec=12),
        "prec12_rgb": compose([c * 16 + (c & 15) for c in c3], prec=12),
        "prec16": compose([g * 257], prec=16),
        "signed5": compose([(g >> 3) - 16], prec=5, signed=True),
        "ycc420_j2k": compose([g] + half, sub=[(1, 1), (2, 2), (2, 2)]),
        "ycc420_jp2": jp2(compose([g] + half, sub=[(1, 1), (2, 2), (2, 2)]),
                          3, enumcs=18),
        "sycc444": jp2(compose(c3), 3, enumcs=18),
        "pclr": jp2(compose([g % 6]), 1, pclr=rng.integers(0, 256, (6, 3))),
        "pclr_dup_rgba": jp2(compose([g % 5]), 1, pclr=np.array(
            [[1, 2, 3, 255], [9, 9, 9, 255], [1, 2, 3, 255],
             [200, 0, 50, 255], [4, 5, 6, 255]])),
        "pclr_grey_fails": jp2(compose([g % 6]), 1, enumcs=17,
                               pclr=rng.integers(0, 256, (6, 3))),
        "cmyk": jp2(compose(c3 + [g]), 4, enumcs=12),
        "icc": jp2(compose(c3), 3, colr=b"\x02\x00\x00" + bytes(40)),
        "eycc_fails": jp2(compose(c3), 3, enumcs=24),
        "grey_rgba4": jp2(compose(c3 + [g]), 4, enumcs=17),
    })
    out["floor"] = pillow(floor_texture(256)[:96, :96], **FLOOR_OPTS)
    return out


def _pillow_i16(a: np.ndarray) -> bytes:
    from PIL import Image
    b = io.BytesIO()
    Image.frombytes("I;16", a.shape[::-1], a.astype("<u2").tobytes()).save(
        b, format="JPEG2000")
    return b.getvalue()
