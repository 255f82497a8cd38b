"""Scene files for the loader's tests and for chip_smoke.py: bench.py's
workload path on the liver proxy (biovolpath, depth 12, a height map on
the dielectric, a lat-long sky) written as Mitsuba XML with a binary PLY
mesh, an 8-bit grey PNG height map and a half-float EXR sky, and the
SphereLiverConstEnv sphere, whose liver medium gives absorption spectra as
"lambda:value" tables.  No JAX: chip_smoke.py loads this file by path.

The package has no XML or PLY writer (nor has the JAX package); these
writers exist for the tests and the smoke run only.
"""
import os
import shutil

import numpy as np

from liverrenderer_tpu_torch.io.exr import write_exr
from liverrenderer_tpu_torch.io.png import write_png
from liverrenderer_tpu_torch.scene.liver_proxy import (height_map,
                                                       liver_mesh, sky_map)

# absorption spectra of the liver medium, as the fork's scenes give them
# ("lambda:value" pairs, nm : 1/mm): sigma_blood falls off toward the
# red, sigma_lipid_water is one pair (a constant)
SIGMA_BLOOD = "400:0.31, 450:0.27, 500:0.24, 550:0.21, 600:0.06, " \
    "650:0.008, 700:0.005"
SIGMA_LIPID_WATER = "550:0.001"


def write_ply(path, v, f, n=None, uv=None):
    """A binary little-endian PLY: float x y z (nx ny nz) (u v) per
    vertex, uchar-counted int triangle lists."""
    cols = [np.asarray(v, "<f4")]
    props = ["x", "y", "z"]
    if n is not None:
        cols.append(np.asarray(n, "<f4"))
        props += ["nx", "ny", "nz"]
    if uv is not None:
        cols.append(np.asarray(uv, "<f4"))
        props += ["u", "v"]
    vert = np.ascontiguousarray(np.concatenate(cols, 1), "<f4")
    f = np.asarray(f)
    face = np.zeros(len(f), np.dtype([("n", "u1"), ("i", "<i4", 3)]))
    face["n"], face["i"] = 3, f
    hdr = ["ply", "format binary_little_endian 1.0",
           f"element vertex {len(vert)}"]
    hdr += [f"property float {p}" for p in props]
    hdr += [f"element face {len(f)}",
            "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as fh:
        fh.write(("\n".join(hdr) + "\n").encode("ascii"))
        fh.write(vert.tobytes())
        fh.write(face.tobytes())


def _liver_medium_xml(spectra=True):
    """The liver medium of liver_proxy.liver_medium() as XML; with
    `spectra` sigma_blood and sigma_lipid_water are lambda:value tables."""
    lines = ['<medium type="liver" id="liver_med">',
             '  <float name="scale" value="1.0"/>']
    for i, (c, e) in enumerate([(3.0, 0.1), (2.7, 0.4), (0.003, 0.5),
                                (0.023, 0.2)], start=1):
        for ch, f in zip("RGB", (1.0, 0.7, 0.5)):
            lines.append(f'  <float name="sigma_collagen{i}_{ch}" '
                         f'value="{c * f!r}"/>')
            lines.append(f'  <float name="sigma_elastin{i}_{ch}" '
                         f'value="{e * f!r}"/>')
    if spectra:
        lines.append(f'  <spectrum name="sigma_blood" value="{SIGMA_BLOOD}"/>')
        lines.append('  <spectrum name="sigma_lipid_water" '
                     f'value="{SIGMA_LIPID_WATER}"/>')
    else:
        lines.append('  <rgb name="sigma_blood" value="0.005 0.2 0.25"/>')
        lines.append('  <rgb name="sigma_lipid_water" '
                     'value="0.005, 0.0005, 0.001"/>')
    lines += ['  <rgb name="sigma_bile" value="0.002, 0.003, 0.025"/>',
              '  <float name="sigma_hepatocity" value="269"/>',
              '</medium>']
    return "\n".join("  " + ln for ln in lines)


def floor_texture(n=64, seed=0):
    """(n, n, 3) uint8: an 8-pixel checker of two seeded colours under a
    left-to-right ramp, the floor's bitmap (tests/data/torch_floor.gif is
    Pillow's GIF of floor_texture())."""
    y, x = np.mgrid[0:n, 0:n]
    base = np.random.default_rng(seed).uniform(0.2, 0.9, (2, 3))
    tex = base[(x // 8 + y // 8) % 2] * (0.6 + 0.4 * x[..., None] / (n - 1))
    return np.round(tex * 255).astype(np.uint8)


def _floor_xml(floor_file):
    """A diffuse 6 x 6 floor under the liver, its reflectance the bitmap
    `floor_file` (sRGB)."""
    if floor_file is None:
        return ""
    return f"""  <shape type="rectangle">
    <transform name="to_world">
      <scale value="3"/>
      <rotate x="1" angle="-90"/>
      <translate y="-1.1"/>
    </transform>
    <bsdf type="diffuse">
      <texture type="bitmap" name="reflectance">
        <string name="filename" value="{floor_file}"/>
      </texture>
    </bsdf>
  </shape>
"""


def proxy_xml(width, height, spp, max_depth=12, integrator="biovolpath",
              bump_scale=0.05, height_file="height.png", floor_file=None):
    """bench.py's workload path on the proxy as a Mitsuba XML scene: film,
    spp, depth and integrator are <default>s; the liver's dielectric is a
    named bsdf that a bumpmap refs; the mesh, height map and sky are the
    files liver.ply, `height_file` (raw) and sky.exr; `floor_file` adds a
    floor textured with that bitmap."""
    return f"""<scene version="3.0.0">
  <default name="res_width" value="{width}"/>
  <default name="res_height" value="{height}"/>
  <default name="spp" value="{spp}"/>
  <default name="max_depth" value="{max_depth}"/>
  <default name="integrator" value="{integrator}"/>
  <integrator type="$integrator">
    <integer name="max_depth" value="$max_depth"/>
  </integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="to_world">
      <lookat origin="0, 0.8, 5" target="0 0 0" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="$res_width"/>
      <integer name="height" value="$res_height"/>
      <rfilter type="box"/>
    </film>
    <sampler type="independent">
      <integer name="sample_count" value="$spp"/>
    </sampler>
  </sensor>
  <bsdf type="dielectric" id="liver_dielectric">
    <float name="int_ior" value="1.38"/>
    <float name="ext_ior" value="1.0"/>
  </bsdf>
{_liver_medium_xml()}
  <shape type="ply" id="liver">
    <string name="filename" value="liver.ply"/>
    <bsdf type="bumpmap">
      <float name="scale" value="{bump_scale!r}"/>
      <texture type="bitmap">
        <string name="filename" value="{height_file}"/>
        <boolean name="raw" value="true"/>
      </texture>
      <ref id="liver_dielectric"/>
    </bsdf>
    <ref name="interior" id="liver_med"/>
  </shape>
{_floor_xml(floor_file)}  <emitter type="envmap">
    <string name="filename" value="sky.exr"/>
  </emitter>
</scene>
"""


def write_proxy_files(dirpath, width, height, spp, subdiv=4, seed=0,
                      bump_res=1024, sky=(1024, 512), max_depth=12,
                      sky_file=None, height_file=None, floor_file=None):
    """scene.xml, liver.ply, the height map and sky.exr in dirpath ->
    (path of scene.xml, {file name: bytes}).  The height map is
    height_map(bump_res) as an 8-bit grey height.png, or a copy of
    `height_file` under its extension (tests/data/torch_height.jpg: the
    1,024^2 map as a JPEG).  sky.exr is sky_map(*sky) as a ZIP half EXR, or
    a copy of `sky_file` (tests/data/torch_sky_piz.exr and
    torch_sky_dwaa.exr: the same sky written by OpenEXR with PIZ and DWAA
    compression).  `floor_file` is copied in as floor.<ext> and textures a
    floor under the liver (tests/data/torch_floor.gif)."""
    os.makedirs(dirpath, exist_ok=True)
    v, f, n, uv = liver_mesh(subdiv, seed)
    write_ply(os.path.join(dirpath, "liver.ply"), v, f, n, uv)
    if height_file is None:
        hname = "height.png"
        h = height_map(bump_res, seed)
        write_png(os.path.join(dirpath, hname),
                  np.round(h * 255.0).astype(np.uint8))
    else:
        hname = "height" + os.path.splitext(str(height_file))[1]
        shutil.copyfile(height_file, os.path.join(dirpath, hname))
    if sky_file is None:
        write_exr(os.path.join(dirpath, "sky.exr"), sky_map(*sky))
    else:
        shutil.copyfile(sky_file, os.path.join(dirpath, "sky.exr"))
    names = ["scene.xml", "liver.ply", hname, "sky.exr"]
    fname = None
    if floor_file is not None:
        fname = "floor" + os.path.splitext(str(floor_file))[1]
        shutil.copyfile(floor_file, os.path.join(dirpath, fname))
        names.append(fname)
    xml = os.path.join(dirpath, "scene.xml")
    with open(xml, "w") as fh:
        fh.write(proxy_xml(width, height, spp, max_depth,
                           height_file=hname, floor_file=fname))
    return xml, {name: os.path.getsize(os.path.join(dirpath, name))
                 for name in names}


def inline_files(d, base_dir, read_image, load_mesh):
    """The parsed scene dict `d` with its files replaced by the arrays read
    back (read_image, load_mesh: the loader's own readers): the dict that
    load_dict builds into the same buffers as load_file."""
    def walk(x):
        if not isinstance(x, dict):
            return x
        out = {k: walk(v) for k, v in x.items()}
        t = out.get("type")
        if "filename" in out:
            path = os.path.join(base_dir, out.pop("filename"))
            if t == "bitmap":
                out["data"] = read_image(path, not out.get("raw", False))
            elif t == "envmap":
                out["data"] = read_image(path, False)
            else:
                m = load_mesh(path)
                out.update(type="mesh", vertices=m.vertices, faces=m.faces,
                           normals=m.normals, uvs=m.uvs)
        return out
    return walk(d)


def sphere_liver_xml(res=12, spp=4):
    """SphereLiverConstEnv (tests/test_volpath.py's liver sphere): a
    dielectric sphere around the liver medium, whose absorption spectra
    are lambda:value tables, under a constant environment; the camera's
    transform is a translate, rotate and scale chain and a matrix."""
    return f"""<scene version="2.1.0">
  <integrator type="biovolpath">
    <integer name="max_depth" value="12"/>
  </integrator>
  <sensor type="perspective">
    <float name="fov" value="40"/>
    <transform name="to_world">
      <lookat origin="0,0,4" target="0,0,0" up="0,1,0"/>
      <rotate y="1" angle="4"/>
      <matrix value="1 0 0 0.05, 0 1 0 0, 0 0 1 0, 0 0 0 1"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="{res}"/>
      <integer name="height" value="{res}"/>
      <rfilter type="box"/>
    </film>
    <sampler type="independent">
      <integer name="sample_count" value="{spp}"/>
    </sampler>
  </sensor>
{_liver_medium_xml()}
  <shape type="sphere">
    <float name="radius" value="1.0"/>
    <transform name="to_world">
      <scale value="1.1"/>
      <translate x="0.05"/>
    </transform>
    <bsdf type="Dielectric">
      <float name="int_ior" value="1.38"/>
      <float name="ext_ior" value="1.0"/>
    </bsdf>
    <ref name="interior" id="liver_med"/>
  </shape>
  <emitter type="constant">
    <rgb name="radiance" value="1.0"/>
  </emitter>
</scene>
"""
