"""Scene builder: Mitsuba-style dict -> the port's Scene (counterpart of
liverrenderer_tpu/scene/builder.py), cut to the plugins of the slices
ported so far:

  integrators  biovolpath, biovolpath06, volpath, volpathmis, prbvolpath,
               path, direct, prb, prb_basic, stokes, volprim_rf_basic;
               ptracer, aov, depth and moment, which render refuses as
               the JAX package's does (integrators/ptracer.py and aux.py
               render them)
  sensor       perspective (to_world, fov, fov_axis), thinlens,
               orthographic, distant (direction, target), radiancemeter,
               irradiancemeter (nested in its shape) and batch (its child
               cameras); hdrfilm with a box, tent, gaussian (the
               default), mitchell, catmullrom or lanczos filter; the
               independent, stratified, multijitter, orthogonal and
               ldsampler samplers
  shapes       mesh and blender (with per-vertex `vertex_attrs`), obj, ply,
               serialized, rectangle, cube, disk, cylinder, sphere
               (analytic), ellipsoids and ellipsoidsmesh (instanced
               icospheres; with opacities and SH coefficients the radiance
               field's splats), linearcurve and bsplinecurve (tubes,
               scene/curves.py), sdfgrid, merge's children, and shapegroup
               with its instances (one group-local stream shared by the
               instances, or replicated with flatten_instances=True or
               when a child is not a plain mesh)
  bsdfs        diffuse (also the default of a shape without a BSDF),
               dielectric, thindielectric, roughdielectric, conductor,
               roughconductor, plastic, roughplastic, pplastic, null, the
               polarizer, retarder and circular elements, hair, the
               one-level blendbsdf and mask, and the twosided, bumpmap and
               normalmap wrappers (folded into the BSDF and shape tables,
               also through a ref)
  textures     constant, checkerboard, bitmap (inline `data` or a file),
               mesh_attribute, volume / gridvolume (a 3-D grid, inline or
               a .vol file)
  spectra      rgb, uniform, d65, rawconstant, srgb, blackbody, regular
               and irregular, as linear RGB
  media        liver, glissonCapsule / glisson, parenchyma, homogeneous,
               heterogeneous (a gridvolume sigma_t, inline `data` or a
               Mitsuba .vol file); the isotropic, hg, rayleigh,
               blendphase, tabphase and sggx phases
  emitters     area (attached to a shape), point, constant, envmap (inline
               `data` or a file), directional / directionalarea, spot,
               projector, and sunsky / sun / sky / timed_sunsky (the
               Preetham sky baked into an envmap, emitter/sunsky.py)
  subsurface   vaescatter (the learned BSSRDF: per-vertex polynomial fits,
               the VAE from ssub/vae.load_model) and dipole (its irradiance
               point cloud), nested in a shape or named and referenced

Entities are packed host-side into the same numpy tables, in the same
order, as the JAX builder packs them; `bridge.scene_from_numpy` uploads
them.  File names resolve against `base_dir` (the XML file's directory
under scene/xml.load_file).  Any other plugin raises ValueError.
"""
from __future__ import annotations

import os
import warnings
from typing import Any, Dict, List

import numpy as np

from ..accel.bvh import build_bvh
from ..accel.cuda_intersect import pack_tris
from ..bsdf.measured import MeasuredData
from ..bsdf.measured import empty_table_arrays as empty_measured_arrays
from ..bsdf.measured import table_arrays as measured_table_arrays
from ..core.distr import build_distribution_2d_np
from ..core.rng import KINDS as _SAMPLERS
from ..core.spectrum import blackbody_rgb, spd_to_rgb, srgb_to_linear
from ..errors import not_ported
from . import geometry as geo
from .ir import (INST_CHUNK, BSDF_BLEND, BSDF_CIRCULAR, BSDF_CONDUCTOR,
                 BSDF_DIELECTRIC, BSDF_DIFFUSE, BSDF_HAIR, BSDF_MASK,
                 BSDF_MEASURED,
                 BSDF_NULL, BSDF_P, BSDF_PLASTIC, BSDF_POLARIZER,
                 BSDF_PPLASTIC, BSDF_PRINCIPLED, BSDF_PRINCIPLEDTHIN,
                 BSDF_RETARDER,
                 BSDF_ROUGHCONDUCTOR, BSDF_ROUGHDIELECTRIC,
                 BSDF_ROUGHPLASTIC, BSDF_THINDIELECTRIC, EMITTER_AREA,
                 EMITTER_CONSTANT, EMITTER_DIRECTIONAL, EMITTER_ENVMAP,
                 EMITTER_P, EMITTER_POINT, EMITTER_PROJECTOR, EMITTER_SPOT,
                 F_DELTA_REFL, F_DELTA_TRANS, F_DIFFUSE_REFL, F_GLOSSY_REFL,
                 F_GLOSSY_TRANS, F_NULL, F_SMOOTH, FILTER_BOX,
                 FILTER_CATMULLROM, FILTER_GAUSSIAN, FILTER_LANCZOS,
                 FILTER_MITCHELL, FILTER_TENT, MEDIUM_GLISSON,
                 MEDIUM_HETEROGENEOUS, MEDIUM_HOMOGENEOUS, MEDIUM_LIVER,
                 MEDIUM_P, MEDIUM_PARENCHYMA, PHASE_BLEND, PHASE_HG,
                 PHASE_ISOTROPIC, PHASE_RAYLEIGH, PHASE_SGGX, PHASE_TAB,
                 SENSOR_BATCH, SENSOR_DISTANT, SENSOR_IRRADIANCEMETER,
                 SENSOR_ORTHOGRAPHIC, SENSOR_PERSPECTIVE,
                 SENSOR_RADIANCEMETER, SENSOR_THINLENS, SHAPE_MESH,
                 SHAPE_SDF, SHAPE_SPHERE, SSUB_DIPOLE, SSUB_VAE, TAB_BINS,
                 TEX_BITMAP, TEX_CHECKERBOARD, TEX_CONST, TEX_MESHATTR, TEX_P,
                 TEX_VOLUME)
from .transform import Transform, from_any

IOR_NAMES = {
    "vacuum": 1.0, "air": 1.000277, "water": 1.3330, "water ice": 1.31,
    "glass": 1.5046, "bk7": 1.5046, "fused quartz": 1.458, "pyrex": 1.470,
    "acrylic glass": 1.49, "polypropylene": 1.49, "diamond": 2.419,
    "ethanol": 1.361, "benzene": 1.501, "silicone oil": 1.52045,
    "bromine": 1.661, "amber": 1.55,
}

# named conductors' complex IOR, RGB (the JAX builder's table)
CONDUCTOR_IOR = {
    "au": ([0.1431, 0.3749, 1.4424], [3.9831, 2.3857, 1.6032]),
    "ag": ([0.1552, 0.1376, 0.1354], [4.8283, 3.1222, 2.1463]),
    "al": ([1.6574, 0.8803, 0.5212], [9.2238, 6.2665, 4.8370]),
    "cu": ([0.2004, 0.9240, 1.1022], [3.9129, 2.4528, 2.1421]),
    "none": ([0.0, 0.0, 0.0], [1.0, 1.0, 1.0]),
}

_INTEGRATORS = ("biovolpath", "biovolpath06", "volpath", "volpathmis",
                "prbvolpath", "path", "direct", "prb", "prb_basic", "aov",
                "depth", "moment", "ptracer", "stokes", "volprim_rf_basic")
# integrators the spectral variant admits (the JAX builder's list)
_SPECTRAL_INTEGRATORS = ("path", "direct", "volpath", "volpathmis",
                         "biovolpath", "biovolpath06", "prbvolpath",
                         "stokes")
_SENSOR_TYPES = {"perspective": SENSOR_PERSPECTIVE,
                 "thinlens": SENSOR_THINLENS,
                 "orthographic": SENSOR_ORTHOGRAPHIC,
                 "distant": SENSOR_DISTANT,
                 "radiancemeter": SENSOR_RADIANCEMETER,
                 "irradiancemeter": SENSOR_IRRADIANCEMETER,
                 "batch": SENSOR_BATCH}
_SHAPE_TYPES = ("mesh", "blender", "obj", "ply", "serialized", "rectangle",
                "cube", "disk", "cylinder", "sphere", "ellipsoids",
                "ellipsoidsmesh", "linearcurve", "bsplinecurve", "sdfgrid")
_CURVE_TYPES = ("linearcurve", "bsplinecurve")
# the shapes a shapegroup's instances share as one group-local stream:
# those that tessellate to a plain mesh.  Spheres, SDF grids, curves and
# splats keep global tables, so their groups are replicated instead
_INSTANCEABLE_TYPES = ("rectangle", "cube", "disk", "cylinder", "obj",
                       "ply", "serialized", "mesh", "blender")
_BSDF_TYPES = ("diffuse", "dielectric", "thindielectric", "roughdielectric",
               "conductor", "roughconductor", "plastic", "roughplastic",
               "pplastic", "null", "mask", "blendbsdf", "twosided",
               "bumpmap", "normalmap", "polarizer", "retarder", "circular",
               "principled", "principledthin", "measured", "hair")
_ELEMENTS = {"polarizer": BSDF_POLARIZER, "retarder": BSDF_RETARDER,
             "circular": BSDF_CIRCULAR}
# a filter name the table lacks takes the gaussian, as in the JAX builder
_FILTERS = {"box": FILTER_BOX, "tent": FILTER_TENT,
            "gaussian": FILTER_GAUSSIAN, "mitchell": FILTER_MITCHELL,
            "catmullrom": FILTER_CATMULLROM, "lanczos": FILTER_LANCZOS}
_MEDIUM_TYPES = ("liver", "glissonCapsule", "glisson", "parenchyma",
                 "homogeneous", "heterogeneous")
_EMITTER_TYPES = ("point", "constant", "envmap", "directional",
                  "directionalarea", "spot", "projector", "sunsky", "sun",
                  "sky", "timed_sunsky")
# textures a scene may declare at its top level (the JAX builder's list)
_TEXTURE_TYPES = ("bitmap", "checkerboard", "mesh_attribute")
_SUBSURFACE_TYPES = ("vaescatter", "dipole")
_CONST_TEXTURE_TYPES = ("rgb", "uniform", "d65", "srgb", "rawconstant")
# plugin names of the JAX builder that the port does not carry yet, with
# the ROADMAP item that brings each (none since the M10 item)
_OTHER_TYPES: Dict[str, str] = {}


# build_numpy's extra array: the normals of the dipole's points, which
# load_dict reads to estimate their irradiance on the built scene
DIPOLE_NORMALS = "ssub.dip_normals"


def _unsupported(t):
    if t not in _OTHER_TYPES:
        return ValueError(f"unknown plugin type {t!r}")
    return not_ported(f"the {t!r} plugin", _OTHER_TYPES[t])


def _scalar(d, key, default) -> float:
    """A scalar parameter; a textured one (a dict) takes its default, as
    in the JAX builder."""
    v = d.get(key, default)
    return default if isinstance(v, dict) else float(v)


def _spectrum_to_rgb(val, default=1.0) -> np.ndarray:
    """A dict 'spectrum-ish' value as linear RGB: rgb, a scalar or list,
    uniform / d65 / rawconstant, blackbody (relative radiance), regular
    and irregular SPDs (integrated against the CIE curves) and srgb."""
    if val is None:
        return np.full(3, default, np.float32)
    if isinstance(val, (int, float)):
        return np.full(3, float(val), np.float32)
    if isinstance(val, (list, tuple, np.ndarray)):
        a = np.asarray(val, np.float32).reshape(-1)
        return a if a.size == 3 else np.full(3, a[0], np.float32)
    if isinstance(val, dict):
        t = val.get("type")
        if t == "rgb":
            return np.asarray(val["value"], np.float32).reshape(3)
        if t in ("uniform", "d65", "rawconstant"):
            return np.full(3, float(val.get("value", default)), np.float32)
        if t == "blackbody":
            rgb = blackbody_rgb(val.get("temperature", 6504.0),
                                float(val.get("scale", 1.0)))
            return rgb / max(rgb.max(), 1e-9)
        if t == "regular":
            vals = np.asarray(val["values"] if "values" in val
                              else val["value"], np.float32).reshape(-1)
            lam = np.linspace(float(val.get("lambda_min", 360.0)),
                              float(val.get("lambda_max", 830.0)), len(vals))
            return spd_to_rgb(lam, vals)
        if t == "irregular":
            if "wavelengths" in val:
                lam = np.asarray(val["wavelengths"], np.float32)
                vals = np.asarray(val["values"], np.float32)
            else:                       # the "lam1:v1, lam2:v2" string
                pairs = [p.split(":") for p in
                         str(val["value"]).replace(" ", "").split(",") if p]
                lam = np.asarray([float(a) for a, _ in pairs])
                vals = np.asarray([float(b) for _, b in pairs])
            return spd_to_rgb(lam, vals)
        if t == "srgb":
            v = np.asarray(val["value"], np.float32).reshape(-1)
            v = v if v.size == 3 else np.full(3, v[0], np.float32)
            return np.asarray(srgb_to_linear(v), np.float32)
    raise ValueError(f"cannot interpret spectrum {val!r}")


def _ior(val, default) -> float:
    if val is None:
        return default
    if isinstance(val, str):
        return IOR_NAMES[val.lower()]
    return float(val)


def _fdr(eta: float) -> float:
    """Average diffuse Fresnel reflectance (the JAX builder's polynomial
    fits, in float64)."""
    if eta < 1.0:
        return float(-1.4399 * eta * eta + 0.7099 * eta + 0.6681
                     + 0.0636 / eta)
    ie = 1.0 / eta
    ie2 = ie * ie
    ie3 = ie2 * ie
    ie4 = ie3 * ie
    ie5 = ie4 * ie
    return float(0.919317 - 3.4793 * ie + 6.75335 * ie2 - 7.80989 * ie3
                 + 4.98554 * ie4 - 1.36881 * ie5)


def _alpha(d, key, default):
    """A roughness parameter; a textured one takes the default."""
    v = d.get(key, default)
    return default if isinstance(v, dict) else float(v)


def _pack_glisson(p: np.ndarray, d: dict):
    """Glisson-capsule layer coefficients (glissonCapsule.cpp), natural RGB
    order: limits [36:40], collagen [12:24], elastin [24:36]."""
    def fl(key, default):
        return float(_spectrum_to_rgb(d.get(key, default), default)[0])

    p[36] = fl("layer1Limit", 0.0065)
    p[37] = fl("layer2Limit", 0.0072)
    p[38] = fl("layer3Limit", 0.0083)
    p[39] = fl("layer4Limit", 0.01)
    for layer in range(1, 5):
        for ci, ch in enumerate("RGB"):
            p[12 + (layer - 1) * 3 + ci] = fl(
                f"sigma_collagen{layer}_{ch}", 1.0)
            p[24 + (layer - 1) * 3 + ci] = fl(
                f"sigma_elastin{layer}_{ch}", 1.0)


def _pack_parenchyma(p: np.ndarray, d: dict, base: int):
    """Parenchyma absorber coefficients.  PARENCHYMA (base=12): blood
    12:15, bile 15:18, lipid_water 18:21, hepatocity 21.  LIVER (base=40):
    blood 40:43, bile 43:46, hepatocity 46, lipid_water 48:51 (slots 3:6
    stay the medium albedo)."""
    blood = _spectrum_to_rgb(d.get("sigma_blood", 1.0), 1.0)
    bile = _spectrum_to_rgb(d.get("sigma_bile", 1.0), 1.0)
    lipid = _spectrum_to_rgb(d.get("sigma_lipid_water", 1.0), 1.0)
    hep = float(_spectrum_to_rgb(d.get("sigma_hepatocity", 1.0), 1.0)[0])
    if base == 12:
        p[12:15] = blood
        p[15:18] = bile
        p[18:21] = lipid
        p[21] = hep
    else:
        p[40:43] = blood
        p[43:46] = bile
        p[46] = hep
        p[48:51] = lipid


def _uv_transform(data: np.ndarray, d: dict):
    """A texture's `to_uv`: uv scale into data[6:8], offset into [8:10]."""
    if "to_uv" in d:
        m = from_any(d["to_uv"]).matrix
        data[6], data[7] = m[0, 0], m[1, 1]
        data[8], data[9] = m[0, 3], m[1, 3]


def _env_importance(img: np.ndarray) -> dict:
    """The envmap's importance map: luminance times sin(theta) per texel
    (+1e-8, so no cell has zero density)."""
    lum = img[..., :3].mean(-1)
    h = lum.shape[0]
    sin_t = np.sin((np.arange(h) + 0.5) / h * np.pi)
    return build_distribution_2d_np(np.maximum(lum * sin_t[:, None], 0)
                                    + 1e-8)


def _pack_bitmaps(bitmaps):
    """(stack, hw, quads, has_quads): the bitmaps padded to a common
    (H, W), grey as rgb, their true (h, w), and the quads, [c00 c10 c01
    c11] per texel with the repeat wrap baked in (four times the stack's
    memory, so only up to 64 Mi floats; a 1x1x1 placeholder past it)."""
    if bitmaps:
        mh = max(b.shape[0] for b in bitmaps)
        mw = max(b.shape[1] for b in bitmaps)
        stack = np.zeros((len(bitmaps), mh, mw, 3), np.float32)
        hw = np.zeros((len(bitmaps), 2), np.int32)
        for i, b in enumerate(bitmaps):
            if b.ndim == 2:
                b = b[..., None]
            if b.shape[-1] == 1:
                b = np.repeat(b, 3, -1)
            stack[i, :b.shape[0], :b.shape[1]] = b[..., :3]
            hw[i] = (b.shape[0], b.shape[1])
    else:
        stack = np.zeros((1, 1, 1, 3), np.float32)
        hw = np.ones((1, 2), np.int32)
    has_quads = stack.size <= 64 << 20
    quads = np.zeros(stack.shape[:3] + (12,) if has_quads else (1, 1, 1, 12),
                     np.float32)
    if has_quads:
        for i in range(stack.shape[0]):
            h_i, w_i = int(hw[i, 0]), int(hw[i, 1])
            img = stack[i, :h_i, :w_i]
            xp = (np.arange(w_i) + 1) % w_i
            yp = (np.arange(h_i) + 1) % h_i
            quads[i, :h_i, :w_i, 0:3] = img
            quads[i, :h_i, :w_i, 3:6] = img[:, xp]
            quads[i, :h_i, :w_i, 6:9] = img[yp]
            quads[i, :h_i, :w_i, 9:12] = img[yp][:, xp]
    return stack, hw, quads, has_quads


def _pack_phase(p: np.ndarray, phase: dict):
    """A medium's nested phase into its parameter row (the JAX builder's
    slots: g [7], type [8], blendphase [11:16], tabphase and sggx
    [16:...])."""
    pt = phase["type"]
    if pt == "hg":
        p[8] = PHASE_HG
        p[7] = float(phase.get("g", 0.8))
    elif pt == "rayleigh":
        p[8] = PHASE_RAYLEIGH
    elif pt == "isotropic":
        p[8] = PHASE_ISOTROPIC
    elif pt == "blendphase":
        # a weighted pair of nested iso/hg phases (blendphase.cpp)
        p[8] = PHASE_BLEND
        p[11] = float(phase.get("weight", 0.5))
        kids = [v for v in phase.values() if isinstance(v, dict)
                and v.get("type") in ("isotropic", "hg")]
        if len(kids) != 2:
            raise ValueError("blendphase needs two isotropic/hg children")
        codes = {"isotropic": PHASE_ISOTROPIC, "hg": PHASE_HG}
        p[12] = codes[kids[0]["type"]]
        p[13] = float(kids[0].get("g", 0.0))
        p[14] = codes[kids[1]["type"]]
        p[15] = float(kids[1].get("g", 0.0))
    elif pt == "tabphase":
        # the tabulated density over cos_theta, resampled to TAB_BINS
        # constant bins (tabphase.cpp interpolates linearly)
        p[8] = PHASE_TAB
        vals = phase["values"]
        if isinstance(vals, str):
            vals = [float(x) for x in vals.split(",")]
        vals = np.asarray(vals, np.float64)
        xs = np.linspace(0.0, 1.0, len(vals))
        xq = (np.arange(TAB_BINS) + 0.5) / TAB_BINS
        p[16:16 + TAB_BINS] = np.maximum(np.interp(xq, xs, vals), 0.0)
    elif pt == "sggx":
        # specular microflakes with a constant S matrix (sggx.cpp)
        p[8] = PHASE_SGGX
        if "S" in phase:
            p[16:22] = np.asarray(phase["S"], np.float32)
        else:
            for i, k in enumerate(("S_xx", "S_yy", "S_zz", "S_xy", "S_xz",
                                   "S_yz")):
                p[16 + i] = float(phase.get(k, 1.0 if i < 3 else 0.0))
    else:
        raise ValueError(f"unknown phase {pt!r}")


def _pack_volume_textures(grids, to_local):
    """(G, D, H, W, 3) stack of the volume textures' grids, zero-padded to
    the largest, (G, 3) true (D, H, W) and (G, 4, 4) world -> local; a 2^3
    placeholder without any."""
    if not grids:
        return (np.zeros((1, 2, 2, 2, 3), np.float32),
                np.full((1, 3), 2, np.int32), np.eye(4, dtype=np.float32)[None])
    stack = np.zeros((len(grids), max(g.shape[0] for g in grids),
                      max(g.shape[1] for g in grids),
                      max(g.shape[2] for g in grids), 3), np.float32)
    whd = np.zeros((len(grids), 3), np.int32)
    for i, g in enumerate(grids):
        stack[i, :g.shape[0], :g.shape[1], :g.shape[2]] = g
        whd[i] = g.shape[:3]
    return stack, whd, np.stack(to_local)


def _pack_grids(grids, to_local):
    """(G, D, H, W, 4) stack padded to the largest grid, (G, 3) true
    sizes and (G, 4, 4) transforms; a 1-voxel zero grid without any."""
    if not grids:
        return (np.zeros((1, 1, 1, 1, 4), np.float32),
                np.ones((1, 3), np.int32), np.eye(4, dtype=np.float32)[None])
    gd = max(g.shape[0] for g in grids)
    gh = max(g.shape[1] for g in grids)
    gw = max(g.shape[2] for g in grids)
    stack = np.zeros((len(grids), gd, gh, gw, 4), np.float32)
    whd = np.zeros((len(grids), 3), np.int32)
    for i, g in enumerate(grids):
        stack[i, :g.shape[0], :g.shape[1], :g.shape[2]] = g
        whd[i] = g.shape[:3]
    return stack, whd, np.stack(to_local).astype(np.float32)


class _Builder:
    def __init__(self, base_dir: str = "."):
        self.base_dir = base_dir
        self.measured: List[MeasuredData] = []
        self.tex_type: List[int] = []
        self.tex_data: List[np.ndarray] = []
        self.tex_bitmap: List[int] = []
        self.bitmaps: List[np.ndarray] = []
        self.b_type: List[int] = []
        self.b_params: List[np.ndarray] = []
        self.b_tex0: List[int] = []
        self.b_tex1: List[int] = []
        self.b_inner: List[int] = []
        self.b_inner2: List[int] = []
        self.b_flags: List[int] = []
        self.b_twosided: List[bool] = []
        self.e_type: List[int] = []
        self.e_params: List[np.ndarray] = []
        self.e_shape: List[int] = []
        self.e_tex0: List[int] = []
        self.e_to_world: List[np.ndarray] = []
        self.env_index = -1
        self.env_bitmap = -1
        self.m_type: List[int] = []
        self.m_params: List[np.ndarray] = []
        self.m_grid: List[int] = []
        self.grids: List[np.ndarray] = []
        self.grid_to_local: List[np.ndarray] = []
        self.vertices: List[np.ndarray] = []
        self.faces: List[np.ndarray] = []
        self.normals: List[np.ndarray] = []
        self.uvs: List[np.ndarray] = []
        self.tri_shape: List[np.ndarray] = []
        # per-vertex fiber tangents (curves) and rgb attributes
        # (mesh_attribute), one block per mesh shape (zeros elsewhere)
        self.tangents: List[np.ndarray] = []
        self.vattrs: List[np.ndarray] = []
        self.has_curves = False
        self.has_vattr = False
        self.v_count = 0
        # the volume textures' grids and world -> local transforms
        self.vol_grids: List[np.ndarray] = []
        self.vol_to_local: List[np.ndarray] = []
        # SDF grid shapes
        self.sdf_grids: List[np.ndarray] = []
        self.sdf_to_local: List[np.ndarray] = []
        self.sdf_shape: List[int] = []
        # instanced shapegroups: gid -> {start, n_chunks, bmin, bmax};
        # g_tris / g_si the padded group-local streams; one (3x4, inverse
        # transpose 3x3, start, n_chunks, world bmin, bmax) per instance
        self.groups: Dict[str, dict] = {}
        self.g_tris: List[np.ndarray] = []
        self.g_si: List[np.ndarray] = []
        self.inst_rows: List[tuple] = []
        self.sph_center: List[np.ndarray] = []
        self.sph_radius: List[float] = []
        self.sph_shape: List[int] = []
        self.s_bsdf: List[int] = []
        self.s_emitter: List[int] = []
        self.s_int_med: List[int] = []
        self.s_ext_med: List[int] = []
        self.s_bump_tex: List[int] = []
        self.s_bump_scale: List[float] = []
        self.s_type: List[int] = []
        self.s_prim_off: List[int] = []
        self.s_prim_cnt: List[int] = []
        self.s_area: List[float] = []
        self.s_ssub: List[int] = []
        self.ssub_params: List[np.ndarray] = []
        self.ssub_types: List[int] = []
        self.ssub_scale = 1.0
        self.named: Dict[str, tuple] = {}
        self.sensor_to_world = np.eye(4, dtype=np.float32)
        self.sensor_type = SENSOR_PERSPECTIVE
        self.sensor_target = None
        self.sensor_shape = -1
        self.batch_to_world = np.eye(4, dtype=np.float32)[None]
        self.batch_fov_x = np.full(1, 45.0, np.float32)
        self.aperture_radius, self.focus_distance = 0.0, 1.0
        self.near, self.far = 1e-2, 1e4
        self.fov_x = 45.0
        self.film_w = 256
        self.film_h = 256
        self.rfilter = FILTER_GAUSSIAN
        self.spp = 16
        self.sampler_kind = "independent"
        self.integrator = "path"
        self.max_depth = 8
        self.rr_depth = 5
        self.hide_emitters = False
        self.camera_medium = -1
        self.srgb_primitives = True
        self.vp_center: List[np.ndarray] = []
        self.vp_scale: List[np.ndarray] = []
        self.vp_rot: List[np.ndarray] = []
        self.vp_opacity: List[np.ndarray] = []
        self.vp_sh: List[np.ndarray] = []
        self.vp_tri: List[tuple] = []

    # --- textures ---------------------------------------------------------
    def _push_texture(self, ttype, data, bitmap=-1) -> int:
        self.tex_type.append(ttype)
        self.tex_data.append(data)
        self.tex_bitmap.append(bitmap)
        return len(self.tex_type) - 1

    def add_bitmap(self, img) -> int:
        self.bitmaps.append(np.asarray(img, np.float32))
        return len(self.bitmaps) - 1

    def _path(self, filename: str) -> str:
        return filename if os.path.isabs(filename) \
            else os.path.join(self.base_dir, filename)

    def load_bitmap_file(self, filename: str, raw=False) -> int:
        from ..io.image import read_image
        return self.add_bitmap(read_image(self._path(filename),
                                          srgb_to_linear=not raw))

    def build_texture(self, d, default=1.0) -> int:
        """Texture slot of a dict / rgb / scalar -> texture index (-1 for
        none)."""
        if d is None:
            return -1
        if isinstance(d, dict) and d.get("type") == "ref":
            kind, idx = self.named[d["id"]][:2]
            if kind != "texture":
                raise ValueError(f"{d['id']!r} is a {kind}, not a texture")
            return idx
        if not isinstance(d, dict) or d.get("type") in _CONST_TEXTURE_TYPES:
            data = np.zeros(TEX_P, np.float32)
            data[0:3] = _spectrum_to_rgb(d, default)
            return self._push_texture(TEX_CONST, data)
        t = d["type"]
        data = np.zeros(TEX_P, np.float32)
        data[6:8] = 1.0  # uv scale
        if t == "checkerboard":
            data[0:3] = _spectrum_to_rgb(d.get("color0", 0.4))
            data[3:6] = _spectrum_to_rgb(d.get("color1", 0.2))
            _uv_transform(data, d)
            return self._push_texture(TEX_CHECKERBOARD, data)
        if t == "bitmap":
            bid = self.add_bitmap(d["data"]) if "data" in d else \
                self.load_bitmap_file(d["filename"],
                                      raw=bool(d.get("raw", False)))
            _uv_transform(data, d)
            return self._push_texture(TEX_BITMAP, data, bid)
        if t == "mesh_attribute":
            # mesh_attribute.cpp: the interpolated vertex attribute (si.attr)
            # times `scale`
            data[0:3] = float(d.get("scale", 1.0))
            return self._push_texture(TEX_MESHATTR, data)
        if t in ("volume", "gridvolume"):
            # a 3-D grid texture (textures/volume, volumes/grid.cpp),
            # trilinear at the world position
            if "filename" in d:
                from ..io.vol import read_vol
                grid = read_vol(self._path(d["filename"]))
            else:
                grid = np.asarray(d.get("data", d.get("grid")), np.float32)
                if grid.ndim == 3:
                    grid = grid[..., None]
            if grid.shape[-1] == 1:
                grid = np.repeat(grid, 3, -1)
            self.vol_grids.append(grid[..., :3].astype(np.float32))
            tw = from_any(d["to_world"]).matrix if "to_world" in d \
                else np.eye(4)
            self.vol_to_local.append(np.linalg.inv(tw).astype(np.float32))
            data[0:3] = _spectrum_to_rgb(d.get("scale", 1.0), 1.0)
            return self._push_texture(TEX_VOLUME, data,
                                      len(self.vol_grids) - 1)
        raise _unsupported(t)

    # --- bsdfs ------------------------------------------------------------
    def _push_bsdf(self, btype, params, tex0=-1, tex1=-1, inner=-1,
                   inner2=-1, flags=0, twosided=False) -> int:
        self.b_type.append(btype)
        self.b_params.append(params)
        self.b_tex0.append(tex0)
        self.b_tex1.append(tex1)
        self.b_inner.append(inner)
        self.b_inner2.append(inner2)
        self.b_flags.append(flags)
        self.b_twosided.append(twosided)
        return len(self.b_type) - 1

    def build_bsdf(self, d, twosided=False) -> tuple:
        """(bsdf index, bump texture, bump scale): the twosided wrapper
        sets its BSDF's flag, the bumpmap and normalmap wrappers fold into
        the shape's slots (a normal map as a negative scale), and both
        survive a ref."""
        if d is None:
            # default: plain diffuse 0.5 (the reference's shape default)
            return self._push_bsdf(
                BSDF_DIFFUSE, np.zeros(BSDF_P, np.float32),
                tex0=self.build_texture([.5, .5, .5]),
                flags=F_DIFFUSE_REFL, twosided=twosided), -1, 0.0
        if d.get("type") == "ref":
            ent = self.named[d["id"]]
            if ent[0] != "bsdf":
                raise ValueError(f"{d['id']!r} is a {ent[0]}, not a bsdf")
            return ent[1], ent[2], ent[3]
        t = d["type"]
        if t == "twosided":
            inner = [v for k, v in d.items() if isinstance(v, dict)
                     and v.get("type") is not None]
            return self.build_bsdf(inner[0], twosided=True)
        if t in ("bumpmap", "normalmap"):
            bump_tex = self.build_texture(d.get("texture")
                                          or d.get("normalmap"))
            scale = float(d.get("scale", 1.0))
            inner = [v for k, v in d.items()
                     if isinstance(v, dict)
                     and k not in ("texture", "normalmap")
                     and "type" in v and v["type"] != "bitmap"]
            idx, _, _ = self.build_bsdf(inner[0] if inner else None,
                                        twosided)
            if t == "normalmap":
                scale = -abs(scale)
            return idx, bump_tex, scale
        return self._build_plain_bsdf(d, t, twosided), -1, 0.0

    def _build_plain_bsdf(self, d, t, twosided) -> int:
        p = np.zeros(BSDF_P, np.float32)
        if t == "diffuse":
            tex0 = self.build_texture(d.get("reflectance", 0.5), 0.5)
            return self._push_bsdf(BSDF_DIFFUSE, p, tex0=tex0,
                                   flags=F_DIFFUSE_REFL, twosided=twosided)
        if t in ("dielectric", "thindielectric", "roughdielectric"):
            p[0] = _ior(d.get("int_ior"), 1.5046) \
                / _ior(d.get("ext_ior"), 1.000277)
            tex0 = self.build_texture(d.get("specular_reflectance", 1.0), 1.0)
            tex1 = self.build_texture(d.get("specular_transmittance", 1.0),
                                      1.0)
            if t == "dielectric":
                code, flags = BSDF_DIELECTRIC, F_DELTA_REFL | F_DELTA_TRANS
            elif t == "thindielectric":
                code, flags = BSDF_THINDIELECTRIC, F_DELTA_REFL | F_NULL
            else:
                alpha = float(d.get("alpha", 0.1))
                p[6] = float(d.get("alpha_u", alpha))
                p[7] = float(d.get("alpha_v", alpha))
                code, flags = BSDF_ROUGHDIELECTRIC, \
                    F_GLOSSY_REFL | F_GLOSSY_TRANS
            return self._push_bsdf(code, p, tex0=tex0, tex1=tex1,
                                   flags=flags, twosided=twosided)
        if t in ("conductor", "roughconductor"):
            if "eta" in d:
                p[0:3] = _spectrum_to_rgb(d["eta"])
                p[3:6] = _spectrum_to_rgb(d.get("k", 1.0))
            else:
                mat = str(d.get("material", "none")).lower()
                p[0:3], p[3:6] = CONDUCTOR_IOR.get(mat, CONDUCTOR_IOR["none"])
            tex0 = self.build_texture(d.get("specular_reflectance", 1.0), 1.0)
            if t == "conductor":
                return self._push_bsdf(BSDF_CONDUCTOR, p, tex0=tex0,
                                       flags=F_DELTA_REFL, twosided=twosided)
            alpha = float(d.get("alpha", 0.1))
            p[6] = float(d.get("alpha_u", alpha))
            p[7] = float(d.get("alpha_v", alpha))
            return self._push_bsdf(BSDF_ROUGHCONDUCTOR, p, tex0=tex0,
                                   flags=F_GLOSSY_REFL, twosided=twosided)
        if t in ("plastic", "roughplastic", "pplastic"):
            eta = _ior(d.get("int_ior"), 1.49) \
                / _ior(d.get("ext_ior"), 1.000277)
            p[0] = eta
            p[1] = 1.0 if d.get("nonlinear", False) else 0.0
            p[2] = _fdr(eta)
            p[3] = _fdr(1.0 / eta)
            tex0 = self.build_texture(d.get("diffuse_reflectance", 0.5), 0.5)
            # specular sampling weight: the mean specular over the total
            # (roughplastic.cpp, with the specular mean 1)
            p[4] = 1.0 / (1.0 + np.mean(
                _spectrum_to_rgb(d.get("diffuse_reflectance", 0.5), 0.5)))
            if t == "plastic":
                return self._push_bsdf(BSDF_PLASTIC, p, tex0=tex0,
                                       flags=F_DELTA_REFL | F_DIFFUSE_REFL,
                                       twosided=twosided)
            alpha = _alpha(d, "alpha", 0.1)
            p[6] = _alpha(d, "alpha_u", alpha)
            p[7] = _alpha(d, "alpha_v", alpha)
            code = BSDF_ROUGHPLASTIC if t == "roughplastic" \
                else BSDF_PPLASTIC
            return self._push_bsdf(code, p, tex0=tex0,
                                   flags=F_GLOSSY_REFL | F_DIFFUSE_REFL,
                                   twosided=twosided)
        if t == "principledthin":
            # principledthin.cpp's core lobes; diff_trans in [0, 2] is
            # halved at build
            p[0] = _scalar(d, "eta", 1.5)
            p[1] = _scalar(d, "roughness", 0.5)
            p[2] = _scalar(d, "spec_trans", 0.0)
            p[3] = 0.5 * _scalar(d, "diff_trans", 0.0)
            tex0 = self.build_texture(d.get("base_color", 0.5), 0.5)
            return self._push_bsdf(
                BSDF_PRINCIPLEDTHIN, p, tex0=tex0,
                flags=F_GLOSSY_REFL | F_DIFFUSE_REFL | F_GLOSSY_TRANS,
                twosided=True)
        if t == "principled":
            # principled.cpp, the full Disney model, scalar parameters
            p[0] = _scalar(d, "metallic", 0.0)
            p[1] = _scalar(d, "roughness", 0.5)
            strans = _scalar(d, "spec_trans", 0.0)
            if "eta" in d:
                eta = _scalar(d, "eta", 1.5)
                if strans > 0.0 and eta == 1.0:
                    eta = 1.001          # principled.cpp's plausibility clamp
            else:
                spec = _scalar(d, "specular", 0.5)
                if strans > 0.0 and spec == 0.0:
                    spec = 1e-3          # principled.cpp's plausibility clamp
                eta = 2.0 / (1.0 - np.sqrt(0.08 * spec)) - 1.0
            p[2] = eta
            for i, (key, dflt) in enumerate(
                    (("clearcoat", 0.0), ("clearcoat_gloss", 0.0),
                     ("anisotropic", 0.0), ("sheen", 0.0),
                     ("sheen_tint", 0.0)), start=3):
                p[i] = _scalar(d, key, dflt)
            p[8] = strans
            p[9] = _scalar(d, "flatness", 0.0)
            p[10] = _scalar(d, "spec_tint", 0.0)
            tex0 = self.build_texture(d.get("base_color", 0.5), 0.5)
            flags = F_GLOSSY_REFL | F_DIFFUSE_REFL
            if strans > 0.0:
                flags |= F_GLOSSY_TRANS
            return self._push_bsdf(BSDF_PRINCIPLED, p, tex0=tex0,
                                   flags=flags,
                                   twosided=twosided and strans == 0.0)
        if t == "measured":
            # measured.cpp, the RGL data-driven material
            self.measured.append(MeasuredData(self._path(d["filename"])))
            return self._push_bsdf(BSDF_MEASURED, p,
                                   tex0=self.build_texture([1.0] * 3),
                                   flags=F_GLOSSY_REFL, twosided=twosided)
        if t == "hair":
            # hair.cpp, the Chiang fiber model: IOR ratio, beta_m, beta_n,
            # the scale tilt, and sigma_a given or from the melanin
            # concentrations
            p[0] = _ior(d.get("int_ior"), 1.55) \
                / _ior(d.get("ext_ior"), 1.000277)
            p[1] = float(d.get("longitudinal_roughness",
                               d.get("beta_m", 0.3)))
            p[2] = float(d.get("azimuthal_roughness", d.get("beta_n", 0.3)))
            p[3] = float(np.deg2rad(float(d.get("scale_tilt",
                                                d.get("alpha", 2.0)))))
            if "sigma_a" in d:
                sa = _spectrum_to_rgb(d["sigma_a"], 0.0)
            else:
                eu = float(d.get("eumelanin", 1.3))
                ph = float(d.get("pheomelanin", 0.0))
                sa = eu * np.array([0.419, 0.697, 1.37]) \
                    + ph * np.array([0.187, 0.4, 1.05])
            tex0 = self.build_texture([float(x) for x in sa])
            return self._push_bsdf(BSDF_HAIR, p, tex0=tex0,
                                   flags=F_GLOSSY_REFL | F_GLOSSY_TRANS)
        if t == "null":
            return self._push_bsdf(BSDF_NULL, p, flags=F_NULL, twosided=True)
        if t in _ELEMENTS:
            # transmissive Mueller elements: p0 = axis angle theta, p1 =
            # the retarder's phase delta (radians), p2 = 1 for left-handed
            def deg(key, default):
                v = d.get(key)
                return float(np.deg2rad(default if v is None
                                        or isinstance(v, dict)
                                        else float(v)))
            p[0], p[1] = deg("theta", 0.0), deg("delta", 90.0)
            p[2] = 1.0 if str(d.get("polarization_mode",
                                    d.get("handedness", "right"))
                              ).lower().startswith("l") else 0.0
            tex0 = self.build_texture(
                d.get("transmittance", d.get("theta_transmittance", 1.0)),
                1.0)
            return self._push_bsdf(_ELEMENTS[t], p, tex0=tex0,
                                   flags=F_NULL | F_DELTA_TRANS,
                                   twosided=True)
        if t == "mask":
            tex0 = self.build_texture(d.get("opacity", 0.5), 0.5)
            inner = [v for k, v in d.items() if isinstance(v, dict)
                     and k != "opacity" and v.get("type") not in ("rgb",)]
            iidx, _, _ = self.build_bsdf(inner[0] if inner else None,
                                         twosided)
            self._one_level("mask", iidx)
            return self._push_bsdf(BSDF_MASK, p, tex0=tex0, inner=iidx,
                                   flags=self.b_flags[iidx] | F_NULL,
                                   twosided=twosided)
        if t == "blendbsdf":
            tex0 = self.build_texture(d.get("weight", 0.5), 0.5)
            inners = [v for k, v in d.items() if isinstance(v, dict)
                      and k != "weight" and "type" in v]
            i0, _, _ = self.build_bsdf(inners[0], twosided)
            i1, _, _ = self.build_bsdf(inners[1] if len(inners) > 1
                                       else None, twosided)
            self._one_level("blendbsdf", i0, i1)
            return self._push_bsdf(BSDF_BLEND, p, tex0=tex0, inner=i0,
                                   inner2=i1,
                                   flags=self.b_flags[i0] | self.b_flags[i1],
                                   twosided=twosided)
        raise _unsupported(t)

    def _one_level(self, what, *inner):
        """The dispatch resolves a mask's or blend's nested BSDF one level
        deep, stochastically."""
        if any(self.b_type[i] in (BSDF_MASK, BSDF_BLEND) for i in inner):
            raise ValueError(f"{what}: nested blend/mask BSDFs support one "
                             "level of nesting")

    # --- media ------------------------------------------------------------
    def build_medium(self, d) -> int:
        if d is None:
            return -1
        if d.get("type") == "ref":
            kind, idx = self.named[d["id"]][:2]
            if kind != "medium":
                raise ValueError(f"{d['id']!r} is a {kind}, not a medium")
            return idx
        t = d["type"]
        if t not in _MEDIUM_TYPES:
            raise _unsupported(t)
        p = np.zeros(MEDIUM_P, np.float32)
        st_v = d.get("sigma_t", 1.0)
        is_grid = isinstance(st_v, dict) and st_v.get("type") == "gridvolume"
        # a grid's density scales sigma_t = 1
        p[0:3] = 1.0 if is_grid else _spectrum_to_rgb(st_v, 1.0)
        p[3:6] = _spectrum_to_rgb(d.get("albedo", 0.75), 0.75)
        p[6] = float(d.get("scale", 1.0))
        p[8] = PHASE_ISOTROPIC
        phase = d.get("phase")
        if isinstance(phase, dict):
            _pack_phase(p, phase)
        p[9] = 1.0 if d.get("has_spectral_extinction", True) else 0.0
        grid_id = -1
        if t == "homogeneous":
            mtype = MEDIUM_HOMOGENEOUS
        elif t == "heterogeneous":
            mtype = MEDIUM_HETEROGENEOUS
            if is_grid:
                grid_id = self.add_grid(st_v)
                p[10] = float(self.grids[grid_id][..., :3].max())
            else:
                # the majorant of a constant sigma_t (the JAX builder's
                # choice: its sampling still reads the density of grid 0,
                # ROADMAP Queue 3)
                p[10] = float(p[0:3].max())
        elif t in ("glissonCapsule", "glisson"):
            mtype = MEDIUM_GLISSON
            _pack_glisson(p, d)
        elif t == "parenchyma":
            mtype = MEDIUM_PARENCHYMA
            _pack_parenchyma(p, d, base=12)
        else:
            mtype = MEDIUM_LIVER
            _pack_glisson(p, d)
            _pack_parenchyma(p, d, base=40)
        self.m_grid.append(grid_id)
        self.m_type.append(mtype)
        self.m_params.append(p)
        return len(self.m_type) - 1

    def add_grid(self, st: dict) -> int:
        """A gridvolume's density grid (inline `data` or a .vol file),
        widened to 4 channels, and its world -> grid-local transform."""
        from ..io.vol import read_vol
        g = np.asarray(st["data"] if "data" in st
                       else read_vol(self._path(st["filename"])), np.float32)
        if g.ndim == 3:
            g = g[..., None]
        if g.shape[-1] == 1:
            g = np.repeat(g, 4, -1)
        elif g.shape[-1] == 3:
            g = np.concatenate([g, np.ones_like(g[..., :1])], -1)
        if g.ndim != 4 or g.shape[-1] != 4:
            raise ValueError(f"gridvolume: a grid of 1, 3 or 4 channels, "
                             f"got shape {g.shape}")
        self.grids.append(g)
        tw = st.get("to_world")
        m = from_any(tw).matrix if tw is not None else np.eye(4)
        self.grid_to_local.append(np.linalg.inv(m).astype(np.float32))
        return len(self.grids) - 1

    # --- emitters ---------------------------------------------------------
    def _push_emitter(self, etype, params, shape=-1, tex0=-1,
                      to_world=None) -> int:
        self.e_type.append(etype)
        self.e_params.append(params)
        self.e_shape.append(shape)
        self.e_tex0.append(tex0)
        self.e_to_world.append(
            np.eye(4, dtype=np.float32) if to_world is None
            else np.asarray(to_world, np.float32))
        return len(self.e_type) - 1

    def build_emitter(self, d, shape_idx=-1) -> int:
        t = d["type"]
        p = np.zeros(EMITTER_P, np.float32)
        if t == "area":
            rad = d.get("radiance", 1.0)
            if isinstance(rad, dict) and rad.get("type") not in ("rgb",):
                tex0 = self.build_texture(rad)
                p[0:3] = 1.0
            else:
                tex0 = -1
                p[0:3] = _spectrum_to_rgb(rad, 1.0)
            return self._push_emitter(EMITTER_AREA, p, shape=shape_idx,
                                      tex0=tex0)
        if t == "point":
            pos = np.asarray(d.get("position", [0, 0, 0]), np.float32)
            if d.get("to_world") is not None:
                pos = from_any(d["to_world"]).apply_points(pos[None])[0]
            p[0:3] = pos
            p[3:6] = _spectrum_to_rgb(d.get("intensity", 1.0), 1.0)
            return self._push_emitter(EMITTER_POINT, p)
        if t == "constant":
            p[0:3] = _spectrum_to_rgb(d.get("radiance", 1.0), 1.0)
            self.env_index = self._push_emitter(EMITTER_CONSTANT, p)
            return self.env_index
        if t in ("directional", "directionalarea"):
            dirv = np.asarray(d.get("direction", [0, 0, 1]), np.float32)
            if d.get("to_world") is not None:
                dirv = from_any(d["to_world"]).apply_vectors(dirv[None])[0]
            p[0:3] = dirv / np.linalg.norm(dirv)
            p[3:6] = _spectrum_to_rgb(d.get("irradiance", 1.0), 1.0)
            return self._push_emitter(EMITTER_DIRECTIONAL, p)
        if t in ("spot", "projector"):
            to_w = from_any(d["to_world"]) if "to_world" in d \
                else Transform()
            dirv = to_w.apply_vectors(np.array([[0, 0, 1.0]]))[0]
            p[0:3] = to_w.apply_points(np.zeros((1, 3)))[0]
            p[8:11] = dirv / np.linalg.norm(dirv)
            if t == "spot":
                cutoff = d.get("cutoff_angle", 20.0)
                p[3:6] = _spectrum_to_rgb(d.get("intensity", 1.0), 1.0)
                p[6] = np.cos(np.deg2rad(float(cutoff)))
                p[7] = np.cos(np.deg2rad(float(d.get("beam_width",
                                                     cutoff * 0.75))))
                return self._push_emitter(EMITTER_SPOT, p)
            # a textured spot (projector.cpp): a perspective frustum of
            # `fov`, the irradiance texture over it
            fov = float(d.get("fov", 45.0))
            p[3:6] = _spectrum_to_rgb(d.get("scale", d.get("intensity", 1.0)),
                                      1.0)
            p[6] = np.cos(np.deg2rad(fov / 2.0 * 1.4142))  # corner cutoff
            p[7] = np.cos(np.deg2rad(fov / 2.0))
            p[11] = np.tan(np.deg2rad(fov / 2.0))
            tex0 = self.build_texture(d.get("irradiance", 1.0), 1.0)
            return self._push_emitter(EMITTER_PROJECTOR, p, tex0=tex0,
                                      to_world=to_w.matrix)
        if t in ("sunsky", "sun", "sky", "timed_sunsky"):
            # the Preetham sky and sun baked into an envmap
            from ..emitter.sunsky import preetham_envmap, sun_direction
            if "sun_direction" in d:
                sd = np.asarray(d["sun_direction"], np.float32)
            else:
                sd = sun_direction(hour=float(d.get("hour", 12.0)),
                                   latitude=float(d.get("latitude", 35.0)),
                                   day_of_year=int(d.get("day", 180)))
            img = preetham_envmap(
                turbidity=float(d.get("turbidity", 3.0)), sun_dir=sd,
                sun_scale=float(d.get("sun_scale",
                                      0.0 if t == "sky" else 1.0)),
                sky_scale=float(d.get("sky_scale",
                                      0.0 if t == "sun" else 1.0)))
            return self.build_emitter({"type": "envmap", "data": img,
                                       "scale": float(d.get("scale", 1.0))})
        if t != "envmap":
            raise _unsupported(t)
        p[6] = float(d.get("scale", 1.0))
        # an envmap file is always read raw (linear)
        bid = self.add_bitmap(d["data"]) if "data" in d \
            else self.load_bitmap_file(d["filename"], raw=True)
        data = np.zeros(TEX_P, np.float32)
        data[6:8] = 1.0
        tex0 = self._push_texture(TEX_BITMAP, data, bid)
        to_w = d.get("to_world")
        m = from_any(to_w).matrix if to_w is not None else np.eye(4)
        self.env_index = self._push_emitter(EMITTER_ENVMAP, p, tex0=tex0,
                                            to_world=m)
        self.env_bitmap = bid
        return self.env_index

    # --- subsurface ---------------------------------------------------------
    def build_subsurface(self, d) -> int:
        """A vaescatter or dipole row -> its index: sigmaT / albedo (default
        0.5 each) or the dipole's sigmaS / sigmaA (0.5, 0.1); forceG or g
        (0); eta (1.3, the dipole's 1.33).  kernelEpsScale is one value for
        the scene (the last subsurface's), as in the JAX builder."""
        if d.get("type") == "ref":
            kind, idx = self.named[d["id"]][:2]
            if kind != "subsurface":
                raise ValueError(f"{d['id']!r} is not a subsurface")
            return idx
        p = np.zeros(8, np.float32)
        if "sigmaS" in d or "sigmaA" in d:
            ss = _spectrum_to_rgb(d.get("sigmaS", 0.5), 0.5)
            sa = _spectrum_to_rgb(d.get("sigmaA", 0.1), 0.1)
            p[0:3] = ss + sa
            p[3:6] = ss / np.maximum(ss + sa, 1e-9)
        else:
            p[0:3] = _spectrum_to_rgb(d.get("sigmaT", d.get("sigma_t", 0.5)),
                                      0.5)
            p[3:6] = _spectrum_to_rgb(d.get("albedo", 0.5), 0.5)
        p[6] = float(d.get("forceG", d.get("g", 0.0)))
        p[7] = float(d.get("eta", 1.33 if d.get("type") == "dipole"
                           else 1.3))
        self.ssub_scale = float(d.get("kernelEpsScale", 1.0))
        self.ssub_params.append(p)
        self.ssub_types.append(SSUB_DIPOLE if d.get("type") == "dipole"
                               else SSUB_VAE)
        return len(self.ssub_params) - 1

    # --- shapes -------------------------------------------------------------
    def add_shape(self, d):
        t = d["type"]
        to_w = from_any(d["to_world"]) if "to_world" in d else Transform()
        bsdf_d = emitter_d = None
        int_med = ext_med = ssub_idx = -1
        for k, v in d.items():
            if not isinstance(v, dict):
                continue
            vt = v.get("type")
            if k == "emitter" or vt == "area":
                emitter_d = v
            elif k == "interior":
                int_med = self.build_medium(v)
            elif k == "exterior":
                ext_med = self.build_medium(v)
            elif vt == "ref":
                kind = self.named.get(v["id"], ("bsdf",))[0]
                if kind == "bsdf":
                    bsdf_d = v
                elif kind == "subsurface":
                    ssub_idx = self.build_subsurface(v)
            elif k == "subsurface" or vt in _SUBSURFACE_TYPES:
                ssub_idx = self.build_subsurface(v)
            elif vt == "irradiancemeter" or k == "sensor":
                # a sensor nested in its parent shape (the irradiancemeter)
                self.build_sensor(v)
                self.sensor_shape = len(self.s_bsdf)
            elif k == "bsdf" or vt in _BSDF_TYPES:
                bsdf_d = v
            elif vt in _OTHER_TYPES:
                raise _unsupported(vt)
        if ssub_idx >= 0 and bsdf_d is None:
            # a subsurface shape without a BSDF gets the reference's
            # internal dielectric, int_ior = eta
            bsdf_d = {"type": "dielectric", "ext_ior": 1.0,
                      "int_ior": float(self.ssub_params[ssub_idx][7])}
        bsdf_idx, bump_tex, bump_scale = self.build_bsdf(bsdf_d)
        shape_idx = len(self.s_bsdf)

        if t == "sphere":
            center = np.asarray(d.get("center", [0, 0, 0]), np.float64)
            center = to_w.apply_points(center[None])[0]
            sv = to_w.apply_vectors(np.eye(3))
            radius = float(d.get("radius", 1.0)) \
                * float(np.cbrt(abs(np.linalg.det(sv))))
            self.sph_center.append(center.astype(np.float32))
            self.sph_radius.append(radius)
            self.sph_shape.append(shape_idx)
            stype, prim_cnt = SHAPE_SPHERE, 1
            prim_off = len(self.sph_radius) - 1
            area = 4.0 * np.pi * radius * radius
        elif t == "sdfgrid":
            # sdfgrid.cpp: distances on a [0,1]^3-local grid (local units),
            # sphere-traced by accel/intersect._sdfs
            if "filename" in d:
                from ..io.vol import read_vol
                grid = read_vol(self._path(d["filename"]))[..., 0]
            else:
                grid = np.asarray(d.get("grid", d.get("data")), np.float32)
            self.sdf_grids.append(grid.astype(np.float32))
            self.sdf_to_local.append(
                np.linalg.inv(to_w.matrix).astype(np.float32))
            self.sdf_shape.append(shape_idx)
            stype, prim_cnt = SHAPE_SDF, 1
            prim_off = len(self.sdf_grids) - 1
            sv = to_w.apply_vectors(np.eye(3))
            area = 6.0 * float(np.cbrt(abs(np.linalg.det(sv)))) ** 2
        else:
            tangents = vattr = None
            if t in _CURVE_TYPES:
                # tessellated in world space: to_world is applied already
                from .curves import curve_mesh
                mesh, tangents = curve_mesh(d, self.base_dir, to_w)
                self.has_curves = True
                to_w = Transform()
            else:
                mesh = self._mesh(d, t)
                if t in ("mesh", "blender") and "vertex_attrs" in d:
                    vattr = np.asarray(d["vertex_attrs"], np.float32)
                    self.has_vattr = True
            mesh = mesh.transformed(to_w)
            if mesh.normals is None:
                mesh.normals = geo.compute_vertex_normals(mesh.vertices,
                                                          mesh.faces)
            if d.get("flip_normals", False):
                mesh.normals = -mesh.normals
                mesh.faces = mesh.faces[:, ::-1].copy()
            if mesh.uvs is None:
                mesh.uvs = np.zeros((len(mesh.vertices), 2), np.float32)
            stype, prim_off = SHAPE_MESH, sum(len(f) for f in self.faces)
            prim_cnt, area = len(mesh.faces), float(mesh.face_areas.sum())
            self.vertices.append(mesh.vertices)
            self.faces.append(mesh.faces + self.v_count)
            self.normals.append(mesh.normals)
            self.uvs.append(mesh.uvs)
            self.tangents.append(np.zeros_like(mesh.vertices)
                                 if tangents is None else tangents)
            self.vattrs.append(np.zeros_like(mesh.vertices)
                               if vattr is None else vattr)
            self.tri_shape.append(
                np.full(len(mesh.faces), shape_idx, np.int32))
            self.v_count += len(mesh.vertices)
        emitter_idx = -1 if emitter_d is None \
            else self.build_emitter(emitter_d, shape_idx)
        self.s_bsdf.append(bsdf_idx)
        self.s_emitter.append(emitter_idx)
        self.s_int_med.append(int_med)
        self.s_ext_med.append(ext_med)
        self.s_bump_tex.append(bump_tex)
        self.s_bump_scale.append(bump_scale)
        self.s_type.append(stype)
        self.s_prim_off.append(prim_off)
        self.s_prim_cnt.append(prim_cnt)
        self.s_area.append(area)
        self.s_ssub.append(ssub_idx)

    # --- instanced shapegroups -----------------------------------------------
    def ensure_group(self, gid: str, group: dict) -> None:
        """Build a shapegroup's children once into a group-local triangle
        stream that its instances share (shapegroup.cpp).  The children's
        shape rows (BSDF, media, bump) are global and shared; only their
        geometry goes to the group stream, padded to INST_CHUNK rows."""
        if gid in self.groups:
            return
        saved = (self.vertices, self.faces, self.normals, self.uvs,
                 self.tangents, self.vattrs, self.tri_shape, self.v_count)
        self.vertices, self.faces, self.normals, self.uvs = [], [], [], []
        self.tangents, self.vattrs, self.tri_shape = [], [], []
        self.v_count = 0
        try:
            for sval in group.values():
                if isinstance(sval, dict) and sval.get("type") \
                        in _SHAPE_TYPES:
                    self.add_shape(sval)
            cat = np.concatenate
            V = cat(self.vertices) if self.vertices \
                else np.zeros((0, 3), np.float32)
            F = cat(self.faces).astype(np.int32) if self.faces \
                else np.zeros((0, 3), np.int32)
            Nrm = cat(self.normals) if self.normals \
                else np.zeros((0, 3), np.float32)
            UV = cat(self.uvs) if self.uvs else np.zeros((0, 2), np.float32)
            TS = cat(self.tri_shape).astype(np.int32) if self.tri_shape \
                else np.zeros((0,), np.int32)
        finally:
            (self.vertices, self.faces, self.normals, self.uvs,
             self.tangents, self.vattrs, self.tri_shape,
             self.v_count) = saved
        # the template shapes lie in no global primitive range
        for sh in set(TS.tolist()):
            self.s_prim_off[sh] = -1
            self.s_prim_cnt[sh] = 0
        Tg = len(F)
        pad = (-Tg) % INST_CHUNK
        p0, p1, p2 = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
        si = np.zeros((Tg + pad, 25), np.float32)
        si[:Tg, 0:3] = p0
        si[:Tg, 3:6] = p1
        si[:Tg, 6:9] = p2
        si[:Tg, 9:12] = Nrm[F[:, 0]]
        si[:Tg, 12:15] = Nrm[F[:, 1]]
        si[:Tg, 15:18] = Nrm[F[:, 2]]
        si[:Tg, 18:20] = UV[F[:, 0]]
        si[:Tg, 20:22] = UV[F[:, 1]]
        si[:Tg, 22:24] = UV[F[:, 2]]
        si[:Tg, 24] = TS
        si[Tg:, 24] = -1
        tris = np.zeros((Tg + pad, 3, 3), np.float32)
        tris[:Tg] = np.stack([p0, p1, p2], axis=1)
        self.groups[gid] = {
            "start": sum(x.shape[0] for x in self.g_tris),
            "n_chunks": (Tg + pad) // INST_CHUNK,
            "bmin": V.min(0) if len(V) else np.zeros(3, np.float32),
            "bmax": V.max(0) if len(V) else np.zeros(3, np.float32)}
        self.g_tris.append(tris)
        self.g_si.append(si)

    def add_instance(self, gid: str, to_world: Transform) -> None:
        """One instance of a built shapegroup (instance.cpp): its to-world
        3x4, the inverse transpose for normals, and the world box of the
        group's transformed corners."""
        g = self.groups[gid]
        M = np.asarray(to_world.matrix, np.float64)
        corners = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                            for z in (0, 1)], np.float64)
        cw = (g["bmin"] + corners * (g["bmax"] - g["bmin"])) @ M[:3, :3].T \
            + M[:3, 3]
        self.inst_rows.append((M[:3, :4].astype(np.float32),
                               np.linalg.inv(M[:3, :3]).T.astype(np.float32),
                               g["start"], g["n_chunks"],
                               cw.min(0).astype(np.float32),
                               cw.max(0).astype(np.float32)))

    def _mesh(self, d, t) -> geo.MeshData:
        """The untransformed triangle mesh of a mesh-like shape."""
        if t == "rectangle":
            return geo.rectangle()
        if t == "cube":
            return geo.cube()
        if t == "disk":
            return geo.disk()
        if t == "cylinder":
            def z(key, default):
                v = d.get(key)
                return float(v[2]) if isinstance(v, (list, tuple)) \
                    else default
            return geo.cylinder(p0_z=z("p0", 0.0), p1_z=z("p1", 1.0),
                                radius=float(d.get("radius", 1.0)))
        if t in ("obj", "ply", "serialized"):
            from .meshio import load_mesh
            return load_mesh(self._path(d["filename"]),
                             face_normals=bool(d.get("face_normals", False)),
                             shape_index=int(d.get("shape_index", 0)))
        if t in ("ellipsoids", "ellipsoidsmesh"):
            return self._ellipsoids(d)
        # mesh, and blender (a mesh handed over by the host application)
        return geo.MeshData(d["vertices"], d["faces"], d.get("normals"),
                            d.get("uvs"))

    def _ellipsoids(self, d) -> geo.MeshData:
        """N ellipsoids, rows of center [0:3], scale [3:6] and quaternion
        (x, y, z, w) [6:10], as instanced icospheres in the triangle
        buffer; with opacities or SH coefficients they are the
        radiance-field integrator's splats (the vp_* lists)."""
        if "data" in d:
            rows = np.asarray(d["data"], np.float32).reshape(-1, 10)
            centers, scales, quats = rows[:, 0:3], rows[:, 3:6], rows[:, 6:10]
        else:
            centers = np.asarray(d["centers"], np.float32)
            scales = np.asarray(d["scales"], np.float32)
            quats = np.asarray(d["quaternions"], np.float32)
        extent = float(d.get("extent", 3.0))
        R = geo.quat_to_matrix(quats)                        # (N, 3, 3)
        base = geo.icosphere(int(d.get("subdiv", 1)))
        bv, bf = base.vertices, base.faces
        n_e, n_v = len(centers), len(bv)
        # world vertices c + R (s extent v), normals R (n / s)
        sv = bv[None, :, :] * (scales[:, None, :] * extent)
        wv = np.einsum("nij,nvj->nvi", R, sv) + centers[:, None, :]
        nn = bv[None, :, :] / np.maximum(scales[:, None, :], 1e-12)
        wn = np.einsum("nij,nvj->nvi", R, nn)
        wn /= np.maximum(np.linalg.norm(wn, axis=-1, keepdims=True), 1e-12)
        faces = bf[None, :, :] + (np.arange(n_e) * n_v)[:, None, None]
        if "opacities" in d or "sh_coeffs" in d:
            op = np.asarray(d.get("opacities", np.ones(n_e)),
                            np.float32).reshape(-1)
            shc = np.asarray(d.get("sh_coeffs", np.zeros((n_e, 3))),
                             np.float32).reshape(n_e, -1, 3)
            ell_base = sum(len(c) for c in self.vp_center)
            self.vp_center.append(centers)
            self.vp_scale.append(scales * extent)
            self.vp_rot.append(R.astype(np.float32))
            self.vp_opacity.append(op)
            self.vp_sh.append(shc)
            self.vp_tri.append(
                (sum(len(f) for f in self.faces),
                 ell_base + np.repeat(np.arange(n_e, dtype=np.int32),
                                      len(bf))))
        return geo.MeshData(wv.reshape(-1, 3),
                            faces.reshape(-1, 3).astype(np.int32),
                            wn.reshape(-1, 3),
                            np.zeros((n_e * n_v, 2), np.float32))

    # --- sensor / film ------------------------------------------------------
    def build_sensor(self, d):
        to_w = d.get("to_world")
        if to_w is not None:
            self.sensor_to_world = from_any(to_w).matrix.astype(np.float32)
        self.sensor_type = _SENSOR_TYPES.get(d.get("type", "perspective"),
                                             SENSOR_PERSPECTIVE)
        if "direction" in d and self.sensor_type == SENSOR_DISTANT:
            # a distant sensor's direction overrides to_world
            dvec = np.asarray(d["direction"], np.float64)
            dvec = dvec / np.linalg.norm(dvec)
            sv = np.cross([0.0, 1.0, 0.0] if abs(dvec[1]) < 0.99
                          else [1.0, 0.0, 0.0], dvec)
            sv /= np.linalg.norm(sv)
            mtx = np.eye(4, dtype=np.float32)
            mtx[:3, 0], mtx[:3, 1], mtx[:3, 2] = sv, np.cross(dvec, sv), dvec
            self.sensor_to_world = mtx
        if "target" in d:
            self.sensor_target = np.asarray(d["target"], np.float32)
        if self.sensor_type == SENSOR_BATCH:
            # the child cameras, side by side along the film's width
            mats, fovs = [], []
            for v in d.values():
                if isinstance(v, dict) and v.get("type") in (
                        "perspective", "thinlens", "orthographic"):
                    sub = _Builder.__new__(_Builder)
                    sub.sensor_to_world = np.eye(4, dtype=np.float32)
                    sub.build_sensor(v)
                    mats.append(sub.sensor_to_world)
                    fovs.append(sub.fov_x)
            if mats:
                self.batch_to_world = np.stack(mats)
                self.batch_fov_x = np.asarray(fovs, np.float32)
        self.aperture_radius = float(d.get("aperture_radius", 0.0))
        self.focus_distance = float(d.get("focus_distance", 1.0))
        self.near = float(d.get("near_clip", 1e-2))
        self.far = float(d.get("far_clip", 1e4))
        fov = float(d.get("fov", 45.0))
        axis = d.get("fov_axis", "x")
        film = d.get("film", {})
        self.film_w = int(film.get("width", 256))
        self.film_h = int(film.get("height", 256))
        rf = film.get("rfilter", {})
        rft = rf.get("type", "gaussian") if isinstance(rf, dict) else rf
        self.rfilter = _FILTERS.get(rft, FILTER_GAUSSIAN)
        sampler = d.get("sampler", {})
        self.spp = int(sampler.get("sample_count", 16))
        self.sampler_kind = sampler.get("type", "independent")
        if self.sampler_kind not in _SAMPLERS:
            raise _unsupported(self.sampler_kind)
        aspect = self.film_w / self.film_h
        if axis == "smaller":
            axis = "x" if aspect <= 1 else "y"
        elif axis == "larger":
            axis = "x" if aspect > 1 else "y"
        if axis == "y":
            tan_half = np.tan(np.deg2rad(fov) / 2) * aspect
            fov = float(np.rad2deg(2 * np.arctan(tan_half)))
        self.fov_x = fov
        if "medium" in d:
            self.camera_medium = self.build_medium(d["medium"])

    # --- finalize -----------------------------------------------------------
    def _check_texture_slots(self):
        """Mesh-attribute and volume textures are read at the interaction
        (its vertex attribute, its position) only in a BSDF's slots.  The
        JAX package evaluates them as white in an emitter's radiance, a
        bump or normal map and a mask's shadow-ray opacity; the port
        refuses them there."""
        kinds = {TEX_MESHATTR: "mesh_attribute", TEX_VOLUME: "volume"}
        slots = [("an emitter", t) for t in self.e_tex0] \
            + [("a bump or normal map", t) for t in self.s_bump_tex] \
            + [("a mask's opacity", self.b_tex0[i])
               for i, bt in enumerate(self.b_type) if bt == BSDF_MASK]
        for where, t in slots:
            if t >= 0 and self.tex_type[t] in kinds:
                raise ValueError(
                    f"a {kinds[self.tex_type[t]]} texture in {where} is "
                    "not evaluated at the interaction (only BSDF slots "
                    "are)")

    def finalize(self):
        """(arrays, statics) under the JAX Scene's dotted field paths."""
        self._check_texture_slots()
        T = sum(len(f) for f in self.faces)
        V = np.concatenate(self.vertices) if self.vertices \
            else np.zeros((1, 3), np.float32)
        F = np.concatenate(self.faces).astype(np.int32) if self.faces \
            else np.zeros((1, 3), np.int32)
        Nrm = np.concatenate(self.normals) if self.normals \
            else np.zeros((1, 3), np.float32)
        UV = np.concatenate(self.uvs) if self.uvs \
            else np.zeros((1, 2), np.float32)
        TS = np.concatenate(self.tri_shape).astype(np.int32) \
            if self.tri_shape else np.zeros((1,), np.int32)
        TGT = np.concatenate(self.tangents) if self.has_curves \
            else np.zeros((1, 3), np.float32)
        VA = np.concatenate(self.vattrs) if self.has_vattr and self.vattrs \
            else np.zeros((1, 3), np.float32)
        v0, v1, v2 = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
        # triangle areas and their global cumulative sum (area emitters
        # pick a triangle by it), in the JAX builder's numpy operations
        ta = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
        if not T:
            ta = np.zeros_like(ta)
        ta_cdf = np.cumsum(ta).astype(np.float32)
        # emitter selection: uniform weights
        e_cdf = np.cumsum(np.ones(max(len(self.e_type), 1), np.float32))
        z3 = np.zeros((0, 3), np.float32)
        bvh = build_bvh(v0, v1, v2) if T else build_bvh(z3, z3, z3)
        if T:
            tri_buf, boxes, kperm, center = pack_tris(v0, v1, v2, bvh.perm)
        else:
            tri_buf, boxes, kperm, center = pack_tris(z3, z3, z3)
        # packed per-triangle interaction rows (one gather in compute_si)
        tri_si = np.zeros((max(T, 1), 25), np.float32)
        if T:
            tri_si[:, 0:3] = v0
            tri_si[:, 3:6] = v1 - v0
            tri_si[:, 6:9] = v2 - v0
            tri_si[:, 9:12] = Nrm[F[:, 0]]
            tri_si[:, 12:15] = Nrm[F[:, 1]]
            tri_si[:, 15:18] = Nrm[F[:, 2]]
            tri_si[:, 18:20] = UV[F[:, 0]]
            tri_si[:, 20:22] = UV[F[:, 1]]
            tri_si[:, 22:24] = UV[F[:, 2]]
            tri_si[:, 24] = TS

        if self.env_bitmap >= 0:
            env = _env_importance(self.bitmaps[self.env_bitmap])
        else:
            env = build_distribution_2d_np(np.ones((1, 1), np.float32))
        stack, hw, quads, has_quads = _pack_bitmaps(self.bitmaps)
        gstack, gwhd, g2l = _pack_grids(self.grids, self.grid_to_local)
        vg, vwhd, vl2w = _pack_volume_textures(self.vol_grids,
                                               self.vol_to_local)

        n_s = len(self.s_bsdf)
        i32 = np.int32
        arrays = {
            "vertices": V.astype(np.float32), "faces": F,
            "normals": Nrm.astype(np.float32), "tri_shape": TS,
            "sph_center": (np.stack(self.sph_center) if self.sph_center
                           else np.zeros((1, 3))).astype(np.float32),
            "sph_radius": np.asarray(self.sph_radius or [1.0], np.float32),
            "sph_shape": np.asarray(self.sph_shape or [-1], i32),
            "shape_bsdf": np.asarray(self.s_bsdf or [0], i32),
            "shape_emitter": np.asarray(self.s_emitter or [-1], i32),
            "shape_int_medium": np.asarray(self.s_int_med or [-1], i32),
            "shape_ext_medium": np.asarray(self.s_ext_med or [-1], i32),
            "shape_bump_tex": np.asarray(self.s_bump_tex or [-1], i32),
            "shape_bump_scale": np.asarray(self.s_bump_scale or [0.0],
                                           np.float32),
            "shape_subsurface": np.asarray(self.s_ssub or [-1], i32),
            "shape_type": np.asarray(self.s_type or [0], i32),
            "shape_prim_offset": np.asarray(self.s_prim_off or [0], i32),
            "shape_prim_count": np.asarray(self.s_prim_cnt or [0], i32),
            "shape_area": np.asarray(self.s_area or [1.0], np.float32),
            "tri_area_cdf": ta_cdf,
            "tri_buf": tri_buf, "tri_boxes": boxes, "tri_kperm": kperm,
            "tri_center": center, "tri_si": tri_si,
            "textures.ttype": np.asarray(self.tex_type or [0], i32),
            "textures.data": (np.stack(self.tex_data) if self.tex_data
                              else np.zeros((1, TEX_P))).astype(np.float32),
            "textures.bitmap_id": np.asarray(self.tex_bitmap or [-1], i32),
            "textures.bitmaps": stack, "textures.bitmap_hw": hw,
            "textures.quads": quads,
            "textures.vgrids": vg, "textures.vgrid_whd": vwhd,
            "textures.vgrid_to_local": vl2w,
            "tangents": TGT.astype(np.float32),
            "vertex_attrs": VA.astype(np.float32),
            "bsdfs.btype": np.asarray(self.b_type or [0], i32),
            "bsdfs.params": (np.stack(self.b_params) if self.b_params
                             else np.zeros((1, BSDF_P))).astype(np.float32),
            "bsdfs.tex0": np.asarray(self.b_tex0 or [-1], i32),
            "bsdfs.tex1": np.asarray(self.b_tex1 or [-1], i32),
            "bsdfs.inner": np.asarray(self.b_inner or [-1], i32),
            "bsdfs.inner2": np.asarray(self.b_inner2 or [-1], i32),
            "bsdfs.flags": np.asarray(self.b_flags or [0], np.uint32),
            "bsdfs.twosided": np.asarray(self.b_twosided or [False]),
            "emitters.etype": np.asarray(self.e_type or [0], i32),
            "emitters.params": (np.stack(self.e_params) if self.e_params
                                else np.zeros((1, EMITTER_P))
                                ).astype(np.float32),
            "emitters.shape": np.asarray(self.e_shape or [-1], i32),
            "emitters.tex0": np.asarray(self.e_tex0 or [-1], i32),
            "emitters.to_world": (np.stack(self.e_to_world) if self.e_to_world
                                  else np.eye(4)[None]).astype(np.float32),
            "emitters.distr.cdf": e_cdf,
            "emitters.distr.pmf": np.ones_like(e_cdf),
            "emitters.distr.total": e_cdf[-1],
            **{f"emitters.env_distr.{k}": v for k, v in env.items()},
            "media.mtype": np.asarray(self.m_type or [0], i32),
            "media.params": (np.stack(self.m_params) if self.m_params
                             else np.zeros((1, MEDIUM_P))).astype(np.float32),
            "media.grid_id": np.asarray(self.m_grid or [-1], i32),
            "media.grids": gstack, "media.grid_whd": gwhd,
            "media.grid_to_local": g2l,
            "bvh.node_min": bvh.node_min, "bvh.node_max": bvh.node_max,
            "bvh.right": bvh.right, "bvh.first": bvh.first,
            "bvh.count": bvh.count, "bvh.perm": bvh.perm,
            **self._sensor_arrays(V),
        }
        sdf_arrays, sdf_statics = self._sdf_arrays()
        arrays.update(sdf_arrays)
        inst_arrays, inst_statics = self._instance_arrays(T)
        arrays.update(inst_arrays)
        ssub_arrays, ssub_statics = self._subsurface(V, F)
        arrays.update(ssub_arrays)
        vp_arrays, vp_statics = self._volprims(T)
        arrays.update(vp_arrays)
        if self.measured:
            ms_arrays, ms_statics = measured_table_arrays(self.measured)
        else:
            ms_arrays, ms_statics = empty_measured_arrays(), {}
        arrays.update(ms_arrays)
        # static NEE reachability (as the JAX builder): surface NEE needs a
        # shape-referenced smooth BSDF, medium NEE a non-bio medium of a
        # shape (a sensor medium does not count) under a stock volpath
        # integrator
        used_media = {m for m in self.s_int_med + self.s_ext_med if m >= 0}
        statics = {
            "textures.types_present": tuple(sorted(set(self.tex_type)))
            or (TEX_CONST,),
            "textures.has_quads": has_quads,
            "bsdfs.types_present": tuple(sorted(set(self.b_type))) or (0,),
            "bsdfs.tex0_types": tuple(sorted({self.tex_type[t] for t in
                                              self.b_tex0 if t >= 0})
                                      or [0]),
            "bsdfs.tex1_types": tuple(sorted({self.tex_type[t] for t in
                                              self.b_tex1 if t >= 0})
                                      or [0]),
            "emitters.env_index": self.env_index,
            "emitters.types_present": tuple(sorted(set(self.e_type))),
            "emitters.count": len(self.e_type),
            "media.types_present": tuple(sorted(set(self.m_type))),
            "media.phase_types": tuple(sorted({int(p[8])
                                               for p in self.m_params}))
            if self.m_params else (0,),
            "media.count": len(self.m_type),
            "bvh.depth": int(bvh.depth),
            "sensor.stype": self.sensor_type,
            "sensor.has_target": self.sensor_target is not None,
            "sensor.target_shape": self.sensor_shape,
            "sensor.batch_count": len(self.batch_to_world),
            "n_shapes": n_s, "n_tris": T, "n_spheres": len(self.sph_radius),
            "film_w": self.film_w, "film_h": self.film_h,
            "rfilter": self.rfilter, "spp": self.spp,
            "sampler_kind": self.sampler_kind,
            "integrator": self.integrator, "max_depth": self.max_depth,
            "rr_depth": self.rr_depth, "hide_emitters": self.hide_emitters,
            "camera_medium": self.camera_medium,
            "has_bump": any(t >= 0 for t in self.s_bump_tex),
            "has_heightmap": any(t >= 0 and sc > 0 for t, sc in
                                 zip(self.s_bump_tex, self.s_bump_scale)),
            "has_normalmap": any(t >= 0 and sc < 0 for t, sc in
                                 zip(self.s_bump_tex, self.s_bump_scale)),
            "needs_surface_nee": bool(self.e_type) and any(
                (self.b_flags[i] & F_SMOOTH) != 0 for i in set(self.s_bsdf)),
            "needs_medium_nee": bool(self.e_type)
            and self.integrator in ("volpath", "volpathmis", "prbvolpath")
            and any(self.m_type[m] < MEDIUM_GLISSON for m in used_media),
            "has_tangents": self.has_curves,
            "has_vertex_attr": self.has_vattr,
            **sdf_statics, **inst_statics, **ssub_statics, **vp_statics,
            **ms_statics,
        }
        return arrays, statics

    def _sdf_arrays(self):
        """The SDF grids padded to a common (D, H, W) with 1e9, their true
        (W, H, D), transforms and shapes; a 2^3 placeholder without
        any."""
        if not self.sdf_grids:
            return {"sdf_grids": np.zeros((1, 2, 2, 2), np.float32),
                    "sdf_whd": np.full((1, 3), 2, np.int32),
                    "sdf_to_local": np.eye(4, dtype=np.float32)[None],
                    "sdf_shape": np.full((1,), -1, np.int32)}, {"n_sdfs": 0}
        gl = self.sdf_grids
        stack = np.full((len(gl), max(g.shape[0] for g in gl),
                         max(g.shape[1] for g in gl),
                         max(g.shape[2] for g in gl)), 1e9, np.float32)
        for i, g in enumerate(gl):
            stack[i, :g.shape[0], :g.shape[1], :g.shape[2]] = g
        return {"sdf_grids": stack,
                "sdf_whd": np.array([[g.shape[2], g.shape[1], g.shape[0]]
                                     for g in gl], np.int32),
                "sdf_to_local": np.stack(self.sdf_to_local),
                "sdf_shape": np.asarray(self.sdf_shape, np.int32)}, \
            {"n_sdfs": len(gl)}

    def _instance_arrays(self, T):
        """The shared group streams and the per-instance rows; one-row
        placeholders without instances."""
        if not self.inst_rows:
            return {"inst_tris": np.zeros((1, 3, 3), np.float32),
                    "inst_si": np.zeros((1, 25), np.float32),
                    "inst_xf": np.zeros((1, 21), np.float32),
                    "inst_face_start": np.zeros((1,), np.int32),
                    "inst_n_chunks": np.zeros((1,), np.int32),
                    "inst_bmin": np.zeros((1, 3), np.float32),
                    "inst_bmax": np.zeros((1, 3), np.float32)}, {}
        tris = np.concatenate(self.g_tris)
        rows = self.inst_rows
        nchunks = np.asarray([r[3] for r in rows], np.int32)
        # hits are encoded prim = n_tris + instance * Tg + group row
        if len(rows) * tris.shape[0] >= 2 ** 31 - max(T, 1):
            raise ValueError("instanced prim encoding exceeds int32")
        return {"inst_tris": tris, "inst_si": np.concatenate(self.g_si),
                "inst_xf": np.stack([np.concatenate([r[0].reshape(12),
                                                     r[1].reshape(9)])
                                     for r in rows]),
                "inst_face_start": np.asarray([r[2] for r in rows],
                                              np.int32),
                "inst_n_chunks": nchunks,
                "inst_bmin": np.stack([r[4] for r in rows]),
                "inst_bmax": np.stack([r[5] for r in rows])}, {
            "n_instances": len(rows), "n_inst_tris": int(tris.shape[0]),
            "inst_max_chunks": int(nchunks.max())}

    def _volprims(self, T):
        """The splat table's arrays and statics: the SH padded to the
        largest K, sh_degree = sqrt(K) - 1, tri_ell -1 on every triangle
        that is no splat's; a one-row placeholder without splats."""
        if not self.vp_center:
            return {"volprims.center": np.zeros((1, 3), np.float32),
                    "volprims.scale": np.ones((1, 3), np.float32),
                    "volprims.rot": np.eye(3, dtype=np.float32)[None],
                    "volprims.opacity": np.zeros((1,), np.float32),
                    "volprims.sh": np.zeros((1, 1, 3), np.float32),
                    "volprims.tri_ell": np.full((1,), -1, np.int32)}, {}
        K = max(s.shape[1] for s in self.vp_sh)
        sh = np.concatenate([np.pad(s, ((0, 0), (0, K - s.shape[1]), (0, 0)))
                             for s in self.vp_sh])
        tri_ell = np.full((max(T, 1),), -1, np.int32)
        for start, ell in self.vp_tri:
            tri_ell[start:start + len(ell)] = ell
        cat = np.concatenate
        return {"volprims.center": cat(self.vp_center).astype(np.float32),
                "volprims.scale": cat(self.vp_scale).astype(np.float32),
                "volprims.rot": cat(self.vp_rot).astype(np.float32),
                "volprims.opacity": cat(self.vp_opacity).astype(np.float32),
                "volprims.sh": sh.astype(np.float32),
                "volprims.tri_ell": tri_ell}, {
            "volprims.count": sum(len(c) for c in self.vp_center),
            "volprims.sh_degree": int(np.sqrt(K)) - 1,
            "volprims.srgb": self.srgb_primitives}

    def _sensor_arrays(self, V):
        """The sensor table, with the scene's bounding sphere (over the
        vertices and the analytic spheres) for a distant sensor."""
        pts = [V]
        if self.sph_center:
            cs = np.asarray(self.sph_center, np.float32)
            rs = np.asarray(self.sph_radius, np.float32)[:, None]
            pts += [cs - rs, cs + rs]
        corners = np.array([[x, y, z, 1.0] for x in (0, 1) for y in (0, 1)
                            for z in (0, 1)], np.float32)
        for a in self.sdf_to_local:
            pts.append((corners @ np.linalg.inv(a).T)[:, :3])
        for r in self.inst_rows:
            pts.append(np.stack([r[4], r[5]]))
        allp = np.concatenate(pts)
        bc = 0.5 * (allp.min(0) + allp.max(0))
        br = float(np.linalg.norm(allp - bc, axis=1).max())
        f32 = np.float32
        return {
            "sensor.to_world": self.sensor_to_world.astype(f32),
            "sensor.fov_x": np.asarray(self.fov_x, f32),
            "sensor.near_clip": np.asarray(self.near, f32),
            "sensor.far_clip": np.asarray(self.far, f32),
            "sensor.aperture_radius": np.asarray(self.aperture_radius, f32),
            "sensor.focus_distance": np.asarray(self.focus_distance, f32),
            "sensor.bsphere": np.asarray([*bc, max(br, 1e-6)], f32),
            "sensor.target": np.zeros(3, f32) if self.sensor_target is None
            else self.sensor_target.astype(f32),
            "sensor.batch_to_world": self.batch_to_world.astype(f32),
            "sensor.batch_fov_x": self.batch_fov_x.astype(f32),
        }

    def _subsurface(self, V, F):
        """The subsurface table's arrays and statics, as the JAX builder
        packs them.  With a vaescatter shape the VAE comes from
        ssub.vae.load_model() (its VAEWeights fields, as numpy, under
        ssub.weights.*) and each vaescatter mesh's vertices get their
        polynomial fits; without the model the VAE is off and the shape
        renders as its internal dielectric.  The dipole's point cloud
        (1,024 area-uniform points per dipole mesh, padded to a CHUNK
        multiple) is packed here; its irradiance needs the built scene
        (load_dict), which reads the points' normals from the extra key
        DIPOLE_NORMALS."""
        from ..ssub import vae as vae_mod
        from ..ssub.dipole import CHUNK, dipole_constants
        from ..ssub.preprocess import fit_shape_polys, sample_surface
        out = {"ssub.dip_points": np.zeros((256, 3), np.float32),
               "ssub.dip_irradiance": np.zeros((256, 3), np.float32),
               "ssub.dip_area": np.zeros((256,), np.float32),
               "ssub.dip_consts": np.ones((10,), np.float32)}
        used = sorted({i for i in self.s_ssub if i >= 0})
        if not used:
            out.update({"ssub.params": np.zeros((1, 8), np.float32),
                        "ssub.poly": np.zeros((1, 3, 20), np.float32),
                        "ssub.ss_type": np.zeros((1,), np.int32)})
            return out, {"ssub.enabled": False}
        has_vae = any(self.ssub_types[i] == SSUB_VAE for i in used)
        has_dipole = any(self.ssub_types[i] == SSUB_DIPOLE for i in used)
        if has_vae:
            has_vae = vae_mod.model_available()
            if has_vae:
                out.update({f"ssub.weights.{k}": v
                            for k, v in vae_mod.load_model().items()})
            else:
                warnings.warn(
                    "vaescatter: no VAE model in "
                    f"{vae_mod.DEFAULT_MODEL_DIR}; the shape renders as its "
                    "internal dielectric", stacklevel=3)
        poly = np.zeros((max(len(V), 1), 3, 20), np.float32)
        pts, nrm = [], []
        first_dipole = None
        for sh, ssid in enumerate(self.s_ssub):
            if ssid < 0:
                continue
            kind = self.ssub_types[ssid]
            if kind == SSUB_DIPOLE and first_dipole is None:
                first_dipole = ssid
            if self.s_type[sh] != SHAPE_MESH:
                continue
            off, cnt = self.s_prim_off[sh], self.s_prim_cnt[sh]
            f_glob = F[off:off + cnt]
            if kind == SSUB_VAE and has_vae:
                vids = np.unique(f_glob)
                remap = -np.ones(len(V), np.int64)
                remap[vids] = np.arange(len(vids))
                prm = self.ssub_params[ssid]
                poly[vids] = fit_shape_polys(
                    V[vids].astype(np.float32),
                    remap[f_glob].astype(np.int32), prm[0:3], prm[3:6],
                    float(prm[6]), self.ssub_scale)
            elif kind == SSUB_DIPOLE:
                p, n = sample_surface(V, f_glob, 1024, seed=21)
                pts.append(p)
                nrm.append(n)
        if pts:
            pts, nrm = np.concatenate(pts), np.concatenate(nrm)
            total = sum(self.s_area[sh] for sh, ssid in enumerate(self.s_ssub)
                        if ssid >= 0 and self.ssub_types[ssid] == SSUB_DIPOLE)
            area = np.full(len(pts), total / len(pts), np.float32)
            # zero-area padding to a CHUNK multiple
            pad = (-len(pts)) % CHUNK
            pts = np.concatenate([pts, np.zeros((pad, 3), np.float32)])
            nrm = np.concatenate([nrm, np.tile(np.float32([[0, 0, 1]]),
                                               (pad, 1))])
            area = np.concatenate([area, np.zeros(pad, np.float32)])
            prm = self.ssub_params[first_dipole]
            sigma_s = prm[3:6] * prm[0:3]
            zr, zv, sigma_tr, _ = dipole_constants(
                sigma_s, prm[0:3] - sigma_s, float(prm[6]), float(prm[7]))
            out.update({
                "ssub.dip_points": pts, "ssub.dip_area": area,
                "ssub.dip_irradiance": np.zeros_like(pts),
                "ssub.dip_consts": np.concatenate(
                    [zr, zv, sigma_tr, [prm[7]]]).astype(np.float32),
                DIPOLE_NORMALS: nrm})
        out.update({"ssub.params": np.stack(self.ssub_params),
                    "ssub.poly": poly,
                    "ssub.ss_type": np.asarray(self.ssub_types, np.int32)})
        return out, {"ssub.kernel_eps_scale": self.ssub_scale,
                     "ssub.enabled": has_vae or has_dipole,
                     "ssub.has_vae": has_vae, "ssub.has_dipole": has_dipole}


def _group_instanceable(group: dict) -> bool:
    """True when every child of a shapegroup can share one group-local
    stream: plain meshes without an emitter or a subsurface (the JAX
    builder's rule; other groups are replicated, more permissive than the
    reference, which refuses emitters in groups)."""
    for sval in group.values():
        if not isinstance(sval, dict) or sval.get("type") not in _SHAPE_TYPES:
            continue
        if sval["type"] not in _INSTANCEABLE_TYPES:
            return False
        for k, v in sval.items():
            vt = v.get("type") if isinstance(v, dict) else None
            if k in ("emitter", "subsurface") or vt in ("area",) \
                    or vt in _SUBSURFACE_TYPES:
                return False
    return True


def build_numpy(d: Dict[str, Any], base_dir: str = ".",
                variant: str | None = None, flatten_instances: bool = False):
    """The scene dict packed into (arrays, statics) numpy tables.
    flatten_instances: replicate every shapegroup's geometry per instance
    instead of sharing one group-local stream."""
    if d.get("type") != "scene":
        raise ValueError("top-level dict must be a scene")
    variant = variant or d.get("variant")
    b = _Builder(base_dir)
    # pass 1: named non-shape resources (so refs resolve)
    for key, val in d.items():
        if not isinstance(val, dict):
            continue
        t = val.get("type")
        vid = val.get("id", key)
        if t in _BSDF_TYPES:
            b.named[vid] = b.named[key] = ("bsdf",) + b.build_bsdf(val)
        elif t in _MEDIUM_TYPES:
            idx = b.build_medium(val)
            b.named[vid] = b.named[key] = ("medium", idx)
        elif t in _TEXTURE_TYPES:
            idx = b.build_texture(val)
            b.named[vid] = b.named[key] = ("texture", idx)
        elif t in _SUBSURFACE_TYPES:
            idx = b.build_subsurface(val)
            b.named[vid] = b.named[key] = ("subsurface", idx)
        elif t in _OTHER_TYPES:
            raise _unsupported(t)
    # pass 2: integrator + sensor
    for val in d.values():
        if not isinstance(val, dict):
            continue
        t = val.get("type")
        if t in _INTEGRATORS:
            b.integrator = t
            b.max_depth = int(val.get("max_depth",
                                      64 if t == "volprim_rf_basic" else 8))
            if b.max_depth < 0:
                b.max_depth = 64
            b.rr_depth = int(val.get("rr_depth", 5))
            b.hide_emitters = bool(val.get("hide_emitters", False))
            b.srgb_primitives = bool(val.get("srgb_primitives", True))
        elif t in _SENSOR_TYPES:
            b.build_sensor(val)
    groups = {key: val for key, val in d.items()
              if isinstance(val, dict) and val.get("type") == "shapegroup"}
    groups.update({val["id"]: val for val in list(groups.values())
                   if "id" in val})
    # pass 3: shapes + standalone emitters
    for val in d.values():
        if not isinstance(val, dict):
            continue
        t = val.get("type")
        if t in _SHAPE_TYPES:
            b.add_shape(val)
        elif t == "merge":
            # merge.cpp joins its child meshes; the SoA scene holds all
            # geometry in one buffer, so its children are added as shapes
            for sval in val.values():
                if isinstance(sval, dict) and sval.get("type") \
                        in _SHAPE_TYPES:
                    b.add_shape(sval)
        elif t == "instance":
            gid = next(v["id"] for v in val.values()
                       if isinstance(v, dict) and v.get("type") == "ref")
            group = groups[gid]
            inst_tw = from_any(val["to_world"]) if "to_world" in val \
                else Transform()
            if not flatten_instances and _group_instanceable(group):
                b.ensure_group(gid, group)
                b.add_instance(gid, inst_tw)
            else:
                # replicate the group's shapes with the composed transform
                for sval in group.values():
                    if isinstance(sval, dict) \
                            and sval.get("type") in _SHAPE_TYPES:
                        child = dict(sval)
                        child_tw = from_any(child["to_world"]) \
                            if "to_world" in child else Transform()
                        child["to_world"] = inst_tw.matmul(child_tw)
                        b.add_shape(child)
        elif t in _EMITTER_TYPES:
            b.build_emitter(val)
    arrays, statics = b.finalize()
    if variant and "spectral" in str(variant):
        # the JAX builder's gate: the surface-path, volumetric and
        # polarized families
        if statics["integrator"] not in _SPECTRAL_INTEGRATORS:
            raise ValueError(
                "the spectral variant covers the surface-path, volumetric "
                f"and polarized families, not {statics['integrator']!r}")
        if statics["ssub.enabled"]:
            raise ValueError("the spectral variant does not support "
                             "subsurface shapes (RGB only)")
        statics["spectral"] = True
    return arrays, statics


def load_dict(d: Dict[str, Any], device="cuda", base_dir: str = ".",
              variant: str | None = None, flatten_instances: bool = False):
    """Build the port's Scene on `device` from a Mitsuba-style dict: the
    card unless the caller passes device="cpu".  Raises RuntimeError when
    asked for the card and there is none.  Relative file names resolve
    against base_dir.  variant "spectral" (or a top-level "variant" key)
    builds the hero-wavelength variant: the surface-path, volumetric and
    polarized families without subsurface shapes.  flatten_instances
    replicates each shapegroup's geometry per instance (the default
    shares one group-local stream, O(1) geometry memory in the instance
    count)."""
    import torch
    from ..bridge import scene_from_numpy
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_dict: no CUDA device; pass device='cpu' "
                           "to build the scene on the CPU")
    arrays, statics = build_numpy(d, base_dir, variant, flatten_instances)
    scene = scene_from_numpy(arrays, statics, device)
    if scene.ssub.has_dipole and DIPOLE_NORMALS in arrays:
        from ..ssub.dipole import compute_irradiance
        with torch.no_grad():
            E = compute_irradiance(scene, scene.ssub.dip_points,
                                   arrays[DIPOLE_NORMALS])
        scene = scene.replace(ssub=scene.ssub.replace(dip_irradiance=E))
    return scene
