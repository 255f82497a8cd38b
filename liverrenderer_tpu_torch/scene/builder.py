"""Scene builder: Mitsuba-style dict -> the port's Scene (counterpart of
liverrenderer_tpu/scene/builder.py), cut to the plugins of the primal liver
slice:

  integrators  biovolpath, volpath
  sensor       perspective (to_world, fov, fov_axis), hdrfilm with a box
               or tent filter, the independent sampler
  shapes       mesh, rectangle, sphere (analytic)
  bsdfs        dielectric, null
  media        liver, homogeneous (isotropic or HG phase)
  emitters     constant

Entities are packed host-side into the same numpy tables, in the same
order, as the JAX builder packs them; `bridge.scene_from_numpy` uploads
them.  Any other plugin raises NotImplementedError naming the ROADMAP item
that brings it.  No XML: that is the port's own loader (ROADMAP M9).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..accel.bvh import build_bvh
from ..accel.cuda_intersect import pack_tris
from ..errors import not_ported
from . import geometry as geo
from .ir import (BSDF_DIELECTRIC, BSDF_NULL, BSDF_P, EMITTER_CONSTANT,
                 EMITTER_P, F_DELTA_REFL, F_DELTA_TRANS, F_NULL, F_SMOOTH,
                 FILTER_BOX, FILTER_TENT, MEDIUM_GLISSON, MEDIUM_HOMOGENEOUS,
                 MEDIUM_LIVER, MEDIUM_P, PHASE_HG, PHASE_ISOTROPIC,
                 SENSOR_PERSPECTIVE, TEX_CONST, TEX_P)
from .transform import Transform, from_any

IOR_NAMES = {
    "vacuum": 1.0, "air": 1.000277, "water": 1.3330, "water ice": 1.31,
    "glass": 1.5046, "bk7": 1.5046, "fused quartz": 1.458, "pyrex": 1.470,
    "acrylic glass": 1.49, "polypropylene": 1.49, "diamond": 2.419,
    "ethanol": 1.361, "benzene": 1.501, "silicone oil": 1.52045,
    "bromine": 1.661, "amber": 1.55,
}

_INTEGRATORS = ("biovolpath", "volpath")
_SHAPE_TYPES = ("mesh", "rectangle", "sphere")
_BSDF_TYPES = ("dielectric", "null")
_MEDIUM_TYPES = ("liver", "homogeneous")
_EMITTER_TYPES = ("constant",)
# plugin names of the JAX builder that the port does not carry yet
_OTHER_TYPES = {
    "path": "Queue 1 M8", "direct": "Queue 1 M8", "volpathmis": "Queue 1 M10",
    "biovolpath06": "Queue 1 M10", "prb": "Queue 1 M7",
    "prbvolpath": "Queue 1 M7", "prb_basic": "Queue 1 M7",
    "aov": "Queue 1 M10", "depth": "Queue 1 M10", "moment": "Queue 1 M10",
    "ptracer": "Queue 1 M10", "stokes": "Queue 1 M10",
    "volprim_rf_basic": "Queue 1 M10",
    "thinlens": "Queue 1 M10", "orthographic": "Queue 1 M10",
    "distant": "Queue 1 M10", "radiancemeter": "Queue 1 M10",
    "irradiancemeter": "Queue 1 M10", "batch": "Queue 1 M10",
    "cube": "Queue 1 M9", "disk": "Queue 1 M9", "cylinder": "Queue 1 M9",
    "obj": "Queue 1 M9", "ply": "Queue 1 M9", "serialized": "Queue 1 M9",
    "linearcurve": "Queue 1 M10", "bsplinecurve": "Queue 1 M10",
    "sdfgrid": "Queue 1 M10", "blender": "Queue 1 M9",
    "ellipsoids": "Queue 1 M10", "ellipsoidsmesh": "Queue 1 M10",
    "merge": "Queue 1 M9", "instance": "Queue 1 M10",
    "shapegroup": "Queue 1 M10",
    "diffuse": "Queue 1 (emitters with NEE)",
    "bumpmap": "Queue 1 (bumpmap + envmap)",
    "normalmap": "Queue 1 (bumpmap + envmap)",
    "envmap": "Queue 1 (bumpmap + envmap)",
    "area": "Queue 1 (emitters with NEE)",
    "point": "Queue 1 (emitters with NEE)",
    "heterogeneous": "Queue 1 M10", "glissonCapsule": "Queue 1 M10",
    "glisson": "Queue 1 M10", "parenchyma": "Queue 1 M10",
    "bitmap": "Queue 1 (bumpmap + envmap)", "checkerboard": "Queue 1 M5",
    "vaescatter": "Queue 1 M10", "dipole": "Queue 1 M10",
}
for _t in ("thindielectric", "conductor", "roughconductor", "plastic",
           "roughplastic", "pplastic", "principled", "principledthin",
           "mask", "blendbsdf", "twosided", "roughdielectric", "hair",
           "polarizer", "retarder", "circular", "measured"):
    _OTHER_TYPES[_t] = "Queue 1 M5/M10"
for _t in ("directional", "spot", "directionalarea", "projector", "sunsky",
           "sun", "sky", "timed_sunsky"):
    _OTHER_TYPES[_t] = "Queue 1 (emitters with NEE)"


def _unsupported(t):
    return not_ported(f"the {t!r} plugin", _OTHER_TYPES.get(t, "Queue 1"))


def _spectrum_to_rgb(val, default=1.0) -> np.ndarray:
    """A dict 'spectrum-ish' value as linear RGB (rgb / scalar / list)."""
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
        raise not_ported(f"the {t!r} spectrum", "Queue 1 M10")
    raise ValueError(f"cannot interpret spectrum {val!r}")


def _ior(val, default) -> float:
    if val is None:
        return default
    if isinstance(val, str):
        return IOR_NAMES[val.lower()]
    return float(val)


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


def _pack_liver_parenchyma(p: np.ndarray, d: dict):
    """LIVER parenchyma block: blood 40:43, bile 43:46, hepatocity 46,
    lipid_water 48:51 (slots 3:6 stay the medium albedo)."""
    p[40:43] = _spectrum_to_rgb(d.get("sigma_blood", 1.0), 1.0)
    p[43:46] = _spectrum_to_rgb(d.get("sigma_bile", 1.0), 1.0)
    p[46] = float(_spectrum_to_rgb(d.get("sigma_hepatocity", 1.0), 1.0)[0])
    p[48:51] = _spectrum_to_rgb(d.get("sigma_lipid_water", 1.0), 1.0)


class _Builder:
    def __init__(self):
        self.tex_type: List[int] = []
        self.tex_data: List[np.ndarray] = []
        self.b_type: List[int] = []
        self.b_params: List[np.ndarray] = []
        self.b_tex0: List[int] = []
        self.b_tex1: List[int] = []
        self.b_flags: List[int] = []
        self.b_twosided: List[bool] = []
        self.e_type: List[int] = []
        self.e_params: List[np.ndarray] = []
        self.env_index = -1
        self.m_type: List[int] = []
        self.m_params: List[np.ndarray] = []
        self.vertices: List[np.ndarray] = []
        self.faces: List[np.ndarray] = []
        self.normals: List[np.ndarray] = []
        self.uvs: List[np.ndarray] = []
        self.tri_shape: List[np.ndarray] = []
        self.v_count = 0
        self.sph_center: List[np.ndarray] = []
        self.sph_radius: List[float] = []
        self.sph_shape: List[int] = []
        self.s_bsdf: List[int] = []
        self.s_int_med: List[int] = []
        self.s_ext_med: List[int] = []
        self.named: Dict[str, tuple] = {}
        self.sensor_to_world = np.eye(4, dtype=np.float32)
        self.fov_x = 45.0
        self.film_w = 256
        self.film_h = 256
        self.rfilter = FILTER_BOX
        self.spp = 16
        self.sampler_kind = "independent"
        self.integrator = "path"
        self.max_depth = 8
        self.rr_depth = 5
        self.hide_emitters = False
        self.camera_medium = -1

    # --- textures ---------------------------------------------------------
    def build_texture(self, d, default=1.0) -> int:
        if isinstance(d, dict) and d.get("type") not in (
                "rgb", "uniform", "d65", "rawconstant"):
            raise _unsupported(d.get("type"))
        data = np.zeros(TEX_P, np.float32)
        data[0:3] = _spectrum_to_rgb(d, default)
        self.tex_type.append(TEX_CONST)
        self.tex_data.append(data)
        return len(self.tex_type) - 1

    # --- bsdfs ------------------------------------------------------------
    def _push_bsdf(self, btype, params, tex0=-1, tex1=-1, flags=0,
                   twosided=False) -> int:
        self.b_type.append(btype)
        self.b_params.append(params)
        self.b_tex0.append(tex0)
        self.b_tex1.append(tex1)
        self.b_flags.append(flags)
        self.b_twosided.append(twosided)
        return len(self.b_type) - 1

    def build_bsdf(self, d) -> int:
        if d is None:
            # the JAX builder gives such a shape the default diffuse BSDF
            raise not_ported("a shape without a BSDF (default diffuse)",
                             "Queue 1 (emitters with NEE)")
        if d.get("type") == "ref":
            kind, idx = self.named[d["id"]]
            if kind != "bsdf":
                raise ValueError(f"{d['id']!r} is a {kind}, not a bsdf")
            return idx
        t = d["type"]
        p = np.zeros(BSDF_P, np.float32)
        if t == "dielectric":
            p[0] = _ior(d.get("int_ior"), 1.5046) \
                / _ior(d.get("ext_ior"), 1.000277)
            tex0 = self.build_texture(d.get("specular_reflectance", 1.0), 1.0)
            tex1 = self.build_texture(d.get("specular_transmittance", 1.0),
                                      1.0)
            return self._push_bsdf(BSDF_DIELECTRIC, p, tex0=tex0, tex1=tex1,
                                   flags=F_DELTA_REFL | F_DELTA_TRANS)
        if t == "null":
            return self._push_bsdf(BSDF_NULL, p, flags=F_NULL, twosided=True)
        raise _unsupported(t)

    # --- media ------------------------------------------------------------
    def build_medium(self, d) -> int:
        if d is None:
            return -1
        if d.get("type") == "ref":
            kind, idx = self.named[d["id"]]
            if kind != "medium":
                raise ValueError(f"{d['id']!r} is a {kind}, not a medium")
            return idx
        t = d["type"]
        if t not in _MEDIUM_TYPES:
            raise _unsupported(t)
        p = np.zeros(MEDIUM_P, np.float32)
        st_v = d.get("sigma_t", 1.0)
        if isinstance(st_v, dict) and st_v.get("type") == "gridvolume":
            raise _unsupported("heterogeneous")
        p[0:3] = _spectrum_to_rgb(st_v, 1.0)
        p[3:6] = _spectrum_to_rgb(d.get("albedo", 0.75), 0.75)
        p[6] = float(d.get("scale", 1.0))
        p[8] = PHASE_ISOTROPIC
        phase = d.get("phase")
        if isinstance(phase, dict):
            pt = phase["type"]
            if pt == "hg":
                p[8] = PHASE_HG
                p[7] = float(phase.get("g", 0.8))
            elif pt != "isotropic":
                raise not_ported(f"the {pt!r} phase function", "Queue 1 M10")
        p[9] = 1.0 if d.get("has_spectral_extinction", True) else 0.0
        if t == "homogeneous":
            mtype = MEDIUM_HOMOGENEOUS
        else:
            mtype = MEDIUM_LIVER
            _pack_glisson(p, d)
            _pack_liver_parenchyma(p, d)
        self.m_type.append(mtype)
        self.m_params.append(p)
        return len(self.m_type) - 1

    # --- emitters ---------------------------------------------------------
    def build_emitter(self, d) -> int:
        t = d["type"]
        if t != "constant":
            raise _unsupported(t)
        p = np.zeros(EMITTER_P, np.float32)
        p[0:3] = _spectrum_to_rgb(d.get("radiance", 1.0), 1.0)
        self.e_type.append(EMITTER_CONSTANT)
        self.e_params.append(p)
        self.env_index = len(self.e_type) - 1
        return self.env_index

    # --- shapes -------------------------------------------------------------
    def add_shape(self, d):
        t = d["type"]
        to_w = from_any(d["to_world"]) if "to_world" in d else Transform()
        bsdf_d = None
        int_med = ext_med = -1
        for k, v in d.items():
            if not isinstance(v, dict):
                continue
            vt = v.get("type")
            if k == "emitter" or vt == "area":
                raise _unsupported("area")
            if k == "interior":
                int_med = self.build_medium(v)
            elif k == "exterior":
                ext_med = self.build_medium(v)
            elif vt == "ref":
                if self.named.get(v["id"], ("bsdf",))[0] == "bsdf":
                    bsdf_d = v
            elif k == "bsdf" or vt in _BSDF_TYPES:
                bsdf_d = v
            elif vt in _OTHER_TYPES or k in ("subsurface", "sensor"):
                raise _unsupported(vt)
        bsdf_idx = self.build_bsdf(bsdf_d)
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
        else:
            if t == "rectangle":
                mesh = geo.rectangle()
            else:
                mesh = geo.MeshData(d["vertices"], d["faces"],
                                    d.get("normals"), d.get("uvs"))
            mesh = mesh.transformed(to_w)
            if mesh.normals is None:
                mesh.normals = geo.compute_vertex_normals(mesh.vertices,
                                                          mesh.faces)
            if d.get("flip_normals", False):
                mesh.normals = -mesh.normals
                mesh.faces = mesh.faces[:, ::-1].copy()
            if mesh.uvs is None:
                mesh.uvs = np.zeros((len(mesh.vertices), 2), np.float32)
            self.vertices.append(mesh.vertices)
            self.faces.append(mesh.faces + self.v_count)
            self.normals.append(mesh.normals)
            self.uvs.append(mesh.uvs)
            self.tri_shape.append(
                np.full(len(mesh.faces), shape_idx, np.int32))
            self.v_count += len(mesh.vertices)
        self.s_bsdf.append(bsdf_idx)
        self.s_int_med.append(int_med)
        self.s_ext_med.append(ext_med)

    # --- sensor / film ------------------------------------------------------
    def build_sensor(self, d):
        if d.get("type", "perspective") != "perspective":
            raise _unsupported(d.get("type"))
        to_w = d.get("to_world")
        if to_w is not None:
            self.sensor_to_world = from_any(to_w).matrix.astype(np.float32)
        fov = float(d.get("fov", 45.0))
        axis = d.get("fov_axis", "x")
        film = d.get("film", {})
        self.film_w = int(film.get("width", 256))
        self.film_h = int(film.get("height", 256))
        rf = film.get("rfilter", {})
        rft = rf.get("type", "gaussian") if isinstance(rf, dict) else rf
        if rft not in ("box", "tent"):
            raise not_ported(f"the {rft!r} reconstruction filter",
                             "Queue 1 M3")
        self.rfilter = FILTER_BOX if rft == "box" else FILTER_TENT
        sampler = d.get("sampler", {})
        self.spp = int(sampler.get("sample_count", 16))
        self.sampler_kind = sampler.get("type", "independent")
        if self.sampler_kind != "independent":
            raise not_ported(f"the {self.sampler_kind!r} sampler",
                             "Queue 1 M2")
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
    def finalize(self):
        """(arrays, statics) under the JAX Scene's dotted field paths."""
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
        v0, v1, v2 = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
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

        n_s = len(self.s_bsdf)
        i32 = np.int32
        arrays = {
            "vertices": V.astype(np.float32), "faces": F,
            "sph_center": (np.stack(self.sph_center) if self.sph_center
                           else np.zeros((1, 3))).astype(np.float32),
            "sph_radius": np.asarray(self.sph_radius or [1.0], np.float32),
            "sph_shape": np.asarray(self.sph_shape or [-1], i32),
            "shape_bsdf": np.asarray(self.s_bsdf or [0], i32),
            "shape_int_medium": np.asarray(self.s_int_med or [-1], i32),
            "shape_ext_medium": np.asarray(self.s_ext_med or [-1], i32),
            "tri_buf": tri_buf, "tri_boxes": boxes, "tri_kperm": kperm,
            "tri_center": center, "tri_si": tri_si,
            "textures.ttype": np.asarray(self.tex_type or [0], i32),
            "textures.data": (np.stack(self.tex_data) if self.tex_data
                              else np.zeros((1, TEX_P))).astype(np.float32),
            "bsdfs.btype": np.asarray(self.b_type or [0], i32),
            "bsdfs.params": (np.stack(self.b_params) if self.b_params
                             else np.zeros((1, BSDF_P))).astype(np.float32),
            "bsdfs.tex0": np.asarray(self.b_tex0 or [-1], i32),
            "bsdfs.tex1": np.asarray(self.b_tex1 or [-1], i32),
            "bsdfs.flags": np.asarray(self.b_flags or [0], np.uint32),
            "bsdfs.twosided": np.asarray(self.b_twosided or [False]),
            "emitters.etype": np.asarray(self.e_type or [0], i32),
            "emitters.params": (np.stack(self.e_params) if self.e_params
                                else np.zeros((1, EMITTER_P))
                                ).astype(np.float32),
            "media.mtype": np.asarray(self.m_type or [0], i32),
            "media.params": (np.stack(self.m_params) if self.m_params
                             else np.zeros((1, MEDIUM_P))).astype(np.float32),
            "bvh.node_min": bvh.node_min, "bvh.node_max": bvh.node_max,
            "bvh.right": bvh.right, "bvh.first": bvh.first,
            "bvh.count": bvh.count, "bvh.perm": bvh.perm,
            "sensor.to_world": self.sensor_to_world.astype(np.float32),
            "sensor.fov_x": np.asarray(self.fov_x, np.float32),
        }
        # static NEE reachability (as the JAX builder): surface NEE needs a
        # shape-referenced smooth BSDF, medium NEE a non-bio medium under
        # a stock volpath integrator
        used_media = {m for m in self.s_int_med + self.s_ext_med if m >= 0}
        statics = {
            "textures.types_present": tuple(sorted(set(self.tex_type)))
            or (TEX_CONST,),
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
            "sensor.stype": SENSOR_PERSPECTIVE,
            "n_shapes": n_s, "n_tris": T, "n_spheres": len(self.sph_radius),
            "film_w": self.film_w, "film_h": self.film_h,
            "rfilter": self.rfilter, "spp": self.spp,
            "sampler_kind": self.sampler_kind,
            "integrator": self.integrator, "max_depth": self.max_depth,
            "rr_depth": self.rr_depth, "hide_emitters": self.hide_emitters,
            "camera_medium": self.camera_medium,
            "needs_surface_nee": bool(self.e_type) and any(
                (self.b_flags[i] & F_SMOOTH) != 0 for i in set(self.s_bsdf)),
            "needs_medium_nee": bool(self.e_type)
            and self.integrator == "volpath"
            and any(self.m_type[m] < MEDIUM_GLISSON for m in used_media),
        }
        return arrays, statics


def build_numpy(d: Dict[str, Any]):
    """The scene dict packed into (arrays, statics) numpy tables."""
    if d.get("type") != "scene":
        raise ValueError("top-level dict must be a scene")
    if d.get("variant") and "spectral" in str(d["variant"]):
        raise not_ported("the spectral variant", "Queue 1 M10")
    b = _Builder()
    # pass 1: named non-shape resources (so refs resolve)
    for key, val in d.items():
        if not isinstance(val, dict):
            continue
        t = val.get("type")
        vid = val.get("id", key)
        if t in _BSDF_TYPES:
            idx = b.build_bsdf(val)
            b.named[vid] = b.named[key] = ("bsdf", idx)
        elif t in _MEDIUM_TYPES:
            idx = b.build_medium(val)
            b.named[vid] = b.named[key] = ("medium", idx)
        elif t in _OTHER_TYPES:
            raise _unsupported(t)
    # pass 2: integrator + sensor
    for val in d.values():
        if not isinstance(val, dict):
            continue
        t = val.get("type")
        if t in _INTEGRATORS:
            b.integrator = t
            b.max_depth = int(val.get("max_depth", 8))
            if b.max_depth < 0:
                b.max_depth = 64
            b.rr_depth = int(val.get("rr_depth", 5))
            b.hide_emitters = bool(val.get("hide_emitters", False))
        elif t == "perspective":
            b.build_sensor(val)
    # pass 3: shapes + standalone emitters
    for val in d.values():
        if not isinstance(val, dict):
            continue
        t = val.get("type")
        if t in _SHAPE_TYPES:
            b.add_shape(val)
        elif t in _EMITTER_TYPES:
            b.build_emitter(val)
    return b.finalize()


def load_dict(d: Dict[str, Any], device="cpu"):
    """Build the port's Scene on `device` from a Mitsuba-style dict."""
    from ..bridge import scene_from_numpy
    arrays, statics = build_numpy(d)
    return scene_from_numpy(arrays, statics, device)
