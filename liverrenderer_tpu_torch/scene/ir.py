"""Scene intermediate representation: plain dataclasses of tensors
(counterpart of liverrenderer_tpu/scene/ir.py).

The type codes below are copied verbatim from the JAX package: they are the
ABI both packages share, so a scene built by either loads into the other.
The tables keep only the fields and statics the primal liver slice reads;
`bridge.scene_from_numpy` fills them from numpy arrays keyed by the JAX
Scene's dotted field paths.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# Type codes (stable ABI between builder and kernels)
# ---------------------------------------------------------------------------
BSDF_DIFFUSE = 0
BSDF_DIELECTRIC = 1
BSDF_THINDIELECTRIC = 2
BSDF_CONDUCTOR = 3
BSDF_ROUGHCONDUCTOR = 4
BSDF_PLASTIC = 5
BSDF_NULL = 6
BSDF_ROUGHDIELECTRIC = 7
BSDF_ROUGHPLASTIC = 8
BSDF_BLEND = 9
BSDF_MASK = 10
BSDF_PRINCIPLED = 11
BSDF_HAIR = 12
BSDF_POLARIZER = 13
BSDF_RETARDER = 14
BSDF_CIRCULAR = 15
BSDF_MEASURED = 16
BSDF_PPLASTIC = 17
BSDF_PRINCIPLEDTHIN = 18

EMITTER_AREA = 0
EMITTER_POINT = 1
EMITTER_CONSTANT = 2
EMITTER_ENVMAP = 3
EMITTER_DIRECTIONAL = 4
EMITTER_SPOT = 5
EMITTER_PROJECTOR = 6

TEX_CONST = 0
TEX_BITMAP = 1
TEX_CHECKERBOARD = 2
TEX_MESHATTR = 3
TEX_VOLUME = 4

MEDIUM_HOMOGENEOUS = 0
MEDIUM_HETEROGENEOUS = 1
MEDIUM_GLISSON = 2
MEDIUM_PARENCHYMA = 3
MEDIUM_LIVER = 4

PHASE_ISOTROPIC = 0
PHASE_HG = 1
PHASE_RAYLEIGH = 2
PHASE_BLEND = 3
PHASE_TAB = 4
PHASE_SGGX = 5

SHAPE_MESH = 0
SHAPE_SPHERE = 1
SHAPE_SDF = 2

INST_CHUNK = 128

FILTER_BOX = 0
FILTER_GAUSSIAN = 1
FILTER_TENT = 2
FILTER_MITCHELL = 3
FILTER_CATMULLROM = 4
FILTER_LANCZOS = 5

SENSOR_PERSPECTIVE = 0
SENSOR_THINLENS = 1
SENSOR_ORTHOGRAPHIC = 2
SENSOR_DISTANT = 3
SENSOR_RADIANCEMETER = 4
SENSOR_IRRADIANCEMETER = 5
SENSOR_BATCH = 6

# BSDF flag bits
F_NULL = 1 << 0
F_DIFFUSE_REFL = 1 << 1
F_GLOSSY_REFL = 1 << 2
F_GLOSSY_TRANS = 1 << 3
F_DELTA_REFL = 1 << 4
F_DELTA_TRANS = 1 << 5
F_SMOOTH = F_DIFFUSE_REFL | F_GLOSSY_REFL | F_GLOSSY_TRANS
F_DELTA = F_DELTA_REFL | F_DELTA_TRANS | F_NULL

# parameter-row widths
BSDF_P = 12
EMITTER_P = 16
TEX_P = 10
MEDIUM_P = 52


class _Table:
    """`.to(device)` and `.replace(**kw)` for a dataclass of tensors and
    nested tables; static (non-tensor) fields are kept as they are."""

    def to(self, device):
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (Tensor, _Table)):
                kw[f.name] = v.to(device)
        return dataclasses.replace(self, **kw)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class Textures(_Table):
    ttype: Tensor      # (Tx,) texture type code
    data: Tensor       # (Tx, TEX_P) TEX_CONST rgb in [0:3]
    types_present: Tuple[int, ...] = (TEX_CONST,)


@dataclass
class BSDFs(_Table):
    btype: Tensor      # (B,)
    params: Tensor     # (B, BSDF_P)  DIELECTRIC: p0 = eta (int/ext)
    tex0: Tensor       # (B,) texture index (-1 => white)
    tex1: Tensor       # (B,)
    flags: Tensor      # (B,) BSDF flag bits
    twosided: Tensor   # (B,) bool
    types_present: Tuple[int, ...] = (BSDF_DIFFUSE,)
    tex0_types: Tuple[int, ...] = (TEX_CONST,)
    tex1_types: Tuple[int, ...] = (TEX_CONST,)


@dataclass
class Emitters(_Table):
    etype: Tensor      # (E,)
    params: Tensor     # (E, EMITTER_P)  CONSTANT: p0:3 radiance
    env_index: int = -1
    types_present: Tuple[int, ...] = ()
    count: int = 0


@dataclass
class Media(_Table):
    """params row layout (MEDIUM_P floats): [0:3] sigma_t, [3:6] albedo,
    [6] scale, [7] phase g, [8] phase type, glisson layers [12:40],
    LIVER parenchyma block blood [40:43], bile [43:46], hepatocity [46],
    lipid_water [48:51] (see scene/builder.py)."""
    mtype: Tensor      # (M,)
    params: Tensor     # (M, MEDIUM_P)
    types_present: Tuple[int, ...] = ()
    phase_types: Tuple[int, ...] = (0,)
    count: int = 0


@dataclass
class BVH(_Table):
    """Flattened 2-wide BVH (accel/bvh.py layout).  The slice reads only
    `perm`, through the packed triangle buffer's leaf order."""
    node_min: Tensor
    node_max: Tensor
    right: Tensor
    first: Tensor
    count: Tensor
    perm: Tensor
    depth: int = 32


@dataclass
class Sensor(_Table):
    to_world: Tensor   # (4,4) camera-to-world
    fov_x: Tensor      # () x field of view, degrees
    stype: int = SENSOR_PERSPECTIVE


@dataclass
class Scene(_Table):
    # geometry (world space)
    vertices: Tensor         # (V,3)
    faces: Tensor            # (T,3)
    sph_center: Tensor       # (Sp,3)
    sph_radius: Tensor       # (Sp,)
    sph_shape: Tensor        # (Sp,)
    # shape table (S,)
    shape_bsdf: Tensor
    shape_int_medium: Tensor
    shape_ext_medium: Tensor
    # packed (Tpad, 16) Baldwin-Weber rows in BVH-leaf order, (Tpad/128, 8)
    # chunk AABBs, kernel row -> original id, (3,) local-frame origin
    tri_buf: Tensor
    tri_boxes: Tensor
    tri_kperm: Tensor
    tri_center: Tensor
    # (T, 25) per-triangle interaction row: p0 e1 e2 n0 n1 n2 uv0 uv1 uv2
    # shape
    tri_si: Tensor
    bsdfs: BSDFs
    emitters: Emitters
    textures: Textures
    media: Media
    bvh: BVH
    sensor: Sensor
    # static config
    n_shapes: int = 0
    n_tris: int = 0
    n_spheres: int = 0
    n_sdfs: int = 0
    n_instances: int = 0
    film_w: int = 256
    film_h: int = 256
    rfilter: int = FILTER_GAUSSIAN
    spp: int = 64
    sampler_kind: str = "independent"
    integrator: str = "path"
    max_depth: int = 8
    rr_depth: int = 5
    hide_emitters: bool = False
    camera_medium: int = -1
    intersector: str = "auto"
    has_bump: bool = False
    has_tangents: bool = False
    has_vertex_attr: bool = False
    ray_sort: bool = False
    needs_surface_nee: bool = True
    needs_medium_nee: bool = True
    spectral: bool = False

    @property
    def device(self) -> torch.device:
        return self.tri_si.device


# sub-table classes by the annotation their Scene field carries
TABLES = {cls.__name__: cls for cls in
          (Textures, BSDFs, Emitters, Media, BVH, Sensor)}
