"""Scene intermediate representation: plain dataclasses of tensors
(counterpart of liverrenderer_tpu/scene/ir.py).

The type codes below are copied verbatim from the JAX package: they are the
ABI both packages share, so a scene built by either loads into the other.
The tables keep only the fields and statics the slices ported so far read;
`bridge.scene_from_numpy` fills them from numpy arrays keyed by the JAX
Scene's dotted field paths.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..core.distr import DiscreteDistribution, Distribution2D
from ..ssub.vae import VAE

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

# triangles per block of the instance pass; group streams are zero-padded
# to a multiple of it (degenerate triangles never hit)
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

SSUB_VAE = 0
SSUB_DIPOLE = 1

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
# tabphase's density: this many constant bins over cos_theta, in the
# medium row from slot 16
TAB_BINS = 32


class _Table:
    """`.to(device)` and `.replace(**kw)` for a dataclass of tensors and
    nested tables; static (non-tensor) fields are kept as they are."""

    def to(self, device):
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (Tensor, _Table, DiscreteDistribution,
                              Distribution2D, torch.nn.Module)):
                kw[f.name] = v.to(device)
        return dataclasses.replace(self, **kw)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class Textures(_Table):
    """data rows: TEX_CONST rgb [0:3]; TEX_CHECKERBOARD color0 [0:3],
    color1 [3:6], uv scale [6:8], uv offset [8:10]; TEX_BITMAP uv scale
    [6:8], uv offset [8:10] and its bitmap in `bitmap_id`; TEX_MESHATTR
    and TEX_VOLUME scale [0:3] (a volume texture's grid in
    `bitmap_id`)."""
    ttype: Tensor      # (Tx,) texture type code
    data: Tensor       # (Tx, TEX_P)
    bitmap_id: Tensor  # (Tx,) bitmap index, -1 if none
    bitmaps: Tensor    # (K, H, W, 3) linear RGB, padded to a common size
    bitmap_hw: Tensor  # (K, 2) true (h, w) of each bitmap
    # (K, H, W, 12) [c00 c10 c01 c11] per texel, repeat wrap baked in: one
    # bilinear tap is one gather (filled when has_quads)
    quads: Tensor
    # the volume textures' grids (G, D, H, W, 3), padded to the largest,
    # their true (D, H, W) and world -> [0,1]^3 transforms; a volume
    # texture's bitmap_id indexes them
    vgrids: Tensor
    vgrid_whd: Tensor
    vgrid_to_local: Tensor
    has_quads: bool = False
    types_present: Tuple[int, ...] = (TEX_CONST,)


@dataclass
class BSDFs(_Table):
    """Param rows by type (the JAX builder's layout):
      DIFFUSE          tex0 = reflectance
      DIELECTRIC       p0 = eta (int/ext); tex0 = specular_reflectance,
      THINDIELECTRIC   tex1 = specular_transmittance
      ROUGHDIELECTRIC  + p6, p7 = alpha_u, alpha_v (GGX)
      CONDUCTOR        p0:3 = eta, p3:6 = k; tex0 = specular_reflectance
      ROUGHCONDUCTOR   + p6, p7 = alpha_u, alpha_v
      PLASTIC          p0 = eta, p1 = nonlinear, p2 = fdr_int, p3 =
      (ROUGH/P)PLASTIC fdr_ext, p4 = specular sampling weight, p6, p7 =
                       alpha_u, alpha_v; tex0 = diffuse_reflectance
      MASK             tex0 = opacity, inner = the nested BSDF
      BLEND            tex0 = weight, inner / inner2 = the nested BSDFs
      PRINCIPLEDTHIN   p0 = eta, p1 = roughness, p2 = spec_trans, p3 =
                       diff_trans / 2; tex0 = base_color
      PRINCIPLED       p0 = metallic, p1 = roughness, p2 = eta, p3 =
                       clearcoat, p4 = clearcoat_gloss, p5 = anisotropic,
                       p6 = sheen, p7 = sheen_tint, p8 = spec_trans, p9 =
                       flatness, p10 = spec_tint; tex0 = base_color
      MEASURED         tex0 = white (the Scene's measured table)
    """
    btype: Tensor      # (B,)
    params: Tensor     # (B, BSDF_P)
    tex0: Tensor       # (B,) texture index (-1 => white)
    tex1: Tensor       # (B,)
    inner: Tensor      # (B,) nested BSDF of a mask / blend, -1 otherwise
    inner2: Tensor     # (B,) second nested BSDF of a blend
    flags: Tensor      # (B,) BSDF flag bits
    twosided: Tensor   # (B,) bool
    types_present: Tuple[int, ...] = (BSDF_DIFFUSE,)
    tex0_types: Tuple[int, ...] = (TEX_CONST,)
    tex1_types: Tuple[int, ...] = (TEX_CONST,)


@dataclass
class Emitters(_Table):
    """params rows: AREA p0:3 radiance (times the tex0 texture), POINT p0:3
    position and p3:6 intensity, CONSTANT p0:3 radiance, ENVMAP p6 scale
    (its lat-long bitmap through tex0, its orientation in to_world)."""
    etype: Tensor      # (E,)
    params: Tensor     # (E, EMITTER_P)
    shape: Tensor      # (E,) owning shape of an area emitter, -1 else
    tex0: Tensor       # (E,) radiance texture (-1 => white)
    to_world: Tensor   # (E, 4, 4) envmap orientation (identity for others)
    distr: DiscreteDistribution   # emitter selection (uniform)
    # the envmap's importance map (a 1x1 placeholder without one)
    env_distr: Distribution2D
    env_index: int = -1
    types_present: Tuple[int, ...] = ()
    count: int = 0


@dataclass
class Media(_Table):
    """params row layout (MEDIUM_P floats): [0:3] sigma_t, [3:6] albedo,
    [6] scale, [7] phase g, [8] phase type, [10] HETEROGENEOUS majorant
    (the grid's maximum), glisson layers [12:40], LIVER parenchyma block
    blood [40:43], bile [43:46], hepatocity [46], lipid_water [48:51];
    the extended phases' parameters: blendphase weight [11], child types
    and g's [12:16]; tabphase's 32 bins [16:48]; sggx's S entries [16:22]
    (see scene/builder.py)."""
    mtype: Tensor      # (M,)
    params: Tensor     # (M, MEDIUM_P)
    grid_id: Tensor    # (M,) density grid of a heterogeneous medium, -1 none
    grids: Tensor      # (G, D, H, W, 4) density grids, padded to the largest
    grid_whd: Tensor   # (G, 3) each grid's true (D, H, W)
    grid_to_local: Tensor  # (G, 4, 4) world -> grid-local [0,1]^3
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
    """Camera or measurement sensor (the JAX Sensor's fields).  bsphere:
    the scene's bounding sphere (cx, cy, cz, r), over which a distant
    sensor spreads its origins, or above `target` when has_target;
    batch_*: the batch sensor's stacked child cameras; target_shape: the
    irradiancemeter's parent shape."""
    to_world: Tensor         # (4,4) camera-to-world
    fov_x: Tensor            # () x field of view, degrees
    near_clip: Tensor        # ()
    far_clip: Tensor         # ()
    aperture_radius: Tensor  # () thinlens
    focus_distance: Tensor   # () thinlens
    bsphere: Tensor          # (4,)
    target: Tensor           # (3,)
    batch_to_world: Tensor   # (S, 4, 4)
    batch_fov_x: Tensor      # (S,)
    stype: int = SENSOR_PERSPECTIVE
    has_target: bool = False
    target_shape: int = -1
    batch_count: int = 1


@dataclass
class SubsurfaceTable(_Table):
    """BSSRDF table (vaescatter and dipole).

    params rows: sigma_t [0:3], albedo [3:6], g [6], eta [7]; ss_type: the
    SSUB_ code of each row.  poly: per-vertex, per-RGB-channel degree-3
    world-space polynomial coefficients (V, 3, 20), fitted at build time
    (ssub/preprocess.py); weights: the VAE (None when no vaescatter shape
    renders with it).  dip_*: the dipole's irradiance point cloud, padded
    with zero-area points to a multiple of dipole.CHUNK; dip_consts packs
    (zr[3], zv[3], sigma_tr[3], eta)."""
    params: Tensor          # (Ns, 8)
    poly: Tensor            # (V, 3, 20)
    ss_type: Tensor         # (Ns,)
    dip_points: Tensor      # (P, 3)
    dip_irradiance: Tensor  # (P, 3)
    dip_area: Tensor        # (P,)
    dip_consts: Tensor      # (10,)
    weights: Optional[VAE] = None
    kernel_eps_scale: float = 1.0
    enabled: bool = False
    has_vae: bool = False
    has_dipole: bool = False


@dataclass
class VolPrims(_Table):
    """Volumetric (Gaussian-splat) primitives of the radiance-field
    integrator (reference ellipsoids shapes and volprim_rf_basic.py).
    Each ellipsoid row carries the 3DGS parameters; tri_ell maps every
    triangle of the instanced-icosphere tessellation back to its
    ellipsoid (-1: not a splat)."""
    center: Tensor    # (N, 3)
    scale: Tensor     # (N, 3)
    rot: Tensor       # (N, 3, 3) from the quaternion
    opacity: Tensor   # (N,)
    sh: Tensor        # (N, K, 3) SH coefficients, K = (deg + 1)^2
    tri_ell: Tensor   # (T,) triangle -> ellipsoid, -1 none
    count: int = 0
    sh_degree: int = 0
    srgb: bool = True


@dataclass
class MeasuredTable(_Table):
    """The RGL measured material's tables (bsdf/measured.py): the slices'
    incidence angles, the vndf and luminance warps (row CDF (S, H+1),
    conditional CDF (S, H, W+1), texel pdf (S, H, W)), the RGB spectra
    (S, 3, H, W), ndf and sigma (H, W).  One material per scene; a 1-2
    texel placeholder when there is none."""
    theta_i: Tensor
    vndf_row: Tensor
    vndf_cond: Tensor
    vndf_pdf: Tensor
    lum_row: Tensor
    lum_cond: Tensor
    lum_pdf: Tensor
    spectra: Tensor
    ndf: Tensor
    sigma: Tensor
    jacobian: bool = False
    enabled: bool = False


@dataclass
class Scene(_Table):
    # geometry (world space)
    vertices: Tensor         # (V,3)
    faces: Tensor            # (T,3)
    normals: Tensor          # (V,3) vertex normals
    tri_shape: Tensor        # (T,) owning shape of each triangle
    sph_center: Tensor       # (Sp,3)
    sph_radius: Tensor       # (Sp,)
    sph_shape: Tensor        # (Sp,)
    # shape table (S,)
    shape_bsdf: Tensor
    shape_emitter: Tensor     # (S,) attached area emitter, -1 none
    shape_int_medium: Tensor
    shape_ext_medium: Tensor
    shape_bump_tex: Tensor    # (S,) bump / normal-map texture, -1 none
    shape_bump_scale: Tensor  # (S,) > 0 height map, < 0 normal map
    shape_subsurface: Tensor  # (S,) subsurface row, -1 none
    shape_type: Tensor        # (S,) SHAPE_MESH / SHAPE_SPHERE
    shape_prim_offset: Tensor  # (S,) first triangle or sphere index
    shape_prim_count: Tensor  # (S,)
    shape_area: Tensor        # (S,) total surface area
    # (T,) global cumulative triangle areas (area-emitter triangle picks)
    tri_area_cdf: Tensor
    # packed (Tpad, 16) Baldwin-Weber rows in BVH-leaf order, (Tpad/128, 8)
    # chunk AABBs, kernel row -> original id, (3,) local-frame origin
    tri_buf: Tensor
    tri_boxes: Tensor
    tri_kperm: Tensor
    tri_center: Tensor
    # (T, 25) per-triangle interaction row: p0 e1 e2 n0 n1 n2 uv0 uv1 uv2
    # shape
    tri_si: Tensor
    # per-vertex fiber tangents of curve tubes and per-vertex rgb
    # attributes of mesh_attribute textures ((1, 3) zeros when unused)
    tangents: Tensor
    vertex_attrs: Tensor
    # instanced shapegroups (shapegroup.cpp / instance.cpp): each group's
    # triangles once, in group-local space, padded to INST_CHUNK rows;
    # inst_tris (Tg, 3, 3) local p0 p1 p2, inst_si (Tg, 25) local rows p0
    # p1 p2 n0 n1 n2 uv0 uv1 uv2 shape; per instance inst_xf (I, 21) the
    # to-world 3x4 [0:12] and the inverse transpose 3x3 [12:21] (row
    # major), the group's first row and chunk count, and its world box
    inst_tris: Tensor
    inst_si: Tensor
    inst_xf: Tensor
    inst_face_start: Tensor
    inst_n_chunks: Tensor
    inst_bmin: Tensor
    inst_bmax: Tensor
    # SDF grid shapes (sdfgrid.cpp): (K, D, H, W) distances on a [0,1]^3
    # local grid (padded with 1e9), (K, 3) true (W, H, D), (K, 4, 4) world
    # -> local, (K,) owning shape
    sdf_grids: Tensor
    sdf_whd: Tensor
    sdf_to_local: Tensor
    sdf_shape: Tensor
    bsdfs: BSDFs
    emitters: Emitters
    textures: Textures
    media: Media
    bvh: BVH
    sensor: Sensor
    ssub: SubsurfaceTable
    volprims: VolPrims
    measured: MeasuredTable
    # static config
    n_shapes: int = 0
    n_tris: int = 0
    n_spheres: int = 0
    n_sdfs: int = 0
    n_instances: int = 0
    # the group streams' padded row count and the largest group's chunks
    n_inst_tris: int = 0
    inst_max_chunks: int = 0
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
    # which perturbation families exist (the bump scale's sign tells them)
    has_heightmap: bool = False
    has_normalmap: bool = False
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
          (Textures, BSDFs, Emitters, Media, BVH, Sensor, SubsurfaceTable,
           VolPrims, MeasuredTable, DiscreteDistribution, Distribution2D)}
