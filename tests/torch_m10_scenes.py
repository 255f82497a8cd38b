"""Scene dicts of the light tracer, polarized transport, the splat
radiance field, shape gradients and the principled, principledthin and
measured BSDFs (numpy and the port's Transform, no JAX), shared by the
port's CPU tests and chip_smoke.py.

Transforms are plain 4x4 matrices, so both packages' builders read the
same dicts.  The scenes are those of tests/test_polarization.py,
tests/test_volprim.py, tests/test_components.py, tests/test_projective.py,
tests/test_principled.py and tests/test_measured.py.
"""
import numpy as np

from liverrenderer_tpu_torch.scene.transform import Transform

C0 = 0.28209479177387814       # Y_0^0


def _look(origin, target):
    return Transform().look_at(origin, target, [0, 1, 0]).matrix.copy()


def _sensor(res, fov, origin, target, rfilter="box"):
    w, h = (res, res) if np.isscalar(res) else res
    return {"type": "perspective", "fov": fov,
            "to_world": _look(origin, target),
            "film": {"type": "hdrfilm", "width": w, "height": h,
                     "rfilter": {"type": rfilter}}}


def _white_env(radiance=1.0):
    return {"type": "constant",
            "radiance": {"type": "rgb", "value": [radiance] * 3}}


def stack_dict(elements, res=4, max_depth=8):
    """Camera at z = +3 looking down -z through transmissive elements
    (rectangles at decreasing z), then out to a white constant env."""
    d = {"type": "scene",
         "integrator": {"type": "stokes", "max_depth": max_depth},
         "sensor": _sensor(res, 10.0, [0, 0, 3], [0, 0, 0]),
         "env": _white_env()}
    for i, el in enumerate(elements):
        d[f"el{i}"] = {
            "type": "rectangle",
            "to_world": Transform().translate([0, 0, 2.0 - 0.5 * i])
            .matrix.copy(),
            "bsdf": el}
    return d


def gold_mirror_dict(res=8, max_depth=4, origin=(3, 0, 3)):
    """A smooth gold rectangle seen at 45 degrees under a white env
    (test_spectral_stokes_matches_rgb_fresnel)."""
    return {"type": "scene",
            "integrator": {"type": "stokes", "max_depth": max_depth},
            "sensor": _sensor(res, 20.0, list(origin), [0, 0, 0]),
            "mirror": {"type": "rectangle",
                       "to_world": Transform().scale(2.0).matrix.copy(),
                       "bsdf": {"type": "conductor", "material": "Au"}},
            "env": _white_env()}


def gold_floor_dict(res=8, max_depth=3):
    """A gold floor at ~55 degrees incidence under a white env
    (test_fresnel_reflection_partially_polarizes)."""
    return {"type": "scene",
            "integrator": {"type": "stokes", "max_depth": max_depth},
            "sensor": _sensor(res, 30.0, [0, 2.0, 2.8], [0, 0, 0]),
            "floor": {"type": "rectangle",
                      "to_world": Transform().rotate([1, 0, 0], -90)
                      .scale(4.0).matrix.copy(),
                      "bsdf": {"type": "conductor", "material": "au"}},
            "env": _white_env()}


def area_floor_dict(res=12, max_depth=3, integrator="stokes"):
    """A diffuse floor under a small area light
    (test_stokes_s0_matches_path_with_area_light)."""
    return {"type": "scene",
            "integrator": {"type": integrator, "max_depth": max_depth},
            "sensor": _sensor(res, 45, [0, 0, 4], [0, 0, 0]),
            "floor": {"type": "rectangle", "bsdf": {"type": "diffuse"}},
            "lamp": {"type": "rectangle",
                     "to_world": Transform().translate([0, 0, 3.0])
                     .scale(0.15).matrix.copy(),
                     "emitter": {"type": "area",
                                 "radiance": {"type": "rgb",
                                              "value": [40.0] * 3}}}}


def plane_light_dict(emitters, res=24):
    """test_components.py's diffuse plane under an infinite emitter."""
    d = {"type": "scene",
         "integrator": {"type": "path", "max_depth": 3},
         "sensor": _sensor(res, 45, [0, 0, 4], [0, 0, 0]),
         "floor": {"type": "rectangle",
                   "bsdf": {"type": "diffuse",
                            "reflectance": {"type": "rgb",
                                            "value": [0.6, 0.5, 0.4]}}}}
    d.update(emitters)
    return d


INFINITE_EMITTERS = {
    "constant": {"env": {"type": "constant",
                         "radiance": {"type": "rgb",
                                      "value": [0.8, 0.7, 0.9]}}},
    "directional": {"sun": {"type": "directional",
                            "direction": [0.3, -0.2, -1.0],
                            "irradiance": {"type": "rgb",
                                           "value": [2.0, 1.8, 1.5]}}},
}


def splat_rows(centers, sigma):
    """(N, 10) ellipsoid rows: centers, isotropic scale, identity
    quaternion (x, y, z, w)."""
    n = len(centers)
    rows = np.zeros((n, 10), np.float32)
    rows[:, 0:3] = centers
    rows[:, 3:6] = sigma
    rows[:, 9] = 1.0
    return rows


def splat_dict(rows, sh, opac, res=9, fov=10.0, cam_z=4.0, srgb=False,
               max_depth=16):
    """test_volprim.py's splat scene: ellipsoids seen down -z."""
    return {"type": "scene",
            "integrator": {"type": "volprim_rf_basic",
                           "max_depth": max_depth,
                           "srgb_primitives": srgb},
            "sensor": _sensor(res, fov, [0, 0, cam_z], [0, 0, 0]),
            "splats": {"type": "ellipsoids", "data": rows,
                       "opacities": opac, "sh_coeffs": sh}}


def three_splats(res=9, srgb=False, degree=1):
    """Three overlapping, rotated splats with view-dependent SH of
    `degree` (the gradient scene)."""
    rows = splat_rows([[0.0, 0.0, 0.6], [0.15, -0.1, 0.0],
                       [-0.1, 0.1, -0.6]], 0.35)
    rows[1, 3:6] = [0.5, 0.25, 0.3]
    rows[1, 6:10] = np.array([0.2, 0.3, 0.1, 0.93]) \
        / np.linalg.norm([0.2, 0.3, 0.1, 0.93])
    K = (degree + 1) ** 2
    sh = np.zeros((3, K, 3), np.float32)
    sh[:, 0] = np.array([[1.2, 0.6, 0.3], [0.4, 1.1, 0.5],
                         [0.6, 0.5, 1.4]]) / (2 * C0)
    if K > 1:
        sh[:, 1:] = np.linspace(-0.3, 0.3, 3 * (K - 1) * 3) \
            .reshape(3, K - 1, 3)
    return splat_dict(rows, sh, [0.7, 0.5, 0.6], res=res, fov=20.0,
                      srgb=srgb)


def splat_cloud(n, seed=0, res=(428, 240), degree=3, max_depth=64):
    """n seeded ellipsoids: centres in the unit ball, scales 0.01-0.05,
    random unit quaternions, opacities 0.05-0.95, SH of `degree`, seen
    from z = 3.5, srgb_primitives on (the plugin's default)."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(n, 3))
    c *= (rng.uniform(size=(n, 1)) ** (1 / 3)) \
        / np.linalg.norm(c, axis=1, keepdims=True)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rows = np.zeros((n, 10), np.float32)
    rows[:, 0:3] = c
    rows[:, 3:6] = rng.uniform(0.01, 0.05, (n, 3))
    rows[:, 6:10] = q
    K = (degree + 1) ** 2
    sh = rng.normal(0.0, 0.3, (n, K, 3)).astype(np.float32)
    sh[:, 0] += 0.5 / C0
    d = splat_dict(rows, sh, rng.uniform(0.05, 0.95, n).astype(np.float32),
                   res=res, fov=40.0, cam_z=3.5, srgb=True,
                   max_depth=max_depth)
    del d["integrator"]["srgb_primitives"]
    return d


# ---------------------------------------------------------------------------
# shape gradients (tests/test_projective.py's scenes)
# ---------------------------------------------------------------------------

def _dark_quad(to_world):
    return {"type": "rectangle", "to_world": to_world.matrix.copy(),
            "bsdf": {"type": "diffuse",
                     "reflectance": {"type": "rgb", "value": [0.02] * 3}}}


def occluder_dict(res=24):
    """A dark quad in front of a bright emissive plane, path depth 2."""
    return {"type": "scene",
            "integrator": {"type": "path", "max_depth": 2},
            "sensor": _sensor(res, 45.0, [0, 0, 2.0], [0, 0, 0]),
            "bg": {"type": "rectangle",
                   "to_world": Transform().translate([0, 0, -1.0])
                   .scale(3.0).matrix.copy(),
                   "emitter": {"type": "area",
                               "radiance": {"type": "rgb",
                                            "value": [4.0] * 3}}},
            "occ": _dark_quad(Transform().scale(0.4))}


def _rough_al(alpha):
    return {"type": "roughconductor", "material": "Al", "alpha": alpha}


def mirror_dict(res=24, alpha=0.1):
    """A dark quad behind the camera, seen only in a rough mirror against
    a bright constant environment, path depth 4."""
    return {"type": "scene",
            "integrator": {"type": "path", "max_depth": 4},
            "sensor": _sensor(res, 45.0, [0, 0, 2.0], [0, 0, -1.0]),
            "mirror": {"type": "rectangle",
                       "to_world": Transform().translate([0, 0, -1.0])
                       .scale(3.0).matrix.copy(),
                       "bsdf": _rough_al(alpha)},
            "occ": _dark_quad(Transform().translate([0, 0, 2.5]).scale(0.5)),
            "env": _white_env(2.0)}


def two_mirror_dict(res=24, alpha=0.08):
    """A dark quad seen only after two rough-mirror bounces, path depth
    5."""
    return {"type": "scene",
            "integrator": {"type": "path", "max_depth": 5},
            "sensor": _sensor(res, 45.0, [0, 0, 2.0], [0, 0, -1.0]),
            "mirrorA": {"type": "rectangle",
                        "to_world": Transform().translate([0, 0, -1.0])
                        .rotate([0, 1, 0], 45).scale(2.5).matrix.copy(),
                        "bsdf": _rough_al(alpha)},
            "mirrorB": {"type": "rectangle",
                        "to_world": Transform().translate([3.0, 0, -1.0])
                        .rotate([0, 1, 0], -45).scale(2.0).matrix.copy(),
                        "bsdf": _rough_al(alpha)},
            "occ": _dark_quad(Transform().translate([3.0, 0, 2.5])
                              .scale(0.4)),
            "env": _white_env(2.0)}


def right_edge_mask(V, z, x_min):
    """(mask (V, 3) moving +x the vertices on the plane z with x > x_min,
    their count): an occluder's right edge."""
    sel = (np.abs(V[:, 2] - z) < 1e-4) & (V[:, 0] > x_min)
    mask = np.zeros_like(V)
    mask[sel, 0] = 1.0
    return mask, int(sel.sum())


# ---------------------------------------------------------------------------
# principled, principledthin and measured (tests/test_principled.py and
# tests/test_measured.py)
# ---------------------------------------------------------------------------

def _rgb(v):
    return {"type": "rgb", "value": list(v)}


PRINCIPLED = {
    "core": {"type": "principled", "metallic": 0.6, "roughness": 0.35,
             "specular": 0.7, "base_color": _rgb([0.7, 0.4, 0.3])},
    "clearcoat_sheen": {"type": "principled", "metallic": 0.2,
                        "roughness": 0.5, "clearcoat": 0.8,
                        "clearcoat_gloss": 0.6, "sheen": 0.6,
                        "sheen_tint": 0.5, "flatness": 0.4,
                        "base_color": _rgb([0.6, 0.5, 0.4])},
    "anisotropic": {"type": "principled", "roughness": 0.4,
                    "anisotropic": 0.8, "spec_tint": 0.5,
                    "base_color": _rgb([0.7, 0.3, 0.2])},
    "spec_trans": {"type": "principled", "roughness": 0.45,
                   "spec_trans": 0.7, "eta": 1.45, "spec_tint": 0.3,
                   "base_color": _rgb([0.8, 0.7, 0.6])},
    "thin": {"type": "principledthin", "roughness": 0.4, "eta": 1.4,
             "spec_trans": 0.4, "diff_trans": 0.6,
             "base_color": _rgb([0.6, 0.7, 0.5])},
}


def bsdf_plane_dict(bsdf, res=16, max_depth=3, from_below=False):
    """A rectangle of `bsdf` under a constant environment and a small
    area light, seen from above (or from below, for transmission)."""
    z = -4.0 if from_below else 4.0
    return {"type": "scene",
            "integrator": {"type": "path", "max_depth": max_depth},
            "sensor": _sensor(res, 45, [0.3, 0.2, z], [0, 0, 0]),
            "plane": {"type": "rectangle", "bsdf": bsdf},
            "lamp": {"type": "rectangle",
                     "to_world": Transform().translate([0.5, 0.0, 2.0])
                     .scale(0.3).matrix.copy(),
                     "emitter": {"type": "area",
                                 "radiance": _rgb([20.0] * 3)}},
            "env": _white_env(0.5)}


def synthetic_measured(S=6, H=16, W=16, seed=0):
    """The fields of a smooth glossy synthetic material in the RGL layout
    (tests/test_measured.py's, with a seeded ripple on the vndf)."""
    rng = np.random.default_rng(seed)
    theta_i = np.linspace(0.0, np.pi / 2, S).astype(np.float32)
    yy, xx = np.meshgrid(np.linspace(0, 1, H, endpoint=False) + 0.5 / H,
                         np.linspace(0, 1, W, endpoint=False) + 0.5 / W,
                         indexing="ij")
    vndf = np.zeros((1, S, H, W), np.float32)
    lum = np.zeros((1, S, H, W), np.float32)
    for s in range(S):
        c = 0.15 + 0.5 * s / S
        vndf[0, s] = np.exp(-((xx - c) ** 2 + (yy - 0.5) ** 2) / 0.08) \
            + 0.05 + 0.02 * rng.uniform(size=(H, W))
        lum[0, s] = np.exp(-((xx - 0.4) ** 2) / 0.2) + 0.1
    rgb = np.zeros((1, S, 3, H, W), np.float32)
    rgb[0, :, 0] = 0.6
    rgb[0, :, 1] = 0.3 + 0.3 * xx
    rgb[0, :, 2] = 0.1
    return {"theta_i": theta_i, "phi_i": np.zeros(1, np.float32),
            "vndf": vndf, "luminance": lum, "rgb": rgb,
            "ndf": np.ones((H, W), np.float32),
            "sigma": np.full((H, W), 0.25, np.float32),
            "jacobian": np.zeros(1, np.uint8),
            "description": np.frombuffer(b"synthetic", np.uint8).copy()}


def measured_plate_dict(path, res=16, max_depth=3):
    """A plate of the measured material at `path` under the plane's
    lights, seen at an angle."""
    d = bsdf_plane_dict({"type": "measured", "filename": path}, res,
                        max_depth)
    d["sensor"] = _sensor(res, 45, [1.5, 0.5, 3.5], [0, 0, 0])
    return d


def principled_cornell(cornell):
    """BASELINE's Cornell box with a principled tall block (metallic 0.4,
    roughness 0.4, clearcoat 0.7, sheen 0.4) and a principledthin short
    block; `cornell` is the port's scene/cornell.cornell_box."""
    d = cornell()
    d["large-box"]["bsdf"] = {"type": "principled", "metallic": 0.4,
                              "roughness": 0.4, "clearcoat": 0.7,
                              "clearcoat_gloss": 0.5, "sheen": 0.4,
                              "base_color": _rgb([0.6, 0.5, 0.4])}
    d["small-box"]["bsdf"] = {"type": "principledthin", "roughness": 0.3,
                              "spec_trans": 0.3, "diff_trans": 0.4,
                              "base_color": _rgb([0.5, 0.6, 0.7])}
    return d


# ---------------------------------------------------------------------------
# the rest of M10: the sunsky, mesh-attribute and volume textures,
# instancing, SDF grids, curves and hair (tests/test_sunsky.py,
# tests/test_components.py, tests/test_instancing.py, tests/test_sdfgrid.py,
# tests/test_curves_hair.py)
# ---------------------------------------------------------------------------

def sunsky_proxy(d, **sunsky):
    """A liver proxy dict (scene/liver_proxy.liver_proxy_dict) lit by a
    Preetham sunsky (baked to a 256 x 128 envmap) instead of its own
    environment."""
    d = dict(d)
    d["env"] = {"type": "sunsky", **sunsky}
    return d


def attr_quad_dict(res=16, max_depth=2):
    """A quad whose diffuse reflectance is its interpolated vertex colour
    (test_mesh_attribute_texture)."""
    v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                 np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    col = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0]], np.float32)
    return {"type": "scene",
            "integrator": {"type": "path", "max_depth": max_depth},
            "sensor": _sensor(res, 50.0, [0, 0, 2.5], [0, 0, 0]),
            "quad": {"type": "mesh", "vertices": v, "faces": f,
                     "vertex_attrs": col,
                     "bsdf": {"type": "diffuse",
                              "reflectance": {"type": "mesh_attribute",
                                              "name": "vertex_color",
                                              "scale": 0.9}}},
            "env": _white_env()}


def volume_grid():
    """test_volume_texture's 2^3 grid: red, its +x half yellow."""
    g = np.zeros((2, 2, 2, 3), np.float32)
    g[..., 0] = 1.0
    g[:, :, 1, 1] = 1.0
    return g


def volume_wall_dict(res=16, max_depth=2, grid=None, scale=1.0):
    """A wall over [0,1]^2 at z = 0 whose reflectance is a 3-D grid
    texture read at the hit position (test_volume_texture)."""
    return {"type": "scene",
            "integrator": {"type": "path", "max_depth": max_depth},
            "sensor": _sensor(res, 25.0, [0.5, 0.5, 3.0], [0.5, 0.5, 0.0]),
            "wall": {"type": "rectangle",
                     "to_world": Transform().translate([0.5, 0.5, 0.0])
                     .scale(0.5).matrix.copy(),
                     "bsdf": {"type": "diffuse",
                              "reflectance": {
                                  "type": "volume", "scale": scale,
                                  "data": volume_grid() if grid is None
                                  else grid}}},
            "env": _white_env()}


def instancing_dict(n_inst=3, light="point", res=(48, 36), max_depth=4,
                    group=None, cap_bsdf=None):
    """test_instancing.py's scene: n_inst instances of a group (a box and
    a cap, or `group`'s shapes) on a floor, lit by a point light or a
    constant environment; cap_bsdf replaces the cap's diffuse BSDF.  Load
    it with flatten_instances=True for the replicated twin."""
    w, h = (res, res) if np.isscalar(res) else res
    d = {"type": "scene",
         "integrator": {"type": "path", "max_depth": max_depth},
         "sensor": {"type": "perspective", "fov": 45,
                    "to_world": Transform().look_at(
                        [0, -6, 2], [0, 0, 0.3], [0, 0, 1]).matrix.copy(),
                    "film": {"type": "hdrfilm", "width": w, "height": h,
                             "rfilter": {"type": "box"}}},
         "grp": group or {
             "type": "shapegroup", "id": "grp",
             "box": {"type": "cube",
                     "to_world": Transform().scale(0.25).matrix.copy(),
                     "bsdf": {"type": "diffuse",
                              "reflectance": _rgb([0.7, 0.3, 0.2])}},
             "cap": {"type": "rectangle",
                     "to_world": Transform().translate([0, 0, 0.3])
                     .scale(0.2).matrix.copy(),
                     "bsdf": cap_bsdf or {
                         "type": "diffuse",
                         "reflectance": _rgb([0.2, 0.6, 0.3])}}},
         "floor": {"type": "rectangle",
                   "to_world": Transform().translate([0, 0, -0.3])
                   .scale(8.0).matrix.copy(),
                   "bsdf": {"type": "diffuse"}}}
    if light == "point":
        d["light"] = {"type": "point", "position": [2, -3, 4],
                      "intensity": _rgb([60.0] * 3)}
    else:
        d["light"] = _white_env(0.8)
    for i in range(n_inst):
        ang = 360.0 * i / max(n_inst, 1)
        d[f"inst{i}"] = {
            "type": "instance", "grp_ref": {"type": "ref", "id": "grp"},
            "to_world": Transform().translate([(i % 5) - 2.0,
                                               (i // 5) - 1.0, 0.0])
            .rotate([0, 0, 1], ang).matrix.copy()}
    return d


def liver_group(subdiv=4, seed=0, scale=0.45):
    """A shapegroup holding the liver proxy's mesh (scene/liver_proxy),
    scaled down, with a rough-plastic BSDF."""
    from liverrenderer_tpu_torch.scene.liver_proxy import liver_mesh
    v, f, n, uv = liver_mesh(subdiv, seed)
    return {"type": "shapegroup", "id": "grp",
            "liver": {"type": "mesh", "vertices": v, "faces": f,
                      "normals": n, "uvs": uv,
                      "to_world": Transform().translate([0, 0, 0.2])
                      .scale(scale).matrix.copy(),
                      "bsdf": {"type": "roughplastic", "alpha": 0.2,
                               "diffuse_reflectance":
                                   _rgb([0.55, 0.2, 0.15])}}}


def sphere_sdf(res=32, r=0.3):
    """A sphere's signed distances on a res^3 [0,1]^3 grid (z, y, x)."""
    ax = (np.arange(res) + 0.5) / res
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    return (np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2)
            - r).astype(np.float32)


def noisy_sphere_sdf(res=32, r=0.3, seed=0, amp=0.02):
    """sphere_sdf with seeded smooth bumps added (a lumpy blob)."""
    rng = np.random.default_rng(seed)
    ax = (np.arange(res) + 0.5) / res
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    bump = np.zeros_like(x)
    for _ in range(6):
        k = rng.integers(1, 4, 3)
        ph = rng.uniform(0, 2 * np.pi, 3)
        bump += np.sin(2 * np.pi * k[0] * x + ph[0]) \
            * np.sin(2 * np.pi * k[1] * y + ph[1]) \
            * np.sin(2 * np.pi * k[2] * z + ph[2])
    return (sphere_sdf(res, r) + amp * bump / 6.0).astype(np.float32)


def sdf_dict(grid, res=16, max_depth=3, to_world=None, light="env"):
    """test_sdfgrid.py's scene: a green SDF over the unit cube under a
    white environment (or a point light)."""
    d = {"type": "scene",
         "integrator": {"type": "path", "max_depth": max_depth},
         "sensor": _sensor(res, 35.0, [0.5, 0.5, 2.5], [0.5, 0.5, 0.5]),
         "sdf": {"type": "sdfgrid", "grid": grid,
                 "bsdf": {"type": "diffuse",
                          "reflectance": _rgb([0.1, 0.7, 0.1])}},
         "env": _white_env()}
    if to_world is not None:
        d["sdf"]["to_world"] = to_world
    if light == "point":
        d["env"] = {"type": "point", "position": [1.5, 2.0, 2.5],
                    "intensity": _rgb([8.0] * 3)}
    return d


def blobs_dict(res=16, max_depth=3):
    """test_ellipsoids_instancing: two red ellipsoid meshes."""
    rows = np.array([[0.0, 0, 0, 0.1, 0.1, 0.1, 0, 0, 0, 1],
                     [0.5, 0, 0, 0.05, 0.2, 0.05, 0, 0, 0, 1]], np.float32)
    return {"type": "scene",
            "integrator": {"type": "path", "max_depth": max_depth},
            "sensor": _sensor(res, 45.0, [0.25, 0, 2.0], [0.25, 0, 0]),
            "blobs": {"type": "ellipsoidsmesh", "data": rows, "extent": 1.0,
                      "bsdf": {"type": "diffuse",
                               "reflectance": _rgb([0.7, 0.1, 0.1])}},
            "env": _white_env()}


def curve_dict(shape, res=24, max_depth=4):
    """test_curves_hair.py's scene: a curve shape seen from z = 3 under a
    white environment."""
    return {"type": "scene",
            "integrator": {"type": "path", "max_depth": max_depth},
            "sensor": _sensor(res, 40.0, [0, 0, 3], [0, 0, 0]),
            "curve": shape, "env": _white_env()}


def straight_fiber(bsdf, radius=0.3):
    return {"type": "linearcurve", "points": [[0, -1, 0], [0, 1, 0]],
            "radius": radius, "bsdf": bsdf}


def write_bspline_strand(path, n=8):
    """test_bsplinecurve_from_file's control points as a curve file."""
    pts = np.stack([np.linspace(-1, 1, n), np.zeros(n),
                    0.3 * np.sin(np.linspace(0, np.pi, n))], -1)
    with open(path, "w") as f:
        f.write("\n".join(f"{p[0]} {p[1]} {p[2]} 0.1" for p in pts) + "\n")


def write_hair_tuft(path, n_strands, seed=0, n_ctrl=12, length=1.6,
                    radius=0.006):
    """A seeded tuft of B-spline strands hanging from a scalp patch as a
    curve file (blank lines between strands)."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n_strands):
        root = np.array([rng.uniform(-0.5, 0.5), 0.8,
                         rng.uniform(-0.3, 0.3)])
        drift = rng.normal(0, 0.08, 3)
        curl = rng.uniform(0.02, 0.08)
        ph = rng.uniform(0, 2 * np.pi)
        s = np.linspace(0.0, 1.0, n_ctrl)
        pts = root[None] + np.stack([
            drift[0] * s + curl * np.cos(ph + 9 * s),
            -length * s,
            drift[2] * s + curl * np.sin(ph + 9 * s)], -1)
        r = radius * (1.0 - 0.6 * s)
        lines += [f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {q:.6f}"
                  for p, q in zip(pts, r)] + [""]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


HAIR = {"type": "hair", "eumelanin": 1.3, "pheomelanin": 0.2,
        "beta_m": 0.3, "beta_n": 0.3}


def hair_tuft_dict(path, res=256, spp=16, max_depth=8):
    """A hair tuft from a curve file (bsplinecurve, 6-sided tubes) with
    the hair BSDF, under a white environment and a point light."""
    return {"type": "scene",
            "integrator": {"type": "path", "max_depth": max_depth},
            "sensor": dict(_sensor(res, 40.0, [0, 0, 3], [0, 0, 0]),
                           sampler={"type": "independent",
                                    "sample_count": spp}),
            "tuft": {"type": "bsplinecurve", "filename": path, "subdiv": 4,
                     "sides": 6, "bsdf": dict(HAIR)},
            "light": {"type": "point", "position": [1.5, 2.0, 3.0],
                      "intensity": _rgb([10.0] * 3)},
            "env": _white_env(0.5)}


def textured_cornell(cornell, grid_res=8, seed=0):
    """A Cornell box dict (`cornell`, e.g. scene/cornell.cornell_box) with
    a block whose reflectance is its vertex colours (mesh_attribute) and a
    block textured by a seeded res^3 colour grid (volume)."""
    from liverrenderer_tpu_torch.scene import geometry as geo
    d = cornell()
    cube = geo.cube()
    rng = np.random.default_rng(seed)
    col = rng.uniform(0.1, 0.9, (len(cube.vertices), 3)).astype(np.float32)
    d["attr_block"] = {
        "type": "mesh", "vertices": cube.vertices, "faces": cube.faces,
        "vertex_attrs": col,
        "to_world": Transform().translate([-0.4, -0.7, 0.2])
        .scale(0.28).matrix.copy(),
        "bsdf": {"type": "diffuse",
                 "reflectance": {"type": "mesh_attribute",
                                 "name": "vertex_color"}}}
    grid = rng.uniform(0.1, 0.9, (grid_res, grid_res, grid_res, 3)) \
        .astype(np.float32)
    # the grid spans the block's world box [0.15, 0.65] x [-1, -0.4] x
    # [-0.5, 0]
    to_grid = Transform().translate([0.15, -1.0, -0.5]).scale(
        [0.5, 0.6, 0.5]).matrix.copy()
    d["vol_block"] = {
        "type": "cube",
        "to_world": Transform().translate([0.4, -0.7, -0.25])
        .scale([0.25, 0.3, 0.25]).matrix.copy(),
        "bsdf": {"type": "diffuse",
                 "reflectance": {"type": "volume", "data": grid,
                                 "to_world": to_grid}}}
    return d


def sdf_cornell(cornell, res=64, seed=0):
    """A Cornell box dict with a seeded lumpy res^3 SDF sphere on the
    floor."""
    d = cornell()
    d["sdf"] = {"type": "sdfgrid", "grid": noisy_sphere_sdf(res, 0.4, seed),
                "to_world": Transform().translate([-0.45, -1.0, -0.45])
                .scale(0.9).matrix.copy(),
                "bsdf": {"type": "diffuse",
                         "reflectance": _rgb([0.2, 0.5, 0.8])}}
    return d
