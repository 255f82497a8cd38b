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
