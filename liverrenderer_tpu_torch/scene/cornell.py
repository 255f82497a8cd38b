"""Builtin Cornell-box scene dict (counterpart of
liverrenderer_tpu/scene/cornell.py): the reference's mi.cornell_box() (same
camera, BSDF albedos, light radiance and geometry; BASELINE's first
evaluation config at 256x256, 64 spp, `path` depth 8, gaussian filter),
the fog Cornell box of the BASELINE configuration
`cornell_box_1080x1080_fog_st_albedo`, the gradient tests' plane, and two
heterogeneous-medium scenes: tests/test_heterogeneous.py's grid cube and
the fog Cornell box with a grid cube in place of its fog.
"""
from __future__ import annotations

import numpy as np

from .transform import Transform


def cornell_box():
    T = Transform
    return {
        'type': 'scene',
        'integrator': {'type': 'path', 'max_depth': 8},
        'sensor': {
            'type': 'perspective',
            'fov_axis': 'smaller',
            'near_clip': 0.001,
            'far_clip': 100.0,
            'fov': 39.3077,
            'to_world': T().look_at(origin=[0, 0, 3.90], target=[0, 0, 0],
                                    up=[0, 1, 0]),
            'sampler': {'type': 'independent', 'sample_count': 64},
            'film': {
                'type': 'hdrfilm', 'width': 256, 'height': 256,
                'rfilter': {'type': 'gaussian'},
                'pixel_format': 'rgb', 'component_format': 'float32',
            },
        },
        'white': {'type': 'diffuse',
                  'reflectance': {'type': 'rgb',
                                  'value': [0.885809, 0.698859, 0.666422]}},
        'green': {'type': 'diffuse',
                  'reflectance': {'type': 'rgb',
                                  'value': [0.105421, 0.37798, 0.076425]}},
        'red': {'type': 'diffuse',
                'reflectance': {'type': 'rgb',
                                'value': [0.570068, 0.0430135, 0.0443706]}},
        'light': {
            'type': 'rectangle',
            'to_world': T().translate([0.0, 0.99, 0.01])
                           .rotate([1, 0, 0], 90).scale([0.23, 0.19, 0.19]),
            'bsdf': {'type': 'ref', 'id': 'white'},
            'emitter': {'type': 'area',
                        'radiance': {'type': 'rgb',
                                     'value': [18.387, 13.9873, 6.75357]}},
        },
        'floor': {'type': 'rectangle',
                  'to_world': T().translate([0.0, -1.0, 0.0])
                                 .rotate([1, 0, 0], -90),
                  'bsdf': {'type': 'ref', 'id': 'white'}},
        'ceiling': {'type': 'rectangle',
                    'to_world': T().translate([0.0, 1.0, 0.0])
                                   .rotate([1, 0, 0], 90),
                    'bsdf': {'type': 'ref', 'id': 'white'}},
        'back': {'type': 'rectangle',
                 'to_world': T().translate([0.0, 0.0, -1.0]),
                 'bsdf': {'type': 'ref', 'id': 'white'}},
        'green-wall': {'type': 'rectangle',
                       'to_world': T().translate([1.0, 0.0, 0.0])
                                      .rotate([0, 1, 0], -90),
                       'bsdf': {'type': 'ref', 'id': 'green'}},
        'red-wall': {'type': 'rectangle',
                     'to_world': T().translate([-1.0, 0.0, 0.0])
                                    .rotate([0, 1, 0], 90),
                     'bsdf': {'type': 'ref', 'id': 'red'}},
        'small-box': {'type': 'cube',
                      'to_world': T().translate([0.335, -0.7, 0.38])
                                     .rotate([0, 1, 0], -17).scale(0.3),
                      'bsdf': {'type': 'ref', 'id': 'white'}},
        'large-box': {'type': 'cube',
                      'to_world': T().translate([-0.33, -0.4, -0.28])
                                     .rotate([0, 1, 0], 18.25)
                                     .scale([0.3, 0.61, 0.3]),
                      'bsdf': {'type': 'ref', 'id': 'white'}},
    }


def fog_cornell_box(res: int = 1080, sigma: float = 0.2,
                    albedo: float = 0.75, scale: float = 2.5,
                    max_depth: int = 16, cornell=cornell_box):
    """The Cornell box in a homogeneous isotropic fog attached as the
    sensor medium (the camera starts inside it), under volpath with a box
    filter: BASELINE's `cornell_box_1080x1080_fog_st_albedo` at res=1080
    (the reference runner's sigma_t 0.2, albedo 0.75, scale 2.5, depth 16).
    `cornell` supplies the base dict (another package's cornell_box
    builds the same scene)."""
    d = cornell()
    d["integrator"] = {"type": "volpath", "max_depth": max_depth}
    d["sensor"]["film"] = {"type": "hdrfilm", "width": res, "height": res,
                           "rfilter": {"type": "box"}}
    d["sensor"]["medium"] = {
        "type": "homogeneous",
        "sigma_t": {"type": "rgb", "value": [sigma] * 3},
        "albedo": {"type": "rgb", "value": [albedo] * 3},
        "scale": scale,
        "phase": {"type": "isotropic"},
    }
    return d


def plane_light_dict(res: int = 12, integrator: str = "volpath",
                     max_depth: int = 6, light=None, fog_cube: bool = False,
                     bsdf=None):
    """A plane seen head-on under a light (the reference's gradient-test
    ConfigBase scene, as tests/test_ad_configs.py builds it with
    integrator="path", max_depth=3): by default a diffuse plane under a
    rectangular area light facing it; `light` replaces the light (a point
    or constant emitter dict) and `bsdf` the plane's BSDF.  fog_cube adds
    a null-BSDF cube around the plane holding a homogeneous medium, whose
    shadow rays take the ratio-tracked walk and whose scattering events do
    medium NEE under volpath.  Transforms are
    4x4 arrays, so both packages load the dict."""
    d = {
        "type": "scene",
        "integrator": {"type": integrator, "max_depth": max_depth,
                       "rr_depth": 16},
        "sensor": {
            "type": "perspective", "fov": 45.0,
            "to_world": Transform().look_at([0, 0.3, 1.3], [0, 0, 0],
                                            [0, 1, 0]).matrix.copy(),
            "film": {"type": "hdrfilm", "width": res, "height": res,
                     "rfilter": {"type": "box"}},
        },
        "plane": {"type": "rectangle",
                  "bsdf": bsdf or {"type": "diffuse",
                                   "reflectance": {"type": "rgb",
                                                   "value": [0.6, 0.5,
                                                             0.4]}}},
        "light": light or {
            "type": "rectangle",
            "to_world": Transform().translate([0, 0, 2.0])
            .rotate([1, 0, 0], 180).scale(0.5).matrix.copy(),
            "emitter": {"type": "area",
                        "radiance": {"type": "rgb", "value": [4.0] * 3}}},
    }
    if fog_cube:
        d["fog"] = {
            "type": "cube", "to_world": Transform().scale(0.9).matrix.copy(),
            "bsdf": {"type": "null"},
            "interior": {"type": "homogeneous",
                         "sigma_t": {"type": "rgb", "value": [0.6] * 3},
                         "albedo": {"type": "rgb", "value": [0.5] * 3}}}
    return d


def smooth_noise_grid(res: int, seed: int, cells: int = 8) -> np.ndarray:
    """A (res, res, res) float32 density grid of smoothed noise in [0, 1]:
    uniform noise on a (cells + 1)^3 lattice, interpolated linearly along
    each axis and rescaled to span [0, 1]."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.0, 1.0, (cells + 1,) * 3).astype(np.float32)
    x = np.linspace(0.0, cells, res, dtype=np.float32)
    i0 = np.minimum(np.floor(x).astype(np.int64), cells - 1)
    f = x - i0
    for axis in range(3):
        w = f.reshape([-1 if a == axis else 1 for a in range(3)])
        g = np.take(g, i0, axis) * (1.0 - w) + np.take(g, i0 + 1, axis) * w
    return ((g - g.min()) / (g.max() - g.min())).astype(np.float32)


def _grid_medium(grid, scale, albedo, phase=None, to_world=None):
    sigma_t = {"type": "gridvolume", "data": grid}
    if to_world is not None:
        sigma_t["to_world"] = to_world
    med = {"type": "heterogeneous", "sigma_t": sigma_t, "scale": scale,
           "albedo": {"type": "rgb", "value": [albedo] * 3}}
    if phase is not None:
        med["phase"] = phase
    return med


def grid_cube_dict(res: int = 8, grid=None, scale: float = 1.0,
                   integrator: str = "volpath", max_depth: int = 4,
                   light=None, phase=None):
    """tests/test_heterogeneous.py's `_grid_scene`: a null-BSDF unit cube
    [0, 1]^3 holding a heterogeneous medium (by default an 8^3 density
    ramp from 0.2 to 1.0 along x, albedo 0.3), seen from +z under a
    constant environment.  `light` replaces the environment (e.g. a point
    light) and `phase` sets the medium's phase.

    The cube's +-y faces wind inward in both packages' cube (ROADMAP
    Queue 3), so a lane leaving through them keeps the cube's medium; under
    the environment's unbounded shadow distance such a lane's NEE walk
    runs to the 4,096-step cap."""
    if grid is None:
        ramp = np.linspace(0.2, 1.0, 8, dtype=np.float32)
        grid = np.broadcast_to(ramp[None, None, :], (8, 8, 8)).copy()
    return {
        "type": "scene",
        "integrator": {"type": integrator, "max_depth": max_depth},
        "sensor": {
            "type": "perspective", "fov": 35.0,
            "to_world": Transform().look_at([0.5, 0.5, 3.0], [0.5, 0.5, 0.5],
                                            [0, 1, 0]).matrix.copy(),
            "film": {"type": "hdrfilm", "width": res, "height": res,
                     "rfilter": {"type": "box"}},
        },
        "box": {"type": "cube",
                "to_world": Transform().translate([0.5, 0.5, 0.5])
                .scale(0.5).matrix.copy(),
                "bsdf": {"type": "null"},
                "interior": _grid_medium(grid, scale, 0.3, phase)},
        "env": light or {"type": "constant",
                         "radiance": {"type": "rgb", "value": [1.0] * 3}},
    }


def grid_cornell_box(res: int = 1080, grid=None, seed: int = 0,
                     grid_res: int = 256, scale: float = 4.0,
                     albedo: float = 0.8, g: float = 0.5,
                     max_depth: int = 16, cornell=cornell_box):
    """The fog Cornell box's layout (volpath depth 16, box filter, the
    Cornell box's light) with the sensor fog replaced by a null-BSDF cube
    [-0.6, 0.6]^3 (raised by 0.05) holding a heterogeneous medium: a
    `grid_res`^3 single-channel density grid of smoothed noise in [0, 1]
    made from `seed` (or `grid`), scale 4, albedo 0.8 and an HG phase with
    g = 0.5, the medium kind of BASELINE.json's config 4."""
    if grid is None:
        grid = smooth_noise_grid(grid_res, seed)
    d = cornell()
    d["integrator"] = {"type": "volpath", "max_depth": max_depth}
    d["sensor"]["film"] = {"type": "hdrfilm", "width": res, "height": res,
                           "rfilter": {"type": "box"}}
    tw = Transform().translate([0.0, 0.05, 0.0]).scale(0.6)
    # the grid's local [0, 1]^3 spans the cube's [-1, 1]^3
    g2w = (tw @ Transform().translate([-1.0, -1.0, -1.0]).scale(2.0))
    d["grid_box"] = {
        "type": "cube", "to_world": tw.matrix.copy(),
        "bsdf": {"type": "null"},
        "interior": _grid_medium(grid, scale, albedo,
                                 {"type": "hg", "g": g},
                                 to_world=g2w.matrix.copy())}
    return d
