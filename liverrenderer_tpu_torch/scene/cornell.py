"""Builtin Cornell-box scene dict (counterpart of
liverrenderer_tpu/scene/cornell.py): the reference's mi.cornell_box() (same
camera, BSDF albedos, light radiance and geometry; BASELINE's first
evaluation config at 256x256, 64 spp, `path` depth 8, gaussian filter),
the fog Cornell box of the BASELINE configuration
`cornell_box_1080x1080_fog_st_albedo`, and the gradient tests' plane.
"""
from __future__ import annotations

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
