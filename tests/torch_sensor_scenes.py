"""Scenes of the sensor and CLI tests, as dicts and XML text (no JAX:
tests/test_torch_cuda.py and chip_smoke.py load this file on the card's
machine).

`sensor_scenes(cornell_film)`: {name: (scene dict, spp)} of the seven
sensor types: tests/test_sensors_meter.py's five scenes (radiancemeter,
distant with and without a target, irradiancemeter nested in a sphere,
batch of two cameras) under a constant environment, and BASELINE's
Cornell box through a thinlens, an orthographic and a perspective camera
at cornell_film (width, height).
`CLI_XML`: tests/test_pipeline.py::test_cli_renders_cornell's scene.
"""
import numpy as np

from liverrenderer_tpu_torch.scene.cornell import cornell_box
from liverrenderer_tpu_torch.scene.transform import Transform

CLI_XML = """<scene version="3.6.0">
  <default name="spp" value="4"/>
  <integrator type="path"><integer name="max_depth" value="3"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="to_world">
      <lookat origin="0, 1, 4" target="0, 0.5, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="independent"><integer name="sample_count" value="$spp"/></sampler>
    <film type="hdrfilm">
      <integer name="width" value="24"/><integer name="height" value="24"/>
      <rfilter type="box"/>
    </film>
  </sensor>
  <shape type="rectangle">
    <transform name="to_world"><rotate x="1" angle="-90"/><scale value="3"/></transform>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.5, 0.5, 0.5"/></bsdf>
  </shape>
  <emitter type="constant"><rgb name="radiance" value="0.8, 0.8, 0.8"/></emitter>
</scene>"""


def matrices(d):
    """The dict with every Transform as its 4x4 matrix, which both
    packages' builders take."""
    if isinstance(d, dict):
        return {k: matrices(v) for k, v in d.items()}
    return d.matrix if isinstance(d, Transform) else d


def _film(w, h):
    return {"type": "hdrfilm", "width": w, "height": h,
            "rfilter": {"type": "box"}}


def _env_only(sensor, radiance=1.0, extra=None):
    """Path depth 3 under a constant environment."""
    d = {"type": "scene", "integrator": {"type": "path", "max_depth": 3},
         "sensor": sensor,
         "env": {"type": "constant",
                 "radiance": {"type": "rgb", "value": [radiance] * 3}}}
    d.update(extra or {})
    return d


def _floor(value, scale=0.25):
    return {"floor": {"type": "rectangle",
                      "to_world": Transform().scale(scale).matrix,
                      "bsdf": {"type": "diffuse",
                               "reflectance": {"type": "rgb",
                                               "value": value}}}}


def _persp(ox):
    return {"type": "perspective", "fov": 45.0,
            "to_world": Transform().look_at([ox, 0, -2], [ox, 0, 0],
                                            [0, 1, 0]).matrix}


def cornell(kind, film):
    """BASELINE's Cornell box through a `kind` camera (a thinlens with a
    0.3 aperture focused at 1, well before the box) at film (w, h)."""
    d = matrices(cornell_box())
    d["sensor"]["type"] = kind
    d["sensor"]["film"].update(width=film[0], height=film[1])
    if kind == "thinlens":
        d["sensor"]["aperture_radius"] = 0.3
        d["sensor"]["focus_distance"] = 1.0
    return d


def sensor_scenes(cornell_film=(16, 16)):
    return {
        "radiancemeter": (_env_only({
            "type": "radiancemeter", "film": _film(1, 1),
            "to_world": Transform().look_at([0, 0, 0], [0, 0, 1],
                                            [0, 1, 0]).matrix}, 2.5), 16),
        "distant": (_env_only({"type": "distant", "direction": [0, 0, -1],
                               "film": _film(8, 8)},
                              extra=_floor([0.8] * 3)), 16),
        "distant_target": (_env_only({"type": "distant",
                                      "direction": [0, 0, -1],
                                      "target": [0, 0, 0],
                                      "film": _film(2, 2)},
                                     extra=_floor([0.5] * 3)), 16),
        "irradiancemeter": (_env_only({"type": "dummy"}, extra={
            "probe": {"type": "sphere", "radius": 0.1,
                      "bsdf": {"type": "null"},
                      "sensor": {"type": "irradiancemeter",
                                 "film": _film(2, 2)}}}), 32),
        "batch": (_env_only({"type": "batch", "a": _persp(-0.4),
                             "b": _persp(0.4), "film": _film(16, 8)},
                            extra=_floor([0.6, 0.2, 0.1], 1.0)), 8),
        "thinlens": (cornell("thinlens", cornell_film), 4),
        "orthographic": (cornell("orthographic", cornell_film), 4),
        "perspective": (cornell("perspective", cornell_film), 4),
    }


def images_agree(img, ref, rtol=1e-3, atol=1e-4, frac=0.99):
    """(pixel fraction within rtol / atol, mean relative difference):
    the card-against-CPU measure of chip_smoke.py's *_small phases."""
    close = np.abs(img - ref) <= atol + rtol * np.abs(ref)
    return float(close.all(-1).mean()), \
        float(abs(img.mean() - ref.mean()) / max(abs(ref.mean()), 1e-30))
