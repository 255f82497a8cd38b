"""The seven sensor types (perspective, thinlens, orthographic, distant,
radiancemeter, irradiancemeter, batch) against the JAX package on the
CPU: sample_ray per ray on the same film positions and aperture samples,
the images of tests/test_sensors_meter.py's five scenes and of a thinlens
and an orthographic Cornell box at 16x16 per pixel, and a thinlens
gradient of bsdfs.params through the scan adjoint per entry.

Tolerances (tests/test_torch_path_slice.py's): rays within rtol 1e-5 /
atol 1e-6 (the same fp32 formulas; the matrix products may round
apart); images every pixel within rtol 1e-4 / atol 1e-6; gradients every
entry within 1e-5 of the largest.

The thinlens gradient runs from tests/test_torch_thinlens_grad.py, which
shares this file's scenes and tolerances, so that xdist's file scheduler
can start it apart from this file (a long file holds one worker to its
end).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu.integrators import regen as jregen
from liverrenderer_tpu.sensor import perspective as jsensor
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.integrators import regen as tregen
from liverrenderer_tpu_torch.sensor import perspective as tsensor
from test_torch_path_slice import _assert_images_equal, _pair
from torch_sensor_scenes import sensor_scenes
from torch_threads import torch_threads_per_worker  # noqa: F401

RAY_RTOL, RAY_ATOL = 1e-5, 1e-6


SCENES = sensor_scenes()


@pytest.fixture(scope="module")
def scenes():
    return {k: _pair(d) for k, (d, _) in SCENES.items()}


@pytest.mark.parametrize("name", list(SCENES))
def test_sample_ray_matches_jax(scenes, name, np_rng):
    """The same film positions and aperture samples give the same rays,
    with and without an aperture sample."""
    js, ts = scenes[name]
    assert ts.sensor.stype == js.sensor.stype
    n = 257
    pos = np_rng.uniform(0, 1, (n, 2)) * [ts.film_w, ts.film_h]
    ua = np_rng.uniform(0, 1, (n, 2))
    pos, ua = pos.astype(np.float32), ua.astype(np.float32)
    for u in (ua, None):
        jr = jsensor.sample_ray(js, jnp.asarray(pos),
                                None if u is None else jnp.asarray(u))
        tr = tsensor.sample_ray(ts, torch.from_numpy(pos),
                                None if u is None else torch.from_numpy(u))
        for a, b in ((tr.o, jr.o), (tr.d, jr.d), (tr.maxt, jr.maxt)):
            np.testing.assert_allclose(np.broadcast_to(a.numpy(),
                                                       np.shape(b)),
                                       np.asarray(b), rtol=RAY_RTOL,
                                       atol=RAY_ATOL)
    assert tsensor.ray_weight(ts) == jsensor.ray_weight(js)


@pytest.mark.parametrize("name", list(SCENES))
def test_sensor_images_match_jax(scenes, name):
    """Per pixel; thinlens and irradiancemeter take the fixed wavefront
    (their second 2-D sample), as in the JAX package."""
    js, ts = scenes[name]
    assert tregen.regen_applicable(ts, "primal") \
        == jregen.regen_applicable(js, "primal")
    spp = SCENES[name][1]
    ref = np.asarray(lr.render(js, spp=spp, seed=0))
    img = lrt.render(ts, spp=spp, seed=0).numpy()
    _assert_images_equal(img, ref)
    assert img.mean() > 0.05


def test_sensor_statics_and_bsphere_match_jax(scenes):
    """The bridge-visible sensor fields the builders fill."""
    for name, (js, ts) in scenes.items():
        for f in ("has_target", "target_shape", "batch_count", "stype"):
            assert getattr(ts.sensor, f) == getattr(js.sensor, f), (name, f)
        for f in ("bsphere", "target", "batch_to_world", "batch_fov_x",
                  "near_clip", "far_clip", "aperture_radius",
                  "focus_distance"):
            np.testing.assert_allclose(getattr(ts.sensor, f).numpy(),
                                       np.asarray(getattr(js.sensor, f)),
                                       rtol=1e-6, err_msg=f"{name}.{f}")


@pytest.mark.parametrize("name", ["distant", "batch", "irradiancemeter"])
def test_bridge_carries_the_sensor(scenes, name):
    """bridge.scene_from_numpy carries the JAX Sensor's fields: the port
    renders the bridged JAX scene as it renders its own."""
    from liverrenderer_tpu_torch.bridge import numpy_tree, scene_from_numpy
    js, ts = scenes[name]
    bridged = scene_from_numpy(*numpy_tree(js), "cpu")
    for f in ("stype", "has_target", "target_shape", "batch_count"):
        assert getattr(bridged.sensor, f) == getattr(js.sensor, f), f
    spp = SCENES[name][1]
    _assert_images_equal(lrt.render(bridged, spp=spp, seed=0).numpy(),
                         lrt.render(ts, spp=spp, seed=0).numpy())
