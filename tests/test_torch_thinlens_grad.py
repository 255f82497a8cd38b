"""The thin-lens camera's gradient against the JAX package's on the CPU
(split from tests/test_torch_sensors.py, whose scenes and tolerances it
shares).
"""
from liverrenderer_tpu_torch.integrators import regen as tregen
from liverrenderer_tpu_torch.scene import cornell as tcornell
from test_torch_path_slice import (_assert_grads_equal, _assert_images_equal,
                                   _grads, _pair)
from torch_sensor_scenes import matrices
from torch_threads import torch_threads_per_worker  # noqa: F401


def test_thinlens_gradient_matches_jax():
    """bsdfs.params of a rough conductor under a thinlens camera: the scan
    adjoint (no regen for a thinlens), per entry."""
    d = tcornell.plane_light_dict(8, integrator="path", max_depth=3,
                                  bsdf={"type": "roughconductor",
                                        "alpha": 0.3, "material": "Al"})
    d["sensor"].update(type="thinlens", aperture_radius=0.05,
                       focus_distance=2.0)
    js, ts = _pair(matrices(d))
    assert not tregen.regen_applicable(ts, "primal")
    (ref, jimg), (g, timg) = _grads(js, ts, "bsdfs.params", spp=4)
    _assert_grads_equal(g, ref)
    _assert_images_equal(timg, jimg)
