"""The heterogeneous grid medium and the extended phases as a whole: the
port's images and media.grids gradient against the JAX package's on the
CPU, on tests/test_heterogeneous.py's grid cube and its extended-phase
cubes, and the grid scene loaded from a Mitsuba XML file with a .vol grid.

The grid cube's +-y faces wind inward in both packages (ROADMAP Queue 3):
a lane leaving through them keeps the cube's medium, and under the
environment's unbounded shadow distance its NEE walk runs to the 4,096-step
cap (~250 s of the port's plain torch ops at 8 x 8 x 8 spp).  So the
environment-lit cube runs at depth 2 (no medium NEE), and the NEE walk
through the grid runs under a point light (a bounded shadow distance).

Tolerances (those of test_torch_render.py): images >= 99 % of pixels
within rtol 1e-3 / atol 1e-4 and the mean within 1e-3 relative; gradients
within 3e-6 of the largest entry (the order of the per-lane sums and of
the grid's scatter-adds differs).

The media.grids gradient runs from tests/test_torch_grid_grad.py, which
shares this file's scenes and tolerances, so that xdist's file scheduler
can start it apart from this file (a long file holds one worker to its
end).
"""
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.bridge import numpy_tree
from liverrenderer_tpu_torch.io.vol import write_vol
from liverrenderer_tpu_torch.scene.cornell import grid_cube_dict
from torch_threads import torch_threads_per_worker  # noqa: F401

PIX_RTOL, PIX_ATOL, PIX_FRAC, MEAN_RTOL = 1e-3, 1e-4, 0.99, 1e-3
G_ATOL_REL = 3e-6

POINT = {"type": "point", "position": [0.5, 2.2, 1.6],
         "intensity": {"type": "rgb", "value": [8.0] * 3}}

PHASES = {
    "rayleigh": {"type": "rayleigh"},
    "blendphase": {"type": "blendphase", "weight": 0.4,
                   "a": {"type": "hg", "g": 0.5}, "b": {"type": "isotropic"}},
    "tabphase": {"type": "tabphase", "values": [0.2, 0.5, 1.0, 2.0, 1.0, 0.5]},
    "sggx": {"type": "sggx", "S": [1.0, 0.3, 0.6, 0.0, 0.0, 0.0]},
}


def _assert_images_agree(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.abs(img - ref) <= PIX_ATOL + PIX_RTOL * np.abs(ref)
    assert close.all(-1).mean() >= PIX_FRAC
    assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())


def _phase_cube(phase):
    """test_heterogeneous.py's extended-phase scene: a null-BSDF cube of
    homogeneous fog with the phase, under a constant environment."""
    from liverrenderer_tpu_torch.scene.transform import Transform
    return {
        "type": "scene", "integrator": {"type": "volpath", "max_depth": 6},
        "sensor": {"type": "perspective", "fov": 35.0,
                   "to_world": Transform().look_at(
                       [0, 0, 3], [0, 0, 0], [0, 1, 0]).matrix.copy(),
                   "film": {"type": "hdrfilm", "width": 8, "height": 8,
                            "rfilter": {"type": "box"}}},
        "box": {"type": "cube", "bsdf": {"type": "null"},
                "to_world": Transform().scale(0.6).matrix.copy(),
                "interior": {"type": "homogeneous",
                             "sigma_t": {"type": "rgb", "value": [1.5] * 3},
                             "albedo": {"type": "rgb", "value": [0.8] * 3},
                             "phase": phase}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [1.0] * 3}},
    }


@pytest.mark.parametrize("kind", ["env_depth2", "point_light",
                                  "point_light_volpathmis"])
def test_grid_scene_image_matches_jax(kind):
    """The grid cube (scale 2) under its environment at depth 2, and under
    a point light at depth 4 (medium NEE through the ratio-tracked walk
    across the grid), also under volpathmis."""
    if kind == "env_depth2":
        d = grid_cube_dict(8, scale=2.0, max_depth=2)
    else:
        d = grid_cube_dict(8, scale=2.0, max_depth=4, light=POINT,
                           integrator="volpathmis"
                           if kind.endswith("volpathmis") else "volpath")
    js, ts = lr.load_dict(d), lrt.load_dict(d, device="cpu")
    ref = np.asarray(lr.render(js, spp=8, seed=0))
    img = lrt.render(ts, spp=8, seed=0).numpy()
    assert img.mean() > 1e-3
    _assert_images_agree(img, ref)


@pytest.mark.parametrize("name", sorted(PHASES))
def test_extended_phase_image_matches_jax(name):
    """Each extended phase of test_heterogeneous.py's
    test_extended_phases_render, per pixel."""
    d = _phase_cube(PHASES[name])
    js, ts = lr.load_dict(d), lrt.load_dict(d, device="cpu")
    ref = np.asarray(lr.render(js, spp=8, seed=0))
    img = lrt.render(ts, spp=8, seed=0).numpy()
    assert 0.2 < img.mean() < 1.5
    _assert_images_agree(img, ref)


def _grid_xml(tmp_path, grid):
    write_vol(str(tmp_path / "density.vol"), grid)
    (tmp_path / "scene.xml").write_text("""<scene version="3.0.0">
  <integrator type="volpath"><integer name="max_depth" value="4"/>
  </integrator>
  <sensor type="perspective">
    <float name="fov" value="35"/>
    <transform name="to_world">
      <lookat origin="0.5, 0.5, 3" target="0.5, 0.5, 0.5" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm"><integer name="width" value="8"/>
      <integer name="height" value="8"/><rfilter type="box"/></film>
  </sensor>
  <medium type="heterogeneous" id="smoke">
    <volume type="gridvolume" name="sigma_t">
      <string name="filename" value="density.vol"/>
    </volume>
    <float name="scale" value="2"/>
    <rgb name="albedo" value="0.3, 0.3, 0.3"/>
    <phase type="blendphase"><float name="weight" value="0.3"/>
      <phase type="hg"><float name="g" value="0.6"/></phase>
      <phase type="isotropic"/>
    </phase>
  </medium>
  <shape type="cube">
    <transform name="to_world"><scale value="0.5"/>
      <translate x="0.5" y="0.5" z="0.5"/></transform>
    <bsdf type="null"/>
    <ref name="interior" id="smoke"/>
  </shape>
  <emitter type="point"><point name="position" x="0.5" y="2.2" z="1.6"/>
    <rgb name="intensity" value="8, 8, 8"/></emitter>
</scene>
""")
    return str(tmp_path / "scene.xml")


def test_grid_xml_with_vol_file_loads_and_renders(tmp_path):
    """scene.xml with a heterogeneous medium whose sigma_t is a .vol grid
    and a blendphase: load_file builds the JAX package's buffers from the
    same file and renders the same image as load_dict of the grid array."""
    rng = np.random.default_rng(4)
    grid = rng.uniform(0.0, 1.0, (6, 7, 5)).astype(np.float32)
    path = _grid_xml(tmp_path, grid)
    ts = lrt.load_file(path, device="cpu")
    ja, _ = numpy_tree(lr.load_file(path))
    ta, _ = numpy_tree(ts)
    for k in ("media.params", "media.grid_id", "media.grids",
              "media.grid_whd", "media.grid_to_local"):
        np.testing.assert_array_equal(ta[k], np.asarray(ja[k]).astype(
            ta[k].dtype), err_msg=k)
    d = grid_cube_dict(8, grid=grid, scale=2.0, max_depth=4, light=POINT,
                       phase={"type": "blendphase", "weight": 0.3,
                              "a": {"type": "hg", "g": 0.6},
                              "b": {"type": "isotropic"}})
    td = lrt.load_dict(d, device="cpu")
    np.testing.assert_array_equal(ts.media.grids.numpy(),
                                  td.media.grids.numpy())
    img = lrt.render(ts, spp=4, seed=0)
    assert torch.equal(img, lrt.render(td, spp=4, seed=0))
    assert img.mean() > 1e-3
