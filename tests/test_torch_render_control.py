"""RenderControl on the port (liverrenderer_tpu_torch.integrators.regen):
tests/test_render_control.py's three properties - a cancel mid-render
gives a consistent partial film, a timeout stops before the first part,
an uncancelled control renders the plain render's image - with the port's
TILE_PIX lowered to split the film into tiles; and a control on the fixed
wavefront (a gaussian filter), which ignores it as the JAX package's
does.  The uncancelled image equals the plain one within the JAX test's
tolerance (the parts sum in another order)."""
import numpy as np

import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.integrators import regen
from liverrenderer_tpu_torch.scene.cornell import cornell_box
from torch_threads import torch_threads_per_worker  # noqa: F401


def _scene(rfilter="box"):
    d = cornell_box()
    d["integrator"] = {"type": "volpath", "max_depth": 3}
    d["sensor"]["film"] = {"type": "hdrfilm", "width": 16, "height": 16,
                           "rfilter": {"type": rfilter}}
    return lrt.load_dict(d, device="cpu")


def test_cancel_mid_render_yields_partial_film(monkeypatch):
    scene = _scene()
    monkeypatch.setattr(regen, "TILE_PIX", 64)       # 4 tiles
    calls = []
    ctl = lrt.RenderControl()

    def on_progress(f):
        calls.append(f)
        if f >= 0.5:
            ctl.cancel()

    ctl.on_progress = on_progress
    img = lrt.render(scene, spp=8, seed=0, control=ctl).numpy()
    assert ctl.stopped
    assert len(calls) > 0 and calls == sorted(calls)
    # rendered head, zero-weight (black) tail: a consistent partial film
    assert img[0].sum() > 0 and img[-1].sum() == 0.0
    pf = ctl.frame()
    assert pf is not None and tuple(pf.shape) == (16, 16, 3)
    assert np.isfinite(pf.numpy()).all()
    np.testing.assert_array_equal(pf.numpy(), img)


def test_timeout_stops_before_first_execution(monkeypatch):
    scene = _scene()
    monkeypatch.setattr(regen, "TILE_PIX", 64)
    ctl = lrt.RenderControl(timeout=1e-9)
    img = lrt.render(scene, spp=8, seed=0, control=ctl).numpy()
    assert ctl.stopped and img.sum() == 0.0 and ctl.frame() is None


def test_uncancelled_control_matches_plain_render(monkeypatch):
    """A control that never fires covers the same (pixel, sample) set."""
    scene = _scene()
    ref = lrt.render(scene, spp=8, seed=0).numpy()
    monkeypatch.setattr(regen, "TILE_PIX", 64)
    ctl = lrt.RenderControl()
    got = lrt.render(scene, spp=8, seed=0, control=ctl).numpy()
    assert not ctl.stopped
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    # one control drives the next render too: _arm restarts it
    got2 = lrt.render(scene, spp=8, seed=0, control=ctl).numpy()
    np.testing.assert_array_equal(got2, got)


def test_fixed_wavefront_ignores_the_control():
    """A gaussian filter takes the fixed wavefront, which renders whole:
    the control changes nothing, as in the JAX package."""
    scene = _scene("gaussian")
    assert not regen.regen_applicable(scene, "primal")
    ref = lrt.render(scene, spp=4, seed=0).numpy()
    ctl = lrt.RenderControl()
    ctl.cancel()
    got = lrt.render(scene, spp=4, seed=0, control=ctl).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not ctl.stopped


def test_box_splat_drops_a_sample_rounded_into_the_next_tile():
    """A film position px + u rounds up to the next pixel when u is
    within an ulp of 1; at a tile's last row that pixel lies in the next
    tile, and the sample is dropped, as the JAX package's scatter drops
    it (it indexed past the tile's film before)."""
    import torch
    scene = lrt.load_dict(cornell_box(), device="cpu")
    w = scene.film_w
    film = torch.zeros((2 * w, 4))          # a tile of the first two rows
    pos = torch.tensor([[3.5, 2.0], [3.5, 1.5]])   # row 2, then row 1
    L = torch.ones((2, 3))
    died = torch.tensor([True, True])
    regen._splat_died(scene, film, pos, L, died, pos[:, 1] < scene.film_h, 0)
    assert film[:, 3].sum() == 1.0 and film[w + 3, 3] == 1.0
