"""The a-trous denoiser (liverrenderer_tpu_torch/denoise.py) against the
JAX package's on the CPU: `atrous_denoise` on seeded buffers with and
without each guide (albedo, normals with a background of zero normals,
emission) and with a given or a local variance, `estimator_variance` and
`denoise_render` on the Cornell box at 12 x 12, 4 spp, depth 4.

Tolerance: every pixel within rtol 1e-5 (atol 1e-6): the same float32
filter, whose exp and pow of each weight round by an ulp or so
differently in XLA and torch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu import denoise as jdn
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch import denoise as tdn
from liverrenderer_tpu_torch.scene import cornell as tcornell
from liverrenderer_tpu_torch.scene.transform import Transform
from torch_sensor_scenes import matrices
from torch_threads import torch_threads_per_worker  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
H, W = 12, 16


def _close(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == np.shape(ref) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def buffers():
    """A noisy image over a two-tone albedo, normals with a background of
    zero normals, an emitter patch, and a per-pixel variance."""
    rng = np.random.default_rng(11)
    img = (0.4 + 0.3 * rng.random((H, W, 3))).astype(np.float32)
    img[2:5, 3:7] += 6.0                                  # the emitter
    img[9, 12] += 25.0                                     # a firefly
    albedo = np.full((H, W, 3), 0.6, np.float32)
    albedo[:, W // 2:] = [0.2, 0.5, 0.1]
    albedo[:2] = 0.0
    normal = rng.normal(size=(H, W, 3)).astype(np.float32) * 0.1 + [0, 0, 1]
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    normal[:2] = 0.0                                       # background
    emission = np.zeros((H, W, 3), np.float32)
    emission[2:5, 3:7] = 6.0
    var = (0.05 * rng.random((H, W))).astype(np.float32)
    var[9, 12] = 40.0
    return dict(img=img, albedo=albedo, normal=normal, emission=emission,
                variance=var)


GUIDES = {"none": (), "albedo": ("albedo",), "normal": ("normal",),
          "albedo_normal": ("albedo", "normal"),
          "variance": ("variance",),
          "all": ("albedo", "normal", "variance", "emission")}


@pytest.mark.parametrize("guides, iterations", [
    (g, 5 if g == "all" else 2) for g in sorted(GUIDES)])
def test_atrous_denoise_matches_jax(buffers, guides, iterations):
    kw = {k: buffers[k] for k in GUIDES[guides]}
    ref = jdn.atrous_denoise(jnp.asarray(buffers["img"]),
                             iterations=iterations,
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tdn.atrous_denoise(torch.as_tensor(buffers["img"]),
                             iterations=iterations, **kw)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    _close(got, ref)


def test_shift_and_local_variance_match_jax(buffers):
    lum = buffers["img"][..., 1]
    for dy, dx in ((-2, 3), (0, 0), (5, -16), (20, 1)):
        np.testing.assert_array_equal(
            tdn._shift2(torch.as_tensor(lum), dy, dx).numpy(),
            np.asarray(jdn._shift2(jnp.asarray(lum), dy, dx)))
    _close(tdn._local_variance(torch.as_tensor(lum)),
           jdn._local_variance(jnp.asarray(lum)))


@pytest.fixture(scope="module")
def cornell():
    """BASELINE's Cornell box at 16 x 12, depth 4, its camera turned a
    little so that no pixel centre looks along an edge of the box (where
    two walls tie), as tests/test_torch_cli.py's aux scenes."""
    d = tcornell.cornell_box()
    d["sensor"]["to_world"] = d["sensor"]["to_world"] @ Transform() \
        .rotate([0.3, 1.0, 0.1], 1.3)
    d = matrices(d)
    d["sensor"]["film"].update(width=W, height=H, rfilter={"type": "box"})
    d["integrator"]["max_depth"] = 4
    return lr.load_dict(d), lrt.load_dict(d, device="cpu")


def test_estimator_variance_matches_jax(cornell):
    js, ts = cornell
    jm, jv = jdn.estimator_variance(js, 4, seed=3)
    tm, tv = tdn.estimator_variance(ts, 4, seed=3)
    _close(tm, jm)
    _close(tv, jv)
    assert float(tv.max()) > 0


def test_denoise_render_matches_jax(cornell):
    js, ts = cornell
    ref = jdn.denoise_render(js, spp=4, seed=3, iterations=2)
    got = tdn.denoise_render(ts, spp=4, seed=3, iterations=2)
    _close(got, ref)
    noisy = lrt.render(ts, spp=4, seed=3).numpy()
    assert np.abs(got.numpy() - noisy).max() > 1e-3


def test_denoise_main_needs_the_card_or_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    xml = tmp_path / "scene.xml"
    xml.write_text("<scene version='3.0.0'/>")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdn.main([str(xml), "-o", str(tmp_path / "out.exr")])
    assert not (tmp_path / "out.exr").exists()
