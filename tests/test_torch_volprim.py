"""The radiance field over Gaussian-splat ellipsoids (`volprim_rf_basic`):
the port's builder, SH and transmittance functions, images and
`volprims.*` gradients against the JAX package's on the CPU, on
tests/test_volprim.py's splat scenes and a three-splat scene with
view-dependent SH (tests/torch_m10_scenes.py).

Tolerances: functions within 1e-6 (relative 1e-5) on seeded inputs;
images those of test_torch_nee_slice.py (>= 99 % of pixels within rtol
1e-3 / atol 1e-4, the mean within 1e-3 relative); gradients per entry
within its G_ATOL_REL = 3e-6 of the largest entry (the per-lane sums run
in another order).  Measured: images within 2e-7, gradients within 6e-8
of the JAX package's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
import liverrenderer_tpu_torch as lrt
import torch_m10_scenes as ms
from liverrenderer_tpu.integrators import volprim as jvp
from liverrenderer_tpu_torch.bridge import numpy_tree, scene_from_numpy
from liverrenderer_tpu_torch.integrators import volprim as tvp
from torch_threads import torch_threads_per_worker  # noqa: F401

PIX_RTOL, PIX_ATOL, PIX_FRAC, MEAN_RTOL = 1e-3, 1e-4, 0.99, 1e-3
G_ATOL_REL = 3e-6
C0 = ms.C0
KEYS = ("volprims.opacity", "volprims.sh")


def _assert_images_agree(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.abs(img - ref) <= PIX_ATOL + PIX_RTOL * np.abs(ref)
    assert close.all(-1).mean() >= PIX_FRAC
    assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())


def _rows(centers, sigma):
    return ms.splat_rows(centers, sigma)


SCENES = {
    # test_volprim.py's scenes
    "head_on": lambda srgb: ms.splat_dict(
        _rows([[0, 0, 0]], 0.5), np.full((1, 1, 3), 0.5 / C0, np.float32),
        [0.7], srgb=srgb),
    "front_to_back": lambda srgb: ms.splat_dict(
        _rows([[0, 0, 1.0], [0, 0, -1.0]], 0.4),
        np.full((2, 1, 3), 0.5 / C0, np.float32), [0.7, 0.5], srgb=srgb),
    "sh_back": lambda srgb: ms.splat_dict(
        _rows([[0, 0, 0]], 0.5),
        np.concatenate([np.full((1, 1, 3), 0.5 / C0),
                        np.float32([[[0, 0, 0], [0.4] * 3, [0, 0, 0]]])],
                       1).astype(np.float32), [0.9], cam_z=-4.0, srgb=srgb),
    "three_deg2": lambda srgb: ms.three_splats(srgb=srgb, degree=2),
    "three_deg3": lambda srgb: ms.three_splats(srgb=srgb, degree=3),
}


@pytest.mark.parametrize("kind,srgb", [
    ("head_on", False), ("front_to_back", False), ("sh_back", False),
    ("three_deg2", False), ("head_on", True), ("three_deg3", True)])
def test_volprim_render_matches_jax_per_pixel(kind, srgb):
    d = SCENES[kind](srgb)
    ref = np.asarray(lr.render(lr.load_dict(d), spp=4, seed=0))
    ts = lrt.load_dict(d, device="cpu")
    assert ts.volprims.srgb == srgb and ts.integrator == "volprim_rf_basic"
    img = lrt.render(ts, spp=4, seed=0).numpy()
    _assert_images_agree(img, ref)
    assert img.mean() > 0.01


def test_ellipsoids_and_volprims_build_as_jax():
    """The instanced icospheres (80 triangles a splat at subdiv 1), the
    normals R (n / s), the splat table with its SH padded to the largest
    K and tri_ell -1 on the triangles of other shapes; max_depth defaults
    to 64 and srgb_primitives to True."""
    d = ms.three_splats(degree=1)
    d["splats2"] = {"type": "ellipsoidsmesh",
                    "centers": np.float32([[0.3, 0.3, -1.0]]),
                    "scales": np.float32([[0.2, 0.1, 0.3]]),
                    "quaternions": np.float32([[0.0, 0.6, 0.0, 0.8]]),
                    "extent": 2.0, "opacities": [0.4],
                    "sh_coeffs": np.full((1, 9, 3), 0.3, np.float32)}
    d["plain"] = {"type": "rectangle", "to_world": lrt.Transform()
                  .translate([0, 0, -3]).matrix.copy()}
    del d["integrator"]["max_depth"], d["integrator"]["srgb_primitives"]
    js, ts = lr.load_dict(d), lrt.load_dict(d, device="cpu")
    assert ts.n_tris == 4 * 80 + 2 and ts.max_depth == 64
    assert ts.volprims.count == 4 and ts.volprims.sh_degree == 2
    assert ts.volprims.srgb
    ja, _ = numpy_tree(js)
    ta, _ = numpy_tree(ts)
    for k in ("vertices", "faces", "tri_si", "volprims.center",
              "volprims.scale", "volprims.rot", "volprims.opacity",
              "volprims.sh", "volprims.tri_ell", "shape_area"):
        np.testing.assert_allclose(ta[k], ja[k].astype(ta[k].dtype),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert (ta["volprims.tri_ell"][-2:] == -1).all()


def test_sh_and_transmission_match_jax():
    rng = np.random.default_rng(11)
    d = rng.normal(size=(512, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    for deg in range(4):
        np.testing.assert_allclose(
            tvp.sh_eval(torch.from_numpy(d), deg).numpy(),
            np.asarray(jvp.sh_eval(jnp.asarray(d), deg)), rtol=1e-5,
            atol=1e-6)
    js = lr.load_dict(ms.three_splats(degree=3))
    ts = scene_from_numpy(*numpy_tree(js), "cpu")
    o = rng.uniform(-1, 1, (512, 3)).astype(np.float32)
    ell = rng.integers(-1, 3, 512)
    jt = jvp.eval_transmission(js, jnp.asarray(ell), jnp.asarray(o),
                               jnp.asarray(d))
    tt = tvp.eval_transmission(ts, torch.from_numpy(ell), torch.from_numpy(o),
                               torch.from_numpy(d))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5,
                               atol=1e-6)
    je = jvp.eval_sh_emission(js, jnp.asarray(ell), jnp.asarray(d))
    te = tvp.eval_sh_emission(ts, torch.from_numpy(ell), torch.from_numpy(d))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kind,srgb,degree", [
    ("three", False, 1), ("three", True, 3), ("front_to_back", False, 0)])
def test_volprims_gradients_match_jax(kind, srgb, degree):
    """render_grad of the mean image with respect to volprims.opacity and
    volprims.sh, through the scan adjoint in both packages (the replay
    does not carry volprim_rf_basic), per entry."""
    d = ms.three_splats(srgb=srgb, degree=degree) if kind == "three" \
        else SCENES[kind](srgb)
    js, ts = lr.load_dict(d), lrt.load_dict(d, device="cpu")
    jp = lr.traverse(js)
    _, gj, ij = lr.render_grad(js, {k: jp[k] for k in KEYS}, jnp.mean,
                               spp=4, seed=3)
    tp = lrt.traverse(ts, KEYS)
    _, gt, it = lrt.render_grad(ts, {k: tp[k] for k in KEYS}, torch.mean,
                                spp=4, seed=3)
    _assert_images_agree(it.numpy(), np.asarray(ij))
    for k in KEYS:
        a, b = np.asarray(gj[k]), gt[k].numpy()
        assert b.shape == a.shape and np.isfinite(b).all()
        assert np.abs(a).max() > 0, k
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=G_ATOL_REL * np.abs(a).max(),
                                   err_msg=k)


def test_scan_adjoint_serves_volprim_scenes():
    from liverrenderer_tpu_torch.integrators import prb_replay
    ts = lrt.load_dict(ms.three_splats(), device="cpu")
    assert not prb_replay.replay_applicable(
        ts, {"volprims.opacity": ts.volprims.opacity}, 4)


def test_jax_built_volprim_scene_renders_the_ports_image():
    """bridge.scene_from_numpy of a JAX-built splat scene carries the
    splat table (its arrays and statics) and renders the image of the
    port's own build."""
    d = ms.three_splats(srgb=True, degree=3)
    js = lr.load_dict(d)
    arrays, statics = numpy_tree(js)
    assert statics["volprims.sh_degree"] == 3 and statics["volprims.srgb"]
    ts = scene_from_numpy(arrays, statics, "cpu")
    assert ts.volprims.count == 3 and ts.volprims.sh.shape == (3, 16, 3)
    own = lrt.load_dict(d, device="cpu")
    np.testing.assert_array_equal(lrt.render(ts, spp=2, seed=1).numpy(),
                                  lrt.render(own, spp=2, seed=1).numpy())


def test_volprims_forward_gradient_matches_jax():
    """render_fwd_grad (a JVP with unit tangents through the scan walk)
    of volprims.opacity."""
    d = ms.three_splats(degree=1)
    js, ts = lr.load_dict(d), lrt.load_dict(d, device="cpu")
    _, jv = lr.render_fwd_grad(js, {KEYS[0]: js.volprims.opacity}, spp=2)
    _, tv = lrt.render_fwd_grad(ts, {KEYS[0]: ts.volprims.opacity}, spp=2)
    jv = np.asarray(jv)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0,
                               atol=G_ATOL_REL * np.abs(jv).max())
