"""Curve tubes and the hair fiber BSDF: the port against the JAX package
on the CPU (tests/test_curves_hair.py's four tests, each against JAX).

Tolerances:
- scene/curves.py (load_curve_file, bspline_to_polyline, tube_mesh,
  curve_mesh) and the builders' tangent tables bit for bit (host numpy);
- hair_eval_pdf and hair_sample per lane on 4,096 seeded lanes per
  parameter set: every lane within rtol 2e-3 / atol 1e-6 (value, pdf,
  weight; wo at atol 2e-5) and all but at most 1 % of the lanes within
  rtol 1e-4.  The longitudinal lobe M_p is exp(log I0(a) - b - 1/v ...)
  with 1/v ~ 200 at beta_m = 0.08: an ulp of XLA's and PyTorch's exp,
  log, sinh and atan2 (and XLA's FMA contraction) grows to ~6e-4 of it;
  the sampled lobe is held exactly on every lane;
- compute_si's tangent frame per lane within 2e-6;
- images >= 99 % of pixels within rtol 1e-3 / atol 1e-4 and the means
  within 1e-3 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu.accel import intersect as jint
from liverrenderer_tpu.bsdf import hair as jhair
from liverrenderer_tpu.core.types import Ray as JRay
from liverrenderer_tpu.scene import curves as jcurves
from liverrenderer_tpu.scene.transform import Transform as JTransform
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.accel import intersect as tint
from liverrenderer_tpu_torch.bridge import numpy_tree
from liverrenderer_tpu_torch.bsdf import hair as thair
from liverrenderer_tpu_torch.core.types import Ray as TRay
from liverrenderer_tpu_torch.scene import curves as tcurves
from liverrenderer_tpu_torch.scene.transform import Transform
from torch_m10_scenes import (curve_dict, straight_fiber,
                              write_bspline_strand, write_hair_tuft)
from torch_threads import torch_threads_per_worker  # noqa: F401

PIX_RTOL, PIX_ATOL, PIX_FRAC, MEAN_RTOL = 1e-3, 1e-4, 0.99, 1e-3
N = 4096
LOOSE_RTOL, TIGHT_RTOL, MAX_LOOSE_FRAC = 2e-3, 1e-4, 0.01

RED = {"type": "diffuse", "reflectance": {"type": "rgb",
                                          "value": [0.9, 0.1, 0.1]}}


def _hair(sig):
    return {"type": "hair", "sigma_a": {"type": "rgb", "value": [sig] * 3}}


def test_curve_functions_bit_equal(tmp_path):
    """The curve file reader, the B-spline sampling, the tube and the
    whole curve mesh (under a rotation and scale) equal the JAX
    package's bit for bit."""
    path = str(tmp_path / "tuft.txt")
    write_hair_tuft(path, 5, seed=3, n_ctrl=7)
    cj, ct = jcurves.load_curve_file(path), tcurves.load_curve_file(path)
    assert len(ct) == len(cj) == 5
    for (pj, rj), (pt, rt) in zip(cj, ct):
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(rt, rj)
        for sub in (1, 4):
            for a, b in zip(tcurves.bspline_to_polyline(pt, rt, sub),
                            jcurves.bspline_to_polyline(pj, rj, sub)):
                np.testing.assert_array_equal(a, b)
        mt, tt = tcurves.tube_mesh(pt, rt, 5)
        mj, tj = jcurves.tube_mesh(pj, rj, 5)
        for k in ("vertices", "faces", "normals", "uvs"):
            np.testing.assert_array_equal(getattr(mt, k), getattr(mj, k))
        np.testing.assert_array_equal(tt, tj)
    for t in ("bsplinecurve", "linearcurve"):
        d = {"type": t, "filename": path, "subdiv": 3, "sides": 6}
        mt, tt = tcurves.curve_mesh(
            d, ".", Transform().rotate([0, 1, 1], 30.0).scale(1.5))
        mj, tj = jcurves.curve_mesh(
            d, ".", JTransform().rotate([0, 1, 1], 30.0).scale(1.5))
        np.testing.assert_array_equal(mt.vertices, mj.vertices)
        np.testing.assert_array_equal(mt.faces, mj.faces)
        np.testing.assert_array_equal(mt.normals, mj.normals)
        np.testing.assert_array_equal(tt, tj)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _close_lanes(t, j, name, atol=1e-6):
    """Every lane within LOOSE_RTOL, all but MAX_LOOSE_FRAC of them within
    TIGHT_RTOL."""
    t, j = t.numpy(), np.asarray(j)
    np.testing.assert_allclose(t, j, rtol=LOOSE_RTOL, atol=atol,
                               err_msg=name)
    bad = ~(np.abs(t - j) <= atol + TIGHT_RTOL * np.abs(j))
    assert bad.reshape(len(bad), -1).any(-1).mean() <= MAX_LOOSE_FRAC, name


@pytest.mark.parametrize("prm", [
    (1.55, 0.3, 0.3, 2.0), (1.55, 0.08, 0.5, 4.0), (1.3, 0.6, 0.2, 0.0)],
    ids=["default", "smooth", "rough"])
def test_hair_lanes_match_jax(prm):
    """hair_eval_pdf at seeded direction pairs and hair_sample at seeded
    (u1, u2), with seeded sigma_a in [0, 3), per lane."""
    rng = np.random.default_rng(7)
    wi, wo = _unit(rng, N), _unit(rng, N)
    p = np.tile(np.float32([prm[0], prm[1], prm[2], np.deg2rad(prm[3])]),
                (N, 1))
    sa = rng.uniform(0, 3, (N, 3)).astype(np.float32)
    u1 = rng.uniform(size=N).astype(np.float32)
    u2 = rng.uniform(size=(N, 2)).astype(np.float32)
    tv, tp = thair.hair_eval_pdf(*map(torch.from_numpy, (wi, wo, p, sa)))
    jv, jp = jhair.hair_eval_pdf(*map(jnp.asarray, (wi, wo, p, sa)))
    _close_lanes(tv, jv, "value")
    _close_lanes(tp, jp, "pdf")
    assert (tp > 0).float().mean() > 0.9
    ts = thair.hair_sample(*map(torch.from_numpy, (wi, u1, u2, p, sa)))
    js = jhair.hair_sample(*map(jnp.asarray, (wi, u1, u2, p, sa)))
    _close_lanes(ts[0], js[0], "wo", atol=2e-5)
    for k, a, b in zip(("pdf", "weight", "eta"), ts[1:4], js[1:4]):
        _close_lanes(a, b, k)
    np.testing.assert_array_equal(ts[4].numpy(), np.asarray(js[4]))
    # the sampled direction is a unit vector
    assert torch.allclose(ts[0].norm(dim=-1), torch.ones(N), atol=1e-5)


def test_tangent_frames_on_tube():
    """compute_si on the straight fiber: the frame's s axis along the
    fiber (tests/test_curves_hair.py's check), and per lane against JAX
    on seeded rays."""
    d = curve_dict(straight_fiber({"type": "hair"}), 8)
    js = lr.load_dict(d)
    ts = lrt.load_dict(d, device="cpu")
    ja, jst = numpy_tree(js)
    ta, tst = numpy_tree(ts)
    for k in ("tangents", "vertices", "faces", "normals", "tri_si"):
        np.testing.assert_array_equal(ta[k], np.asarray(ja[k]), err_msg=k)
    assert tst["has_tangents"] and jst["has_tangents"]
    rng = np.random.default_rng(4)
    o = np.concatenate([rng.uniform(-0.4, 0.4, (N, 1)),
                        rng.uniform(-1.2, 1.2, (N, 1)),
                        np.full((N, 1), 3.0)], -1).astype(np.float32)
    o[0] = (0.0, 0.2, 3.0)
    dd = np.tile(np.float32([[0.0, 0.0, -1.0]]), (N, 1))
    mx = np.full(N, np.inf, np.float32)
    a = jint.ray_intersect(js, JRay(o=jnp.asarray(o), d=jnp.asarray(dd),
                                    maxt=jnp.asarray(mx)))
    b = tint.ray_intersect(ts, TRay(o=torch.from_numpy(o),
                                    d=torch.from_numpy(dd),
                                    maxt=torch.from_numpy(mx)))
    hit = np.isfinite(np.asarray(a.t))
    np.testing.assert_array_equal(b.valid.numpy(), hit)
    assert hit[0] and hit.mean() > 0.3
    for k in ("s", "t", "n"):
        np.testing.assert_allclose(getattr(b.sh_frame, k).numpy()[hit],
                                   np.asarray(getattr(a.sh_frame, k))[hit],
                                   atol=2e-6, err_msg=k)
    np.testing.assert_allclose(b.wi.numpy()[hit], np.asarray(a.wi)[hit],
                               atol=2e-6)
    assert abs(abs(float(b.sh_frame.s[0, 1])) - 1.0) < 1e-3
    assert float(b.sh_frame.n[0, 2]) > 0.7


def _assert_images_agree(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.abs(img - ref) <= PIX_ATOL + PIX_RTOL * np.abs(ref)
    assert close.all(-1).mean() >= PIX_FRAC
    assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())


def _render_pair(d, spp):
    ref = np.asarray(lr.render(lr.load_dict(d), spp=spp, seed=0))
    img = lrt.render(lrt.load_dict(d, device="cpu"), spp=spp,
                     seed=0).numpy()
    _assert_images_agree(img, ref)
    return img


def test_linearcurve_tube_renders():
    img = _render_pair(curve_dict(straight_fiber(RED), 16), 8)
    assert img[8, 8, 0] > 3 * img[8, 8, 1]
    assert abs(img[8, 1].mean() - 1.0) < 0.1


def test_bsplinecurve_from_file(tmp_path):
    path = str(tmp_path / "c.txt")
    write_bspline_strand(path)
    img = _render_pair(curve_dict({"type": "bsplinecurve", "filename": path,
                                   "bsdf": {"type": "diffuse"}}, 16), 8)
    # the horizontal strand crosses the middle rows
    assert img[7:9, 5:11].mean() < 0.95


def test_hair_on_curve_absorption():
    """The hair fiber at sigma_a 0.05 and 3.0 (16^2, 16 spp) per pixel;
    stronger absorption darkens it (the TT and TRT lobes attenuate)."""
    light = _render_pair(curve_dict(straight_fiber(_hair(0.05), 0.35), 16),
                         16)
    dark = _render_pair(curve_dict(straight_fiber(_hair(3.0), 0.35), 16), 16)
    assert dark[6:10, 6:10].mean() < light[6:10, 6:10].mean()
