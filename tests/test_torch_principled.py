"""The principled, principledthin and measured BSDFs of the port against
the JAX package on identical inputs (made with numpy from a seed): sample,
eval and pdf on 4,096 lanes per parameter set, the builders' rows, 16^2
images per pixel, the bsdfs.params gradient, and the RGL tensor file.

Tolerance: fp32, rtol 1e-5 with atol 1e-6 on every lane of eval and pdf
at the seeded directions (both packages run the same formulas in
float32), and on all but at most 16 of the 4,096 lanes of what a sample
returns and of eval and pdf at the sampled directions; the lobe a sample
picks is held exactly.  Those few lanes carry the ulps of their
direction: a visible-normal sample's p3 = sqrt(1 - p1^2 - p2^2) near the
rim of the projected disk, or a refraction's cos_theta_t, turns an ulp of
cos/sin/sqrt into up to 5e-6 of wo, which a grazing lane's pdf and weight
magnify to ~2e-4 relative, and a clearcoat's GTR1 at alpha 0.04 turns an
ulp of cos_theta_h into 2e-5 of D (seen on 0-2 lanes per quantity and
parameter set).  They are held at atol 1e-5 (wo), rtol 3e-4 (the
sample's pdf, eta and weight) and rtol 1e-4 (eval and pdf at the sampled
directions).  Images: >= 99 % of pixels within rtol 1e-4 and the mean
within 1e-5 relative.

The bsdfs.params gradient runs from tests/test_torch_principled_grad.py,
which shares this file's scenes and tolerances, so that xdist's file
scheduler can start it apart from this file (a long file holds one
worker to its end).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu.bsdf import dispatch as jbsdf
from liverrenderer_tpu.bsdf import measured as jms
from liverrenderer_tpu.core import math as jm
from liverrenderer_tpu.core.types import SurfaceInteraction as JSI
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.bridge import numpy_tree, scene_from_numpy
from liverrenderer_tpu_torch.bsdf import dispatch as tbsdf
from liverrenderer_tpu_torch.bsdf import measured as tms
from liverrenderer_tpu_torch.core import math as tm
from liverrenderer_tpu_torch.core.types import SurfaceInteraction as TSI
from liverrenderer_tpu_torch.scene import ir
from liverrenderer_tpu_torch.scene.transform import Transform
from torch_m10_scenes import (PRINCIPLED, bsdf_plane_dict,
                              measured_plate_dict, synthetic_measured)
from torch_threads import torch_threads_per_worker  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
N = 4096
MAX_LOOSE = 16        # lanes of N held only at the loose tolerance


def _close(t, j, name="", rtol=RTOL, atol=ATOL):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    if np.issubdtype(j.dtype, np.floating):
        np.testing.assert_allclose(t, j, rtol=rtol, atol=atol, err_msg=name)
    else:
        np.testing.assert_array_equal(t, j.astype(t.dtype), err_msg=name)


def _close_lanes(t, j, name, rtol=RTOL, atol=ATOL, loose_rtol=0.0,
                 loose_atol=ATOL):
    """Every lane within (loose_rtol, loose_atol), and all but at most
    MAX_LOOSE lanes within (rtol, atol)."""
    t, j = t.numpy(), np.asarray(j)
    np.testing.assert_allclose(t, j, rtol=loose_rtol, atol=loose_atol,
                               err_msg=name)
    bad = ~(np.abs(t - j) <= atol + rtol * np.abs(j))
    n_bad = int(bad.reshape(len(bad), -1).any(-1).sum())
    assert n_bad <= MAX_LOOSE, (name, n_bad)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _si_pair(rng, n):
    """Random shading frames, incident directions on both sides, uvs."""
    ng = _unit(rng, n)
    wi = _unit(rng, n)
    p = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    uv = rng.uniform(size=(n, 2)).astype(np.float32)
    t = np.ones(n, np.float32)
    js = JSI(t=jnp.asarray(t), p=jnp.asarray(p), ng=jnp.asarray(ng),
             sh_frame=jm.make_frame(jnp.asarray(ng)), uv=jnp.asarray(uv),
             wi=jnp.asarray(wi), prim=jnp.zeros(n, jnp.int32),
             shape=jnp.zeros(n, jnp.int32))
    ts = TSI(t=torch.from_numpy(t), p=torch.from_numpy(p),
             ng=torch.from_numpy(ng),
             sh_frame=tm.make_frame(torch.from_numpy(ng)),
             uv=torch.from_numpy(uv), wi=torch.from_numpy(wi),
             prim=torch.zeros(n, dtype=torch.int64),
             shape=torch.zeros(n, dtype=torch.int64))
    return js, ts


def _scenes(d):
    js = lr.load_dict(d)
    return js, scene_from_numpy(*numpy_tree(js), "cpu")


def _lanes_match(js, ts, rng, row):
    """Sample, eval and pdf of BSDF row `row` on N seeded lanes."""
    jsi, tsi = _si_pair(rng, N)
    u1 = rng.uniform(size=N).astype(np.float32)
    u2 = rng.uniform(size=(N, 2)).astype(np.float32)
    wo = _unit(rng, N)
    idx = np.full(N, row)
    ti, ji = torch.from_numpy(idx), jnp.asarray(idx, jnp.int32)
    tb = tbsdf.bsdf_sample(ts, tsi, ti, torch.from_numpy(u1),
                           torch.from_numpy(u2))
    jb = jbsdf.bsdf_sample(js, jsi, ji, jnp.asarray(u1), jnp.asarray(u2))
    _close(tb.sampled_type, jb.sampled_type, "sampled_type")
    _close_lanes(tb.wo, jb.wo, "wo", loose_atol=1e-5)
    for k in ("pdf", "eta", "weight"):
        _close_lanes(getattr(tb, k), getattr(jb, k), k, loose_rtol=3e-4)
    assert (tb.pdf > 0).sum() > N // 4
    tv, tp = tbsdf.bsdf_eval_pdf(ts, tsi, ti, torch.from_numpy(wo))
    jv, jp = jbsdf.bsdf_eval_pdf(js, jsi, ji, jnp.asarray(wo))
    _close(tv, jv, "val")
    _close(tp, jp, "pdf")
    assert (tp > 0).sum() > N // 8
    # the sampled directions evaluate alike in both packages
    tv2, tp2 = tbsdf.bsdf_eval_pdf(ts, tsi, ti, tb.wo)
    jv2, jp2 = jbsdf.bsdf_eval_pdf(js, jsi, ji, jnp.asarray(tb.wo.numpy()))
    _close_lanes(tv2, jv2, "val(sampled)", loose_rtol=1e-4)
    _close_lanes(tp2, jp2, "pdf(sampled)", loose_rtol=1e-4)


@pytest.mark.parametrize("case", list(PRINCIPLED))
def test_principled_lanes_match(case):
    js, ts = _scenes(bsdf_plane_dict(PRINCIPLED[case], res=4))
    row = int(ts.shape_bsdf[0])
    assert int(ts.bsdfs.btype[row]) in (ir.BSDF_PRINCIPLED,
                                        ir.BSDF_PRINCIPLEDTHIN)
    _lanes_match(js, ts, np.random.default_rng(11), row)


def test_principled_builder_rows_equal():
    """Both builders write the same rows: eta from `specular`, the two
    plausibility clamps, textured scalar slots falling back to their
    defaults, F_GLOSSY_TRANS only with spec_trans, twosided only without
    transmission, principledthin always twosided."""
    tex = {"type": "checkerboard"}
    bsdfs = dict(PRINCIPLED)
    bsdfs.update({
        "clamp_eta": {"type": "principled", "spec_trans": 0.5, "eta": 1.0},
        "clamp_spec": {"type": "principled", "spec_trans": 0.5,
                       "specular": 0.0},
        "textured": {"type": "principled", "metallic": tex,
                     "roughness": tex, "sheen": tex, "specular": tex},
        "twosided": {"type": "twosided",
                     "bsdf": {"type": "principled", "roughness": 0.3}},
        "twosided_trans": {"type": "twosided",
                           "bsdf": {"type": "principled",
                                    "spec_trans": 0.2}},
        "thin_textured": {"type": "principledthin", "eta": tex,
                          "diff_trans": tex}})
    d = bsdf_plane_dict(bsdfs["core"], res=4)
    for i, (k, b) in enumerate(bsdfs.items()):
        d[k] = {"type": "rectangle", "bsdf": b,
                "to_world": Transform().translate([0, 0, -1.0 - i])
                .matrix.copy()}
    pa, ps = numpy_tree(lrt.load_dict(d, device="cpu"))
    ja, jst = numpy_tree(lr.load_dict(d))
    for k in pa:
        if k.startswith(("bsdfs.", "textures.", "shape_bsdf")):
            np.testing.assert_array_equal(pa[k], ja[k].astype(pa[k].dtype),
                                          err_msg=k)
    for k in ("bsdfs.types_present", "needs_surface_nee"):
        assert ps[k] == jst[k], k
    assert (pa["bsdfs.btype"] == ir.BSDF_PRINCIPLED).sum() >= 7


def _image_close(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-3)
    assert (rel <= 1e-4).mean() >= 0.99, (name, np.quantile(rel, 0.99))
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("case,below", [("clearcoat_sheen", False),
                                        ("spec_trans", True),
                                        ("thin", True)])
def test_principled_image_matches(case, below):
    js, ts = _scenes(bsdf_plane_dict(PRINCIPLED[case], res=16,
                                     from_below=below))
    _image_close(lrt.render(ts, spp=8, seed=2), lr.render(js, spp=8, seed=2),
                 case)


# ---------------------------------------------------------------------------
# measured
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def measured_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("measured") / "m.bsdf")
    jms.write_tensor_file(path, synthetic_measured(seed=4))
    return path


def test_tensor_file_reads_equal(measured_file, tmp_path):
    """A file written by the JAX package reads the same in both; the
    port's writer writes the same bytes; the port's builder loads the
    file into the same table as the JAX package's as_device_table."""
    jf = jms.load_tensor_file(measured_file)
    tf = tms.load_tensor_file(measured_file)
    assert list(jf) == list(tf)
    for k in jf:
        assert jf[k].dtype == tf[k].dtype, k
        np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
    p2 = str(tmp_path / "again.bsdf")
    tms.write_tensor_file(p2, synthetic_measured(seed=4))
    assert open(p2, "rb").read() == open(measured_file, "rb").read()
    jt = jms.as_device_table([jms.MeasuredData(measured_file)])
    tt = lrt.load_dict(measured_plate_dict(measured_file),
                       device="cpu").measured
    for k in ("theta_i", "vndf_row", "vndf_cond", "vndf_pdf", "lum_row",
              "lum_cond", "lum_pdf", "spectra", "ndf", "sigma"):
        np.testing.assert_array_equal(getattr(tt, k).numpy(),
                                      np.asarray(getattr(jt, k)), err_msg=k)
    assert tt.enabled and tt.jacobian == jt.jacobian


def test_measured_lanes_and_image_match(measured_file):
    js, ts = _scenes(measured_plate_dict(measured_file))
    row = int(ts.shape_bsdf[0])
    assert int(ts.bsdfs.btype[row]) == ir.BSDF_MEASURED
    rng = np.random.default_rng(5)
    jsi, tsi = _si_pair(rng, N)
    u1 = rng.uniform(size=N).astype(np.float32)
    u2 = rng.uniform(size=(N, 2)).astype(np.float32)
    idx = np.full(N, row)
    ti, ji = torch.from_numpy(idx), jnp.asarray(idx, jnp.int32)
    tb = tbsdf.bsdf_sample(ts, tsi, ti, torch.from_numpy(u1),
                           torch.from_numpy(u2))
    jb = jbsdf.bsdf_sample(js, jsi, ji, jnp.asarray(u1), jnp.asarray(u2))
    ok = np.asarray(jb.pdf) > 0
    assert ok.sum() > N // 8
    _close(tb.pdf, jb.pdf, "pdf", rtol=1e-4)
    _close(tb.wo.numpy()[ok], np.asarray(jb.wo)[ok], "wo", rtol=0, atol=1e-5)
    _close(tb.weight, jb.weight, "weight", rtol=1e-4, atol=1e-5)
    wo = tb.wo
    tv, tp = tbsdf.bsdf_eval_pdf(ts, tsi, ti, wo)
    jv, jp = jbsdf.bsdf_eval_pdf(js, jsi, ji, jnp.asarray(wo.numpy()))
    _close(tv, jv, "val", rtol=1e-4, atol=1e-5)
    _close(tp, jp, "pdf(eval)", rtol=1e-4, atol=1e-5)
    _image_close(lrt.render(ts, spp=8, seed=1), lr.render(js, spp=8, seed=1),
                 "measured")
    # the builder's own load of the file: the same table
    ls = lrt.load_dict(measured_plate_dict(measured_file), device="cpu")
    np.testing.assert_array_equal(ls.measured.vndf_cond.numpy(),
                                  ts.measured.vndf_cond.numpy())


@pytest.mark.parametrize("case", ["clearcoat_sheen", "thin", "measured"])
def test_spectral_variant_images_match(case, measured_file):
    """The three BSDFs in the spectral variant (the JAX builder admits
    them): both builders load them, and the 12^2 images agree per
    pixel."""
    d = measured_plate_dict(measured_file, 12) if case == "measured" else \
        bsdf_plane_dict(PRINCIPLED[case], 12, from_below=case == "thin")
    js = lr.load_dict(d, variant="spectral")
    ts = scene_from_numpy(*numpy_tree(js), "cpu")
    own = lrt.load_dict(d, device="cpu", variant="spectral")
    assert ts.spectral and own.spectral
    img = lrt.render(ts, spp=4, seed=1)
    _image_close(img, lr.render(js, spp=4, seed=1), case)
    np.testing.assert_array_equal(lrt.render(own, spp=4, seed=1).numpy(),
                                  img.numpy())


def test_hair_still_raises():
    """Hair, which raised until the curves came, loads (its fiber frames
    come from curve tubes: tests/test_torch_curves_hair.py holds its
    lanes and images against the JAX package)."""
    d = bsdf_plane_dict({"type": "hair"}, res=4)
    assert ir.BSDF_HAIR in lrt.load_dict(d, device="cpu").bsdfs.types_present
