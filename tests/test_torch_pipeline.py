"""The fork's liver pipeline in the port against the JAX package on the
CPU, on the same seeded inputs (tests/torch_pipeline_inputs.py: synthetic
spectra tables in the reference's layout, a RendererSettings.yml and a
scenes directory), with each package's `medium_models.DATA_DIR` pointed
at the written tables.

Tolerances: the Mie series, every element's coefficient and
compute_coefficients bit for bit (the same float64 numpy); the settings
reader equal to `yaml.safe_load`; the media's rows equal; the driver's
image as tests/test_torch_xml_slice.py's images (>= 99 % of pixels within
rtol 1e-3 / atol 1e-4, means within 1e-3); rmse, ssim and compare equal;
the soap substitute equal; evaluate's results.json values within 1e-6
absolute, its denoise block within 1e-5, and its side-by-side PNGs'
pixels equal to the JAX package's (written by PIL).  Every render at
16 x 12 or less, 4 spp or less, depth 4 or less: the evaluation runs
without downsampling (its goldens are written at the film's size) and
its denoise probe at 4 spp here (16 in CONFIGS).
"""
import json
import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import liverrenderer_tpu as lr
from liverrenderer_tpu.pipeline import driver as jdriver
from liverrenderer_tpu.pipeline import evaluate as jevaluate
from liverrenderer_tpu.pipeline import medium_models as jmm
from liverrenderer_tpu.pipeline import prepare_medium as jpm
from liverrenderer_tpu.pipeline import results as jresults
from liverrenderer_tpu.pipeline import substitute as jsub
from liverrenderer_tpu.scene import ir as jir
from liverrenderer_tpu.ssub import vae as jvae
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.io.exr import write_exr
from liverrenderer_tpu_torch.io.png import write_png
from liverrenderer_tpu_torch.pipeline import driver as tdriver
from liverrenderer_tpu_torch.pipeline import evaluate as tevaluate
from liverrenderer_tpu_torch.pipeline import medium_models as tmm
from liverrenderer_tpu_torch.pipeline import prepare_medium as tpm
from liverrenderer_tpu_torch.pipeline import results as tresults
from liverrenderer_tpu_torch.pipeline import settings_yaml
from liverrenderer_tpu_torch.pipeline import substitute as tsub
from liverrenderer_tpu_torch.scene import ir as tir
from liverrenderer_tpu_torch.ssub import vae as tvae
from liverrenderer_tpu_torch.tonemap import tonemap
import torch_pipeline_inputs as pin
from test_torch_xml_slice import _assert_images_agree
from torch_sss_inputs import substituted, write_model
from torch_threads import torch_threads_per_worker  # noqa: F401

W, H, SPP, DEPTH = 16, 12, 4, 4
# the proxy at test size: 320 triangles, a 32^2 height map, a 64 x 32 sky
SMALL_FILES = dict(subdiv=2, bump_res=32, sky=(64, 32))
VALUE_ATOL, DENOISE_ATOL = 1e-6, 1e-5


@pytest.fixture(scope="module", autouse=True)
def tables(tmp_path_factory):
    """The synthetic spectra, read by both packages."""
    data = pin.write_tables(str(tmp_path_factory.mktemp("data")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmm, "DATA_DIR", data)
        mp.setattr(tmm, "DATA_DIR", data)
        yield data


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scenes"))
    pin.write_scenes(root, W, H, SPP, max_depth=DEPTH, **SMALL_FILES)
    return root


@pytest.mark.parametrize("m", [1.05, 1.11, 1.2, 1.33, 1.5])
def test_mie_qsca_bit_for_bit(m):
    for x in (1e-3, 0.05, 0.7, 3.0, 10.0, 41.5, 123.0):
        assert tmm.mie_qsca(m, x) == jmm.mie_qsca(m, x), (m, x)
    assert tmm.mie_qsca(m, 0.0) == jmm.mie_qsca(m, 0.0) == 0.0


def _elements(mm):
    p = jpm.DEFAULTS
    coll, elas = mm.CollagenElement(), mm.ElastinElement()
    blood = mm.BloodElement(p["blood_vf"], p["blood_St02"], p["blood_R"])
    bile = mm.BileElement(p["bile_vf"])
    wl = mm.WaterLipidElement(p["water_vf"], p["lipid_vf"])
    return {
        "collagen": lambda lam: coll.coeff(0.81, 3.5, 1.35, 1.5, lam),
        "elastin": lambda lam: elas.coeff(0.189, 0.5, 1.33, 1.534, lam),
        "blood": blood.u_a, "blood_hbt": blood.u_a_hbt, "bile": bile.u_a,
        "water_lipid": wl.u_a,
        "hepatocyte": lambda lam: mm.hepatocyte_ug(0.8, 0.002, 0.003)
        * lam / 500.0,
    }


@pytest.mark.parametrize("name", ["collagen", "elastin", "blood",
                                  "blood_hbt", "bile", "water_lipid",
                                  "hepatocyte"])
def test_element_coefficients_bit_for_bit(name):
    """Each element at wavelengths below, inside and past its table, and
    rgb_bin over 360-710 nm."""
    t, j = _elements(tmm)[name], _elements(jmm)[name]
    for lam in (360, 371, 379, 400.5, 455, 542, 577, 700, 710):
        assert t(lam) == j(lam), (name, lam)
    np.testing.assert_array_equal(tmm.rgb_bin(t), jmm.rgb_bin(j))


@pytest.mark.parametrize("settings", [
    None, {"blood_vf": 0.002},
    {"collagen_vf1": 0.5, "elastin_d": 0.7, "water_vf": 0.6,
     "hepatocity_g_axis": 0.004}], ids=["defaults", "blood", "mixed"])
def test_compute_coefficients_bit_for_bit(settings):
    t = tpm.compute_coefficients(settings)
    assert t == jpm.compute_coefficients(settings)
    assert len(t) == 28 and all(np.isfinite(np.ravel(list(v))).all()
                                if isinstance(v, list) else np.isfinite(v)
                                for v in t.values())


SETTINGS_TEXTS = {
    "written": pin.settings_text(W, H, SPP, DEPTH),
    "overrides": pin.settings_text(
        428, 240, 64, 12, scene="GlissonCapsule",
        tissue={"blood_vf": 0.002, "collagen_d": 4}),
    "mixed": """# every scalar form of the subset
---
Scene: "Liver-SingleMesh"
Resolution:   # film
  Width: 1_920
  Height: 1080  # pixels
"Samples Per Pixel": 256
Max Depth: 65
'Max Depth ': 12
Flags:
  on: On
  no: no
  empty:
  tilde: ~
  path: a:b#c
  quoted: 'it''s # not a comment'
  escaped: "tab\\there \\"q\\""
  exp: 1.5e-3
  not_a_float: 1e5
  dot: .25
  neg: -7
  inf: -.inf
Glisson Capsule:
    collagen_vf1: 0.949
Parenchyma:

  blood_vf: 0.004
""",
}


@pytest.mark.parametrize("name", sorted(SETTINGS_TEXTS))
def test_settings_reader_matches_safe_load(name, tmp_path):
    p = tmp_path / "RendererSettings.yml"
    p.write_text(SETTINGS_TEXTS[name])
    assert settings_yaml.load(str(p)) == yaml.safe_load(p.read_text())


@pytest.mark.parametrize("text, line", [
    ("a: 1\nb: [1, 2]\n", 2), ("a:\n  - 1\n", 2), ("a: 0777\n", 1),
    ("a: 0x1f\n", 1), ("a: &anchor 1\n", 1), ("a: !!str 1\n", 1),
    ("a: |\n  text\n", 1), ("a: 2001-01-02\n", 1), ("a:\n\tb: 1\n", 2),
    ("a: b\n  c\n", 2), ("a: 'open\n", 1), ('a: "\\x41"\n', 1),
    ("a: {b: 1}\n", 1)])
def test_settings_reader_raises_outside_the_subset(text, line):
    with pytest.raises(ValueError, match=f"<string>:{line}:"):
        settings_yaml.loads(text)


def test_load_settings_equal(tmp_path):
    for name, text in SETTINGS_TEXTS.items():
        if name == "mixed":
            continue
        p = tmp_path / f"{name}.yml"
        p.write_text(text)
        assert tdriver.load_settings(str(p)) == jdriver.load_settings(str(p))
    assert tdriver.load_settings(str(p))["max_depth"] == 12


def test_apply_medium_coefficients_rows_equal(scenes):
    """A liver, a glissonCapsule, a parenchyma and a homogeneous row."""
    xml = os.path.join(scenes, tdriver.SCENE_DIRS["Liver-SingleMesh"])
    coeffs = tpm.compute_coefficients({"blood_vf": 0.002})
    js = lr.load_file(xml)
    ts = lrt.load_file(xml, device="cpu")
    types = [jir.MEDIUM_LIVER, jir.MEDIUM_GLISSON, jir.MEDIUM_PARENCHYMA,
             jir.MEDIUM_HOMOGENEOUS]
    assert types == [tir.MEDIUM_LIVER, tir.MEDIUM_GLISSON,
                     tir.MEDIUM_PARENCHYMA, tir.MEDIUM_HOMOGENEOUS]
    rows = np.tile(np.asarray(js.media.params)[:1], (4, 1))
    rows += np.arange(4, dtype=np.float32)[:, None] * 0.01
    import jax.numpy as jnp
    js = js.replace(media=js.media.replace(
        params=jnp.asarray(rows), mtype=jnp.asarray(types, jnp.int32)))
    ts = ts.replace(media=ts.media.replace(
        params=torch.as_tensor(rows),
        mtype=torch.as_tensor(types, dtype=ts.media.mtype.dtype)))
    got = tdriver.apply_medium_coefficients(ts, coeffs).media.params
    ref = np.asarray(jdriver.apply_medium_coefficients(js, coeffs)
                     .media.params)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not np.array_equal(ref[0], rows[0])
    np.testing.assert_array_equal(ref[3], rows[3])


def test_driver_run_matches_jax(scenes, tmp_path):
    """driver.run on the CPU against the JAX package's: the image, the
    EXR and PNG beside it, time.txt's lines; the coefficients reach the
    medium (the image differs from the unsubstituted render)."""
    settings = pin.write_settings(str(tmp_path / "s.yml"), W, H, SPP, DEPTH)
    out_t, out_j = tmp_path / "t", tmp_path / "j"
    out_j.mkdir()                 # the JAX driver writes into an existing one
    img = tdriver.run(settings, scenes, str(out_t), device="cpu")
    ref = np.asarray(jdriver.run(settings, scenes, str(out_j)))
    _assert_images_agree(img, ref)
    _assert_images_agree(lrt.read_image(str(out_t / "liver-singlemesh.exr")),
                         ref)
    png = np.asarray(Image.open(out_t / "liver-singlemesh.png"))
    assert png.shape == (H, W, 3)
    lines = (out_t / "time.txt").read_text().splitlines()
    ref_lines = (out_j / "time.txt").read_text().splitlines()
    assert [ln.split(":")[0] for ln in lines] == \
        [ln.split(":")[0] for ln in ref_lines]
    assert lines[:3] == ref_lines[:3] == [
        "Scene: Liver-SingleMesh", f"Resolution: {W}x{H}", f"SPP: {SPP}"]
    plain = lrt.render(lrt.load_file(
        os.path.join(scenes, tdriver.SCENE_DIRS["Liver-SingleMesh"]),
        device="cpu"), spp=SPP, seed=0).numpy()
    assert np.abs(plain - img).max() > 1e-3


def test_driver_main_needs_the_card_or_cpu(scenes, tmp_path):
    settings = pin.write_settings(str(tmp_path / "s.yml"), W, H, SPP, DEPTH)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdriver.main([settings, "--scenes-dir", scenes, "--out-dir",
                      str(tmp_path)])


@pytest.mark.parametrize("masked", [False, True])
def test_rmse_ssim_compare_equal(masked, tmp_path):
    rng = np.random.default_rng(5)
    a = rng.random((40, 36, 3)).astype(np.float32)
    b = (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros((40, 36), bool)
        mask[5:30, 8:20] = True
    assert tresults.rmse(a, b, mask) == jresults.rmse(a, b, mask)
    assert tresults.ssim(a, b, mask) == jresults.ssim(a, b, mask)
    assert tresults.ssim(a[..., 0], b[..., 0], mask) == \
        jresults.ssim(a[..., 0], b[..., 0], mask)
    write_exr(str(tmp_path / "a.exr"), a, half=False)
    write_exr(str(tmp_path / "b.exr"), b, half=False)
    mpath = None
    if masked:
        mpath = str(tmp_path / "m.exr")
        write_exr(mpath, np.repeat(mask[..., None], 3, -1)
                  .astype(np.float32), half=False)
    got = tresults.compare(str(tmp_path / "a.exr"), str(tmp_path / "b.exr"),
                           mpath)
    assert got == jresults.compare(str(tmp_path / "a.exr"),
                                   str(tmp_path / "b.exr"), mpath)
    assert got["rmse"] > 0 and got["ssim"] < 1


def test_soap_mesh_equal():
    tv, tf, tfit = tsub.soap_mesh()
    jv, jf, jfit = jsub.soap_mesh()
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert tfit == jfit and tv.dtype == np.float32 and tf.dtype == np.int32


@pytest.fixture
def probe_at_test_spp(monkeypatch):
    """The Liver-SingleMesh row's denoise probe at SPP (16 in CONFIGS)."""
    for mod in (jevaluate, tevaluate):
        xml, gold, mask, opts = mod.CONFIGS["Liver-SingleMesh"]
        monkeypatch.setitem(mod.CONFIGS, "Liver-SingleMesh",
                            (xml, gold, mask, dict(opts, denoise_probe=SPP)))


def _assert_rows_close(t, j, atol):
    assert set(t) == set(j), (set(t), set(j))
    for k, v in j.items():
        if k in ("render_s", "paths_per_s"):
            continue
        if isinstance(v, dict):
            _assert_rows_close(t[k], v, DENOISE_ATOL)
        elif isinstance(v, (list, float)):
            np.testing.assert_allclose(t[k], v, rtol=0, atol=atol,
                                       err_msg=k)
        else:
            assert t[k] == v, (k, t[k], v)


def test_evaluate_liver_singlemesh_matches_jax(scenes, tmp_path,
                                               probe_at_test_spp):
    """The PNG-golden row with its denoise probe: results.json and the
    side-by-side PNGs."""
    golden = os.path.join(scenes, pin.LIVER_GOLDEN)
    os.makedirs(os.path.dirname(golden), exist_ok=True)
    xml = os.path.join(scenes, tdriver.SCENE_DIRS["Liver-SingleMesh"])
    gold = lrt.render(lrt.load_file(xml, device="cpu"), spp=SPP, seed=9)
    write_png(golden, (tonemap(gold.numpy()) * 255 + 0.5).astype(np.uint8))
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    t = tevaluate.evaluate(scenes, out_t, 1, SPP, ["Liver-SingleMesh"],
                           device="cpu")
    j = jevaluate.evaluate(scenes, out_j, 1, SPP, ["Liver-SingleMesh"])
    with open(os.path.join(out_t, "results.json")) as f:
        assert json.load(f) == t
    row = t["Liver-SingleMesh"]
    assert "error" not in row, row
    _assert_rows_close(row, j["Liver-SingleMesh"], VALUE_ATOL)
    assert row["denoise"]["denoised_rmse"] < row["denoise"]["noisy_rmse"]
    for side in ("ours", "ref"):
        name = f"liver-singlemesh_{side}.png"
        got = np.asarray(Image.open(os.path.join(out_t, name)))
        ref = np.asarray(Image.open(os.path.join(out_j, name)))
        assert got.shape == (H, W, 3)
        np.testing.assert_array_equal(got, ref)


def test_evaluate_sss_row_matches_jax(tmp_path_factory, tmp_path):
    """The learned-SSS row: the soap substitute, the silhouette query,
    background metrics and the object means, with the synthetic VAE."""
    model = write_model(str(tmp_path_factory.mktemp("vae")), seed=3)
    root = str(tmp_path / "scenes")
    with substituted(*model, jvae, tvae):
        pin.write_sss_scene(root, W, H, SPP, golden_scale=1)
        t = tevaluate.evaluate(root, str(tmp_path / "t"), 1, SPP,
                               ["SphereLiverPoint-SSS"], device="cpu")
        j = jevaluate.evaluate(root, str(tmp_path / "j"), 1, SPP,
                               ["SphereLiverPoint-SSS"])
    row = t["SphereLiverPoint-SSS"]
    assert "error" not in row, row
    assert row["substitute_mesh"] is True and row["silhouette_iou"] > 0.5
    assert np.isfinite([row["rmse_background"], row["ssim_background"]]).all()
    _assert_rows_close(row, j["SphereLiverPoint-SSS"], VALUE_ATOL)


def test_evaluate_writes_an_error_row(tmp_path):
    """A scene that fails is its row's error, and the batch goes on."""
    root = tmp_path / "scenes"
    gold = root / pin.SSS_GOLDEN
    gold.parent.mkdir(parents=True)
    write_exr(str(gold), np.full((H, W, 3), 0.5, np.float32))
    (root / pin.SSS_XML).write_text("<scene><shape type='nosuch'/></scene>")
    t = tevaluate.evaluate(str(root), str(tmp_path / "t"), 1, SPP,
                           ["SphereLiverPoint-SSS", "Liver-MultiMesh"],
                           device="cpu")
    assert list(t) == ["SphereLiverPoint-SSS"] and "error" in t[
        "SphereLiverPoint-SSS"]
