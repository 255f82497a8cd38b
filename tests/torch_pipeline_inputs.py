"""Inputs of the pipeline's tests and of chip_smoke.py's pipeline phases,
numpy and the port only (no JAX: chip_smoke.py loads this module by
path): seeded synthetic spectra tables, a RendererSettings.yml, and a
scenes directory in the reference's layout.

The reference's spectra (hemoglobin, bile, water and lipid, public tables
from omlc.org) are not in the repository.  The synthetic tables have the
reference's column layout (lambda, HbO2, Hb for hemoglobin; lambda, value
for the others), comment lines, unsorted rows and first keys above 360 nm
(so the reference's below-the-table lerp from (0, 0) runs), and
magnitudes of the real tables; the collagen, elastin and hepatocyte terms
need no table.

    data = write_tables(tmpdir)            # medium_models.DATA_DIR = data
    settings = write_settings(path, 428, 240, 64, 12)
    xml = write_scenes(scenes_dir, 428, 240, 64)   # Liver-SingleMesh
"""
from __future__ import annotations

import os

import numpy as np

from liverrenderer_tpu_torch.pipeline.prepare_medium import DEFAULTS

# prepare_medium's keys -> RendererSettings.yml's, by section
_GLISSON = {"collagen_n_med": "collagen_nMed", "collagen_n_p": "collagen_nP",
            "elastin_n_med": "elastin_nMed", "elastin_n_p": "elastin_nP"}


def _sibling(name):
    """tests/<name>.py, loaded by path (chip_smoke.py loads this module
    by path, without tests/ on sys.path)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bumps(lam, peaks):
    return sum(a * np.exp(-0.5 * ((lam - c) / w) ** 2) for a, c, w in peaks)


def write_tables(dirpath: str, seed: int = 0) -> str:
    """hemoglobin_data.txt, bile_data.txt, water_data.txt and
    lipid_data.txt in dirpath -> dirpath."""
    rng = np.random.default_rng(seed)
    os.makedirs(dirpath, exist_ok=True)

    def noise(n):
        return 1.0 + 0.05 * rng.standard_normal(n)

    lam = np.arange(250.0, 1001.0, 2.0)
    # molar extinction (cm^-1 / M) with the Soret and Q bands
    hbo2 = (_bumps(lam, [(5.2e5, 415, 12), (5.3e4, 542, 10),
                         (5.5e4, 577, 8)]) + 3e2) * noise(len(lam))
    hb = (_bumps(lam, [(5.4e5, 430, 12), (5.4e4, 555, 18)]) + 8e2) \
        * noise(len(lam))
    tables = {
        "hemoglobin_data.txt": (["lambda", "HbO2", "Hb"],
                                np.stack([lam, hbo2, hb], 1)),
    }
    lam_b = np.arange(380.0, 701.0, 4.0)      # bilirubin-like, cm^-1
    tables["bile_data.txt"] = (["lambda", "mua"], np.stack([
        lam_b, (_bumps(lam_b, [(50.0, 455, 30)]) + 0.5)
        * noise(len(lam_b))], 1)[::-1])        # rows descending
    lam_w = np.arange(200.0, 1001.0, 5.0)     # water, cm^-1
    tables["water_data.txt"] = (["lambda", "mua"], np.stack([
        lam_w, (1e-4 * np.exp((lam_w - 200) / 110.0) + 2e-4)
        * noise(len(lam_w))], 1))
    lam_l = np.arange(400.0, 1001.0, 10.0)    # lipid, m^-1
    tables["lipid_data.txt"] = (["lambda", "mua"], np.stack([
        lam_l, (_bumps(lam_l, [(60.0, 930, 20)]) + 20.0 * np.exp(
            -(lam_l - 400) / 150.0)) * noise(len(lam_l))], 1))
    for name, (cols, arr) in tables.items():
        with open(os.path.join(dirpath, name), "w") as f:
            f.write(f"# synthetic {name}: {' '.join(cols)}\n\n")
            for row in arr:
                f.write("\t".join(f"{x:.6g}" for x in row) + "\n")
    return dirpath


def settings_text(width: int, height: int, spp: int, max_depth: int,
                  scene: str = "Liver-SingleMesh",
                  tissue: dict | None = None) -> str:
    """RendererSettings.yml: the scene, film, spp, the depth under the
    reference's key "Max Depth " (which ends in a space), and the tissue
    parameters (prepare_medium.DEFAULTS updated by `tissue`) under
    "Glisson Capsule" and "Parenchyma"."""
    t = dict(DEFAULTS)
    t.update(tissue or {})
    lines = ["# Liver renderer settings", "",
             f"Scene: '{scene}'   # one of the driver's SCENE_DIRS",
             "Resolution:", f"  Width: {width}", f"  Height: {height}",
             f"Samples Per Pixel: {spp}",
             f'"Max Depth ": {max_depth}',
             "", "Glisson Capsule:  # collagen (Mie) and elastin (Rayleigh)"]
    for k, v in t.items():
        if k.startswith(("collagen", "elastin")):
            lines.append(f"  {_GLISSON.get(k, k)}: {v!r}")
    lines.append("Parenchyma:")
    for k, v in t.items():
        if not k.startswith(("collagen", "elastin")):
            lines.append(f"    {k}: {v!r}")
    return "\n".join(lines) + "\n"


def write_settings(path: str, width: int, height: int, spp: int,
                   max_depth: int, **kw) -> str:
    with open(path, "w") as f:
        f.write(settings_text(width, height, spp, max_depth, **kw))
    return path


def write_scenes(scenes_dir: str, width: int, height: int, spp: int,
                 subdiv: int = 4, seed: int = 0, bump_res: int = 1024,
                 sky=(1024, 512), max_depth: int = 12) -> str:
    """scenes_dir/Liver-SingleMesh/mitsuba3/scene.xml with its files:
    bench.py's workload path on the liver proxy
    (tests/torch_xml_files.write_proxy_files), whose medium is
    type="liver" -> the path of scene.xml."""
    write_proxy_files = _sibling("torch_xml_files").write_proxy_files
    xml, _ = write_proxy_files(
        os.path.join(scenes_dir, "Liver-SingleMesh", "mitsuba3"), width,
        height, spp, subdiv, seed, bump_res=bump_res, sky=sky,
        max_depth=max_depth)
    return xml


LIVER_GOLDEN = ("Liver-SingleMesh/mitsuba3/outputs/Mitsuba3/CPU/"
                "liver-singlemesh.png")
SSS_XML = "SphereLiverPoint/sss/scene.xml"
SSS_GOLDEN = "SphereLiverPoint/sss/scene.exr"


def sss_xml(width: int, height: int, spp: int, depth: int = 6) -> str:
    """The learned-SSS golden scene's layout: a vaescatter shape read from
    soap_fine.obj (which the evaluation replaces by the fitted soap
    substitute, pipeline/substitute.py) with its subsurface referenced by
    id, a point light and a constant environment, the camera on the
    substitute."""
    from liverrenderer_tpu_torch.pipeline.substitute import soap_mesh
    v = soap_mesh()[0]
    c = 0.5 * (v.min(0) + v.max(0))
    o, lamp = c + [0.0, 1.0, 12.0], c + [3.0, 3.0, 3.0]

    def vec(x):
        return ", ".join(f"{float(t)!r}" for t in x)
    return f"""<scene version="3.0.0">
  <default name="res_width" value="{width}"/>
  <default name="res_height" value="{height}"/>
  <default name="spp" value="{spp}"/>
  <integrator type="path">
    <integer name="max_depth" value="{depth}"/>
  </integrator>
  <sensor type="perspective">
    <float name="fov" value="40"/>
    <transform name="to_world">
      <lookat origin="{vec(o)}" target="{vec(c)}" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="$res_width"/>
      <integer name="height" value="$res_height"/>
      <rfilter type="box"/>
    </film>
    <sampler type="independent">
      <integer name="sample_count" value="$spp"/>
    </sampler>
  </sensor>
  <subsurface type="vaescatter" id="soap_sss">
    <rgb name="sigmaT" value="0.8, 1.0, 1.4"/>
    <rgb name="albedo" value="0.99, 0.98, 0.95"/>
  </subsurface>
  <shape type="obj" id="soap">
    <string name="filename" value="soap_fine.obj"/>
    <ref id="soap_sss"/>
  </shape>
  <emitter type="point">
    <point name="position" value="{vec(lamp)}"/>
    <rgb name="intensity" value="40, 40, 40"/>
  </emitter>
  <emitter type="constant">
    <rgb name="radiance" value="0.5, 0.5, 0.5"/>
  </emitter>
</scene>
"""


def write_sss_scene(scenes_dir: str, width: int, height: int, spp: int,
                    golden_scale: int = 4) -> str:
    """scenes_dir/SphereLiverPoint/sss/scene.xml and its EXR golden: the
    constant environment's 0.5 with the substitute's silhouette (one
    camera ray per pixel centre, through the port's query) near black
    (0.003), as the reference's stale golden object is, at golden_scale
    times the film -> the path of scene.xml."""
    from liverrenderer_tpu_torch.io.exr import write_exr
    from liverrenderer_tpu_torch.pipeline import evaluate as tev
    d = os.path.join(scenes_dir, "SphereLiverPoint", "sss")
    os.makedirs(d, exist_ok=True)
    xml = os.path.join(d, "scene.xml")
    with open(xml, "w") as f:
        f.write(sss_xml(width, height, spp))
    gw, gh = width * golden_scale, height * golden_scale
    scene = tev._load_scene(xml, {"substitute": "soap"}, gw, gh, 1,
                            device="cpu")
    sil = tev._subsurface_silhouette(scene)
    gold = np.full((gh, gw, 3), 0.5, np.float32)
    gold[sil] = 0.003
    write_exr(os.path.join(d, "scene.exr"), gold)
    return xml
