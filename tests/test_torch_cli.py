"""The port's apps against the JAX package on the CPU: the command-line
renderer (`python -m liverrenderer_tpu_torch.cli ... --cpu` in a
subprocess, on tests/test_pipeline.py::test_cli_renders_cornell's XML)
per pixel against `liverrenderer_tpu.render(load_file(xml))`, its
time.txt, its PNG and its --aovs; the AOV, depth, moment and direct
renders (integrators/aux.py); and tonemap in decoded PNG pixels.

Tolerances: images as tests/test_torch_path_slice.py (every pixel within
rtol 1e-4, atol 1e-6); AOVs of one ray per pixel centre: positions,
normals and depths within rtol 1e-5 / atol 1e-5 (the same intersection
in fp32), indices exactly; tonemapped PNGs exactly.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import liverrenderer_tpu as lr
from liverrenderer_tpu import tonemap as jtonemap
from liverrenderer_tpu.integrators import aux as jaux
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch import tonemap as ttonemap
from liverrenderer_tpu_torch.scene import cornell as tcornell
from liverrenderer_tpu_torch.scene.liver_proxy import liver_proxy_dict
from liverrenderer_tpu_torch.scene.transform import Transform
from test_torch_path_slice import _assert_images_equal
from torch_sensor_scenes import CLI_XML, matrices
from torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
AOV_RTOL, AOV_ATOL = 1e-5, 1e-5
AOV_NAMES = ("depth", "dd.y", "position", "p", "sh_normal", "nn",
             "geo_normal", "ng", "uv", "albedo", "emission", "prim_index",
             "shape_index")

def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-m", "liverrenderer_tpu_torch.cli",
                           *map(str, args)], capture_output=True, text=True,
                          env=env, cwd=str(ROOT), timeout=timeout)


@pytest.fixture(scope="module")
def xml(tmp_path_factory):
    p = tmp_path_factory.mktemp("cli") / "scene.xml"
    p.write_text(CLI_XML)
    return p


def test_cli_matches_jax_render(xml):
    """The EXR, the PNG beside it, time.txt's five lines and the closing
    JSON line of `cli scene.xml -o out.exr --cpu`."""
    out = xml.parent / "out.exr"
    r = _cli(xml, "-o", out, "--cpu", "-D", "spp=4")
    assert r.returncode == 0, r.stderr[-2000:]
    ref = np.asarray(lr.render(lr.load_file(str(xml))))
    img = lrt.read_image(str(out))
    _assert_images_equal(img, ref)
    png = np.asarray(Image.open(xml.parent / "out.png"))
    assert png.shape == (24, 24, 3) and png.mean() > 10
    lines = (xml.parent / "time.txt").read_text().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "Scene", "Resolution", "SPP", "Load time", "Render time"]
    assert lines[0] == "Scene: scene.xml" and lines[1] == \
        "Resolution: 24x24" and lines[2] == "SPP: 4"
    assert '"paths_per_s"' in r.stdout.splitlines()[-1]


def test_cli_aovs_and_overrides(xml):
    """--aovs writes <stem>_<name><ext>, each equal to render_aovs;
    --integrator overrides through load_file; --spp sets time.txt's."""
    out = xml.parent / "aov.exr"
    r = _cli(xml, "-o", out, "--cpu", "--aovs", "depth,position,albedo")
    assert r.returncode == 0, r.stderr[-2000:]
    ref = jaux.render_aovs(lr.load_file(str(xml)),
                           ("depth", "position", "albedo"))
    for name, a in ref.items():
        a = np.asarray(a)
        if a.ndim == 2:
            a = np.repeat(a[..., None], 3, -1)
        got = lrt.read_image(str(xml.parent / f"aov_{name}.exr"))
        np.testing.assert_allclose(got, a, rtol=AOV_RTOL, atol=AOV_ATOL)
    r = _cli(xml, "-o", xml.parent / "d.exr", "--cpu", "--spp", "2",
             "--integrator", "direct")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "integrator=path" in r.stdout     # no $integrator in the XML
    assert "SPP: 2" in (xml.parent / "time.txt").read_text()


def test_cli_without_a_card_fails(xml):
    """Without --cpu the CLI renders on the card; without one it fails
    instead of rendering on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = _cli(xml, "-o", xml.parent / "none.exr")
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert not (xml.parent / "none.exr").exists()


# ---------------------------------------------------------------- aux ----

def _aux_scenes():
    """(JAX, port) scene pairs: the Cornell box (an area light for the
    emission AOV), and the bumped liver proxy (the bump frame)."""
    cb = tcornell.cornell_box()
    # the camera turned a little, so that no pixel centre looks exactly
    # along an edge of the box (where two walls tie)
    cb["sensor"]["to_world"] = cb["sensor"]["to_world"] @ Transform() \
        .rotate([0.3, 1.0, 0.1], 1.3)
    cb = matrices(cb)
    cb["sensor"]["film"].update(width=12, height=12)
    px = matrices(liver_proxy_dict(12, 8, 2, 1, 0, bump=(16, 0.05)))
    return [(lr.load_dict(d), lrt.load_dict(d, device="cpu"))
            for d in (cb, px)]


@pytest.fixture(scope="module")
def aux_scenes():
    return _aux_scenes()


def test_render_aovs_every_name_matches_jax(aux_scenes):
    for js, ts in aux_scenes:
        ref = jaux.render_aovs(js, AOV_NAMES)
        got = lrt.render_aovs(ts, AOV_NAMES)
        assert list(got) == list(ref)
        for name in AOV_NAMES:
            a, b = got[name].numpy(), np.asarray(ref[name])
            assert a.shape == b.shape, name
            if name.endswith("index"):
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                np.testing.assert_allclose(a, b, rtol=AOV_RTOL,
                                           atol=AOV_ATOL, err_msg=name)
        np.testing.assert_array_equal(lrt.render_depth(ts).numpy(),
                                      got["depth"].numpy())
        np.testing.assert_allclose(lrt.render_depth(ts).numpy(),
                                   np.asarray(jaux.render_depth(js)),
                                   rtol=AOV_RTOL, atol=AOV_ATOL)
    assert got["emission"].numpy().max() == 0.0
    cb_emission = lrt.render_aovs(aux_scenes[0][1], ("emission",))
    assert cb_emission["emission"].numpy().max() > 1.0
    with pytest.raises(ValueError, match="unknown AOV"):
        lrt.render_aovs(aux_scenes[0][1], ("nope",))


def test_render_moments_and_direct_match_jax(aux_scenes):
    js, ts = aux_scenes[0]
    jm, jm2 = jaux.render_moments(js, spp=3, seed=1)
    tm, tm2 = lrt.render_moments(ts, spp=3, seed=1)
    _assert_images_equal(tm.numpy(), np.asarray(jm))
    _assert_images_equal(tm2.numpy(), np.asarray(jm2))
    _assert_images_equal(lrt.render_direct(ts, spp=4, seed=2).numpy(),
                         np.asarray(jaux.render_direct(js, spp=4, seed=2)))


@pytest.mark.parametrize("integrator", ["aov", "depth", "moment"])
def test_aux_integrator_names_load_and_render_as_jax(integrator):
    """The builders take aov, depth and moment; render refuses them in
    both packages (integrators/aux.py renders them)."""
    d = matrices(tcornell.cornell_box())
    d["integrator"] = {"type": integrator}
    d["sensor"]["film"].update(width=4, height=4)
    js, ts = lr.load_dict(d), lrt.load_dict(d, device="cpu")
    assert ts.integrator == js.integrator == integrator
    for render, scene in ((lr.render, js), (lrt.render, ts)):
        with pytest.raises(ValueError, match="unknown integrator"):
            render(scene, spp=1)
    np.testing.assert_allclose(lrt.render_depth(ts).numpy(),
                               np.asarray(jaux.render_depth(js)),
                               rtol=AOV_RTOL, atol=AOV_ATOL)


# ------------------------------------------------------------ tonemap ----

@pytest.mark.parametrize("opts", [[], ["--exposure", "1.5"],
                                  ["--gamma", "2.2"],
                                  ["--reinhard", "--exposure", "-0.5"]])
def test_tonemap_matches_jax_in_png_pixels(tmp_path, np_rng, opts):
    hdr = (np_rng.lognormal(0.0, 1.5, (9, 13, 3))).astype(np.float32)
    hdr[0, 0] = [0.0, 50.0, 1e-4]
    src = tmp_path / "in.exr"
    lrt.write_image(str(src), hdr)
    ttonemap.main([str(src), str(tmp_path / "t.png"), *opts])
    jtonemap.main([str(src), str(tmp_path / "j.png"), *opts])
    a = np.asarray(Image.open(tmp_path / "t.png"))
    b = np.asarray(Image.open(tmp_path / "j.png"))
    assert a.shape == b.shape == (9, 13, 3)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ttonemap.tonemap(hdr, 0.7, None, True),
                                  jtonemap.tonemap(hdr, 0.7, None, True))


def test_cli_trace_and_log_phases(xml, capsys):
    """--trace DIR writes a torch.profiler Chrome trace; scoped_phase
    times phases (a record_function span inside device_trace), and the
    log's levels gate its lines."""
    out = xml.parent / "tr.exr"
    r = _cli(xml, "-o", out, "--cpu", "--spp", "1", "--trace",
             xml.parent / "trace")
    assert r.returncode == 0, r.stderr[-2000:]
    assert (xml.parent / "trace" / "trace.json").stat().st_size > 0
    from liverrenderer_tpu_torch import log as tlog
    tlog.reset_phases()
    with tlog.device_trace(str(xml.parent / "trace2")) as prof:
        with tlog.scoped_phase("phase_a"):
            pass
    assert any(e.name == "phase_a" for e in prof.events())
    with tlog.scoped_phase("phase_a"):
        pass
    assert "phase_a" in tlog.phase_report() and "x2" in tlog.phase_report()
    tlog.set_log_level(tlog.WARN)
    try:
        tlog.log("hidden")
        tlog.ProgressReporter("p", 2, 0.0).update(2)
    finally:
        tlog.set_log_level(tlog.INFO)
    captured = capsys.readouterr()
    assert "hidden" not in captured.out and "100.0%" in captured.err
