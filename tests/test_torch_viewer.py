"""The port's progressive viewer (liverrenderer_tpu_torch/viewer.py)
against the JAX package's on the CPU: `run_viewer` frame by frame in
ema, accum (with the camera orbit) and denoise modes, the joint-bilateral
`denoise` on the same arrays, and `python -m
liverrenderer_tpu_torch.viewer --cpu` against JAX's `main`, PNG for PNG
(counterparts of tests/test_viewer.py's tests, at 12 x 12, path depth 3).
The Cornell camera is turned by 1.3 degrees, as in
tests/test_torch_cli.py's AOV scenes: straight on, the pixel centres on
the image's diagonals look exactly along the box's edges, where two walls
tie and the packages' albedo and normal AOVs pick different walls.

Tolerances: frames as tests/test_torch_path_slice.py's images (every
pixel within rtol 1e-4, atol 1e-6: the same paths, fp32 sums in another
order; the orbit's camera matrix is an fp32 product in both); denoised
frames rtol 1e-4 (the a-trous filter's
exp and pow per tap); the bilateral `denoise` rtol 1e-5 / atol 1e-6 (the
JAX version keeps its spatial weight in float64, the port rounds it to
fp32 once); the written PNGs within one 8-bit level.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import liverrenderer_tpu as lr
from liverrenderer_tpu import viewer as jviewer
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch import viewer as tviewer
from liverrenderer_tpu_torch.scene.transform import Transform
from torch_sensor_scenes import CLI_XML
from test_torch_parallel import box_dict
from torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FRAME_RTOL, FRAME_ATOL = 1e-4, 1e-6


def turned_box():
    d = box_dict()
    d["sensor"]["to_world"] = d["sensor"]["to_world"] @ Transform().rotate(
        [0.3, 1.0, 0.1], 1.3).matrix
    return d


@pytest.fixture(scope="module")
def box():
    d = turned_box()
    return lr.load_dict(d), lrt.load_dict(d, device="cpu")


def _frames(run, scene, **kw):
    frames = []
    out = run(scene, frame_callback=lambda i, img: frames.append(
        np.array(img, copy=True)), **kw)
    return frames, out


@pytest.mark.parametrize("mode, kw", [
    ("ema", dict(n_frames=4, spp=2, ema_alpha=0.3)),
    ("accum", dict(n_frames=3, spp=2, camera_orbit_deg=40.0)),
    ("accum", dict(n_frames=3, spp=1)),
    ("denoise", dict(n_frames=2, spp=2))])
def test_run_viewer_frames_match_jax(box, mode, kw):
    js, ts = box
    jf, jout = _frames(jviewer.run_viewer, js, mode=mode, **kw)
    tf, tout = _frames(tviewer.run_viewer, ts, mode=mode, **kw)
    assert len(tf) == len(jf) == kw["n_frames"]
    for a, b in zip(tf, jf):
        assert isinstance(a, np.ndarray) and a.shape == (12, 12, 3)
        np.testing.assert_allclose(a, b, rtol=FRAME_RTOL, atol=FRAME_ATOL)
    assert isinstance(tout, torch.Tensor) and tout.device.type == "cpu"
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               rtol=FRAME_RTOL, atol=FRAME_ATOL)
    if kw.get("camera_orbit_deg"):
        # the orbit moved the camera: frames differ (JAX's own test)
        assert np.abs(tf[0] - tf[-1]).max() > 0.05
    if mode == "ema":
        ref = lrt.render(ts, spp=64, seed=99).numpy()
        assert np.abs(tf[-1] - ref).mean() < np.abs(tf[0] - ref).mean()


def test_bilateral_denoise_matches_jax(box):
    js, ts = box
    noisy = np.array(lr.render(js, spp=2, seed=0))
    aovs = lr.render_aovs(js, ("albedo", "sh_normal"))
    alb, nrm = np.array(aovs["albedo"]), np.array(aovs["sh_normal"])
    for args in ((noisy,), (noisy, alb), (noisy, alb, nrm)):
        ref = jviewer.denoise(*args)
        got = tviewer.denoise(*args)
        assert got.dtype == torch.float32 and got.shape == (12, 12, 3)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    # tensors in, on their device
    got = tviewer.denoise(torch.as_tensor(noisy), torch.as_tensor(alb),
                          torch.as_tensor(nrm), radius=2, sigma_r=0.3)
    np.testing.assert_allclose(
        got.numpy(), jviewer.denoise(noisy, alb, nrm, radius=2, sigma_r=0.3),
        rtol=1e-5, atol=1e-6)


def test_viewer_main_writes_jax_frames(tmp_path):
    """`viewer.main` with --cpu writes the PNG frames JAX's main writes
    (ema mode, a 20-degree orbit); without --cpu and without a card it
    fails."""
    xml = tmp_path / "scene.xml"
    xml.write_text(CLI_XML)
    args = [str(xml), "--frames", "2", "--spp", "2", "--orbit", "20",
            "-D", "spp=2"]
    jviewer.main(args + ["--out", str(tmp_path / "j_{frame:03d}.png")])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-m",
                        "liverrenderer_tpu_torch.viewer", *args, "--cpu",
                        "--out", str(tmp_path / "t_{frame:03d}.png")],
                       capture_output=True, text=True, env=env,
                       cwd=str(tmp_path), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "phase timings:" in r.stdout and "copy" in r.stdout
    for f in range(2):
        a = np.asarray(Image.open(tmp_path / f"t_{f:03d}.png"), np.int16)
        b = np.asarray(Image.open(tmp_path / f"j_{f:03d}.png"), np.int16)
        assert a.shape == b.shape == (24, 24, 3)
        assert np.abs(a - b).max() <= 1
    if not torch.cuda.is_available():
        r = subprocess.run([sys.executable, "-m",
                            "liverrenderer_tpu_torch.viewer", str(xml),
                            "--frames", "1", "--out",
                            str(tmp_path / "none_{frame}.png")],
                           capture_output=True, text=True, env=env,
                           cwd=str(tmp_path), timeout=300)
        assert r.returncode != 0 and "no CUDA device" in r.stderr
        assert not (tmp_path / "none_0.png").exists()
