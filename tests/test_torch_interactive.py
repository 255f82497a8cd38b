"""The port's interactive loop (liverrenderer_tpu_torch/interactive.py)
against the JAX package's on the CPU (counterparts of
tests/test_interactive.py's tests): the fly camera's state, matrix and
key moves, `blit_ansi` byte for byte, the scripted `run_interactive`
(frames, frame count, camera positions, accumulation restarts, the spp
keys, quitting), and `python -m liverrenderer_tpu_torch.interactive
--cpu`.

Tolerances: the camera is the same host numpy arithmetic, so its state
and matrices are equal exactly; frames within rtol 1e-4 / atol 1e-6 (as
tests/test_torch_path_slice.py's images); the blitted strings equal.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import liverrenderer_tpu as lr
from liverrenderer_tpu import interactive as jint
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch import interactive as tint
from torch_sensor_scenes import CLI_XML
from test_torch_viewer import turned_box
from torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
KEYS = ["w", "a", "LEFT", "RIGHT", "UP", "DOWN", "s", "d", " ", "c", "x"]


@pytest.fixture(scope="module")
def box():
    d = turned_box()
    return lr.load_dict(d), lrt.load_dict(d, device="cpu")


def test_fly_camera_matches_jax(box):
    js, ts = box
    m0 = np.asarray(js.sensor.to_world)
    np.testing.assert_array_equal(ts.sensor.to_world.numpy(), m0)
    jc, tc = jint.FlyCamera(m0, speed=0.5), tint.FlyCamera(m0, speed=0.5)
    # the round trip keeps the view direction and position
    np.testing.assert_allclose(tc.to_world()[:3, 3], m0[:3, 3], atol=1e-5)
    np.testing.assert_allclose(tc.to_world()[:3, 2],
                               m0[:3, 2] / np.linalg.norm(m0[:3, 2]),
                               atol=1e-5)
    for key in KEYS * 2:
        assert tc.apply_key(key) == jc.apply_key(key)
        np.testing.assert_array_equal(tc.pos, jc.pos)
        assert (tc.yaw, tc.pitch, tc.speed) == (jc.yaw, jc.pitch, jc.speed)
        np.testing.assert_array_equal(tc.to_world(), jc.to_world())
    assert not tc.apply_key("x")
    # looking straight up: the fallback right axis
    for c in (jc, tc):
        c.pitch = np.pi / 2
    np.testing.assert_array_equal(tc.to_world(), jc.to_world())


def test_blit_ansi_is_byte_equal(box):
    rng = np.random.default_rng(3)
    img = (rng.random((7, 5, 3)) * 2.0).astype(np.float32)
    img[0, 0] = [1.0, 0.0, 0.0]
    img[3, 2] = [50.0, -1.0, np.inf]
    s = tint.blit_ansi(img)
    assert s == jint.blit_ansi(img)
    assert len(s.split("\n")) == 3 and s.endswith("\x1b[0m")
    # a tensor (the accumulation's device) blits as its host copy
    assert tint.blit_ansi(torch.as_tensor(img)) == s

    class Out:
        text = ""

        def write(self, t):
            self.text += t

        def flush(self):
            pass

    out = Out()
    tint.blit_ansi(img, out=out)
    assert out.text == "\x1b[H" + s + "\n"


def test_scripted_loop_matches_jax(box):
    """Two static frames, a move (restart), the spp keys, a look key, a
    reset, then the frame budget: every frame, the camera position per
    frame and the final accumulation equal JAX's; a 'q' ends the loop
    early in both."""
    js, ts = box
    keys = [None, None, "w", "+", "LEFT", None, "-", "r", "a", None]
    runs = {}
    for name, mod, sc in (("jax", jint, js), ("port", tint, ts)):
        frames = []
        acc, n = mod.run_interactive(
            sc, spp=1, max_frames=len(keys), keys=keys, display=False,
            frame_callback=lambda f, a, c: frames.append(
                (f, np.array(a, copy=True), c.pos.copy())))
        runs[name] = (frames, acc, n)
    (jf, jacc, jn), (tf, tacc, tn) = runs["jax"], runs["port"]
    assert tn == jn == len(keys) and len(tf) == len(jf) == len(keys)
    for (fa, a, pa), (fb, b, pb) in zip(tf, jf):
        assert fa == fb
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    assert isinstance(tacc, torch.Tensor)
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), rtol=1e-4,
                               atol=1e-6)
    # frames 0-1 share a camera, frame 2 moved
    assert np.array_equal(tf[0][2], tf[1][2])
    assert not np.array_equal(tf[1][2], tf[2][2])
    stats = {}
    _, n_q = tint.run_interactive(ts, spp=1, max_frames=10,
                                  keys=[None, "q"], display=True,
                                  stats=stats)
    _, jn_q = jint.run_interactive(js, spp=1, max_frames=10,
                                   keys=[None, "q"], display=False)
    assert n_q == jn_q == 1
    assert stats["renders"] == stats["blits"] == 1
    assert stats["restarts"] == 0 and stats["render_s"] > 0


def test_interactive_main_cpu(tmp_path):
    """`python -m liverrenderer_tpu_torch.interactive scene.xml --cpu
    --frames 2` renders (no TTY: the HUD goes to the log); without --cpu
    and without a card it fails."""
    xml = tmp_path / "scene.xml"
    xml.write_text(CLI_XML)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "liverrenderer_tpu_torch.interactive",
           str(xml), "--width", "16", "--height", "8", "--frames", "2"]
    r = subprocess.run(cmd + ["--cpu"], capture_output=True, text=True,
                       env=env, timeout=300, stdin=subprocess.DEVNULL)
    assert r.returncode == 0, r.stderr[-2000:]
    huds = [ln for ln in r.stdout.splitlines() if "| 1 spp | acc" in ln]
    assert len(huds) == 2 and "frame 1 | 1 spp | acc 2" in huds[1]
    if not torch.cuda.is_available():
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=300, stdin=subprocess.DEVNULL)
        assert r.returncode != 0 and "no CUDA device" in r.stderr
