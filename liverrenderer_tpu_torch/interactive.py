"""Interactive viewer with a live camera, input and frame loop
(counterpart of liverrenderer_tpu/interactive.py; the reference's GLFW
realtime renderer, src/mitsuba/realtime.hpp:341-630 runRealtimeRenderer +
Camera:60-178): an input-driven fly camera, a render per frame,
progressive accumulation that restarts when the camera moves, and a
per-stage timing HUD, with the GL window replaced by an ANSI 24-bit
half-block framebuffer (two pixels per character cell).

Controls (realtime.hpp processKeyboard:96-134):
  w/s/a/d   dolly forward/back, strafe left/right
  arrows    look (yaw/pitch); the mouse_callback analog
  space/c   move up/down
  +/-       raise/lower per-frame spp
  r         reset accumulation
  q / ESC   quit

Runs against a real TTY (raw mode, non-blocking reads) or a scripted key
iterable (`keys=`):

    python -m liverrenderer_tpu_torch.interactive scene.xml
    python -m liverrenderer_tpu_torch.interactive scene.xml --cpu

The accumulation stays on the scene's device; a frame is copied to the
host only for the blit or a callback.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch


class FlyCamera:
    """Yaw/pitch/position camera (realtime.hpp Camera:60-134): the
    reference Camera's state (position, yaw, pitch, speed), host numpy,
    producing a look-at to_world each frame."""

    def __init__(self, to_world, speed=None):
        m = np.asarray(to_world, np.float32)
        self.pos = m[:3, 3].copy()
        fwd = m[:3, 2].copy()      # the sensors look down +Z (builder.py)
        n = np.linalg.norm(fwd)
        fwd = fwd / (n if n > 0 else 1.0)
        self.yaw = float(np.arctan2(fwd[0], fwd[2]))
        self.pitch = float(np.arcsin(np.clip(fwd[1], -1, 1)))
        self.speed = float(speed) if speed else 1.0
        self.look_speed = np.radians(4.0)

    @property
    def forward(self):
        cp = np.cos(self.pitch)
        return np.array([np.sin(self.yaw) * cp, np.sin(self.pitch),
                         np.cos(self.yaw) * cp], np.float32)

    def to_world(self):
        fwd = self.forward
        up = np.array([0.0, 1.0, 0.0], np.float32)
        right = np.cross(up, fwd)
        rn = np.linalg.norm(right)
        if rn < 1e-6:               # looking straight up/down
            right = np.array([1.0, 0.0, 0.0], np.float32)
            rn = 1.0
        right = right / rn
        true_up = np.cross(fwd, right)
        m = np.eye(4, dtype=np.float32)
        m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, true_up, fwd, self.pos
        return m

    def apply_key(self, key: str, dt: float = 1.0) -> bool:
        """True if the camera changed (accumulation must restart).  Key
        map of realtime.hpp:103-134."""
        v = self.speed * dt
        fwd = self.forward
        up = np.array([0.0, 1.0, 0.0], np.float32)
        right = np.cross(up, fwd)
        rn = np.linalg.norm(right)
        right = right / (rn if rn > 1e-6 else 1.0)
        moves = {
            "w": fwd * v, "s": -fwd * v, "a": -right * v, "d": right * v,
            " ": up * v, "c": -up * v,
        }
        if key in moves:
            self.pos = self.pos + moves[key]
            return True
        looks = {"LEFT": (-1, 0), "RIGHT": (1, 0), "UP": (0, 1),
                 "DOWN": (0, -1)}
        if key in looks:
            dy, dp = looks[key]
            self.yaw += dy * self.look_speed
            self.pitch = float(np.clip(self.pitch + dp * self.look_speed,
                                       -1.5, 1.5))
            return True
        return False


def _tty_keys(timeout: float = 0.0):
    """Non-blocking raw-mode key reader; decodes arrow escape sequences."""
    import select
    r, _, _ = select.select([sys.stdin], [], [], timeout)
    if not r:
        return None
    ch = sys.stdin.read(1)
    if ch == "\x1b":                       # ESC or arrow sequence
        r, _, _ = select.select([sys.stdin], [], [], 0.01)
        if not r:
            return "ESC"
        seq = sys.stdin.read(2)
        return {"[A": "UP", "[B": "DOWN", "[C": "RIGHT",
                "[D": "LEFT"}.get(seq, None)
    return ch


def blit_ansi(img, out=None) -> str:
    """Render an (h, w, 3) linear image (numpy, or a tensor on any
    device) as ANSI 24-bit half blocks: each character cell shows two
    vertically stacked pixels through the upper-half-block glyph with
    independent foreground and background colours.  Returns the frame
    string (and writes it when `out` is given)."""
    from .tonemap import tonemap
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    disp = np.clip(tonemap(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    h = disp.shape[0] - disp.shape[0] % 2
    top, bot = disp[0:h:2], disp[1:h:2]
    rows = []
    for y in range(top.shape[0]):
        cells = []
        for x in range(top.shape[1]):
            tr, tg, tb = (int(v) for v in top[y, x])
            br, bg_, bb = (int(v) for v in bot[y, x])
            cells.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                         f"\x1b[48;2;{br};{bg_};{bb}m▀")
        rows.append("".join(cells) + "\x1b[0m")
    frame = "\n".join(rows)
    if out is not None:
        out.write("\x1b[H" + frame + "\n")
        out.flush()
    return frame


def run_interactive(scene, spp: int = 1, max_frames: int | None = None,
                    keys=None, display: bool = True, frame_callback=None,
                    speed: float | None = None, stats: dict | None = None):
    """The live loop (realtime.hpp:341-630): poll input -> move camera ->
    render -> accumulate (restart on movement) -> blit -> HUD.

    `keys`: optional iterable of key strings consumed one per frame
    (scripted flythroughs); None reads the controlling TTY.
    frame_callback(frame, image, camera) receives the accumulated frame
    as a host numpy array.  Returns (final accumulated frame, an (h, w,
    3) tensor on the scene's device; frames rendered).  `stats`, when
    given, receives the summed seconds of the render, copy and blit
    stages, their counts and the accumulation restarts."""
    import liverrenderer_tpu_torch as lrt
    from .log import log
    from .viewer import _sync

    dev = scene.device
    cam = FlyCamera(scene.sensor.to_world.detach().cpu().numpy(),
                    speed=speed)
    if speed is None:
        # scale movement to the scene: 5% of the bbox diagonal per press
        lo = scene.vertices.min(0).values.cpu().numpy()
        hi = scene.vertices.max(0).values.cpu().numpy()
        cam.speed = float(np.linalg.norm(hi - lo) * 0.05) or 1.0

    scripted = iter(keys) if keys is not None else None
    tty = scripted is None and sys.stdin.isatty()
    restore = None
    if tty:
        import termios
        import tty as ttymod
        fd = sys.stdin.fileno()
        restore = termios.tcgetattr(fd)
        ttymod.setcbreak(fd)
        sys.stdout.write("\x1b[2J")        # clear once

    acc, n_acc, frame = None, 0, 0
    cur_spp = int(spp)
    phases = stats if stats is not None else {}
    phases.update(render_s=0.0, copy_s=0.0, blit_s=0.0, renders=0,
                  blits=0, restarts=0)
    try:
        while True:
            if max_frames is not None and frame >= max_frames:
                break
            # ---- input ----
            key = None
            if scripted is not None:
                key = next(scripted, "q" if max_frames is None else None)
            elif tty:
                key = _tty_keys(0.0)
            if key in ("q", "ESC"):
                break
            if key == "r":
                acc, n_acc = None, 0
                phases["restarts"] += 1
            elif key == "+":
                cur_spp = min(cur_spp * 2, 256)
            elif key == "-":
                cur_spp = max(cur_spp // 2, 1)
            elif key and cam.apply_key(key):
                acc, n_acc = None, 0       # parameters_changed analog
                phases["restarts"] += 1

            sc = scene.replace(sensor=scene.sensor.replace(
                to_world=torch.as_tensor(cam.to_world(), device=dev)))

            # ---- render + accumulate ----
            t0 = time.perf_counter()
            img = lrt.render(sc, spp=cur_spp, seed=frame)
            acc = img if acc is None else (acc * n_acc + img) / (n_acc + 1)
            _sync(dev)
            t_render = time.perf_counter() - t0
            n_acc += 1

            # ---- present ----
            host = None
            t0 = time.perf_counter()
            if display or frame_callback:
                host = acc.cpu().numpy()
            t_copy = time.perf_counter() - t0
            t0 = time.perf_counter()
            if display:
                blit_ansi(host, out=sys.stdout if tty else None)
                phases["blits"] += 1
            t_blit = time.perf_counter() - t0
            phases["render_s"] += t_render
            phases["copy_s"] += t_copy
            phases["blit_s"] += t_blit
            phases["renders"] += 1
            hud = (f"frame {frame} | {cur_spp} spp | acc {n_acc} | "
                   f"render {t_render * 1e3:.0f} ms blit {t_blit * 1e3:.0f}"
                   f" ms | pos {np.round(cam.pos, 2).tolist()} | "
                   f"wasd/arrows move, +/- spp, r reset, q quit")
            if tty:
                sys.stdout.write("\x1b[0m" + hud + "\x1b[K\n")
                sys.stdout.flush()
            else:
                log(hud)
            if frame_callback:
                frame_callback(frame, host, cam)
            frame += 1
    finally:
        if restore is not None:
            import termios
            termios.tcsetattr(sys.stdin.fileno(), termios.TCSADRAIN,
                              restore)
    return acc, frame


def main(argv=None):
    """`python -m liverrenderer_tpu_torch.interactive scene.xml`: on the
    card unless --cpu, failing without one."""
    import argparse

    import liverrenderer_tpu_torch as lrt

    ap = argparse.ArgumentParser(
        description="interactive terminal viewer (realtime.hpp analog)")
    ap.add_argument("scene")
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--height", type=int, default=88)
    ap.add_argument("--frames", type=int, default=None,
                    help="stop after N frames (default: run until q)")
    ap.add_argument("-D", "--define", action="append", default=[])
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (default: the CUDA card)")
    a = ap.parse_args(argv)
    overrides = dict(kv.split("=", 1) for kv in a.define)
    scene = lrt.load_file(a.scene, device="cpu" if a.cpu else "cuda",
                          res_width=a.width, res_height=a.height,
                          **overrides)
    run_interactive(scene, spp=a.spp, max_frames=a.frames)
    return 0


if __name__ == "__main__":
    main()
