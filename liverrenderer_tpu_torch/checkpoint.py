"""Checkpoint and resume of an optimization loop, and the partial-render
develop on a signal (counterpart of liverrenderer_tpu/checkpoint.py).

The reference has no checkpointing (only a SIGHUP handler that develops
the partial film mid-render, mitsuba.cpp:93-96,141-145).  This module
provides:

  * `OptimizationCheckpointer`: save and restore of (step, params,
    optimizer state) with retention, so that a killed inverse-rendering
    run resumes where it stopped.  The JAX package keeps them with
    orbax; here each step is one `torch.save` file, written atomically;
  * `install_partial_develop`: a SIGHUP/SIGUSR1 handler that writes the
    latest developed frame to disk (the reference's behaviour).
"""
from __future__ import annotations

import os
import re
import signal
import tempfile
from typing import Any, Callable

import numpy as np
import torch

_STEP_FILE = re.compile(r"step_(\d+)\.pt$")


def _onto(loaded, like, device):
    """`loaded` with each tensor on the device of the tensor at the same
    place in `like`, or on `device` where `like` has none."""
    if isinstance(loaded, torch.Tensor):
        return loaded.to(like.device if isinstance(like, torch.Tensor)
                         else device)
    if isinstance(loaded, dict):
        like = like if isinstance(like, dict) else {}
        return {k: _onto(v, like.get(k), device) for k, v in loaded.items()}
    if isinstance(loaded, (list, tuple)):
        like = like if isinstance(like, (list, tuple)) \
            and len(like) == len(loaded) else [None] * len(loaded)
        return type(loaded)(_onto(v, lk, device)
                            for v, lk in zip(loaded, like))
    return loaded


def _first_device(tree):
    if isinstance(tree, torch.Tensor):
        return tree.device
    items = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, (list, tuple)) else ()
    for v in items:
        d = _first_device(v)
        if d is not None:
            return d
    return None


class OptimizationCheckpointer:
    """Save and restore inverse-rendering state: the step, a params tree
    (dicts, lists and tuples of tensors) and an optimizer state (a
    `torch.optim` state_dict), keeping the newest `keep` steps."""

    def __init__(self, directory: str, keep: int = 3):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._keep = keep

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step}.pt")

    def all_steps(self) -> list:
        """The steps on disk, oldest first."""
        return sorted(int(m.group(1)) for m in map(
            _STEP_FILE.match, os.listdir(self._dir)) if m)

    def save(self, step: int, params: Any, opt_state: Any) -> None:
        fd, tmp = tempfile.mkstemp(dir=self._dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save({"step": step, "params": params,
                            "opt_state": opt_state}, f)
            os.replace(tmp, self._path(step))
        except BaseException:
            os.unlink(tmp)
            raise
        for old in self.all_steps()[:-self._keep]:
            os.unlink(self._path(old))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, params_like: Any, opt_state_like: Any,
                step: int | None = None):
        """(step, params, opt_state) of `step` (default: the latest), or
        None when there is none; each tensor lands on the device of its
        counterpart in `params_like` / `opt_state_like` (optimizer state
        that the fresh `opt_state_like` lacks: on the params' device)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        out = torch.load(self._path(step), map_location="cpu",
                         weights_only=True)
        device = _first_device(params_like) or "cpu"
        return (out["step"], _onto(out["params"], params_like, device),
                _onto(out["opt_state"], opt_state_like, device))

    def close(self):
        """Nothing stays open between calls; kept for the JAX package's
        interface."""


def install_partial_develop(get_frame: Callable[[], Any], path: str,
                            signals=(signal.SIGHUP, signal.SIGUSR1)) -> None:
    """SIGHUP-develops-the-partial-film (mitsuba.cpp:93-96 semantics):
    `get_frame` returns the current (h, w, 3) image (numpy or a tensor on
    any device); on the signal it is written to `path`."""
    def handler(signum, frame):
        try:
            from .io.image import write_image
            img = get_frame()
            if isinstance(img, torch.Tensor):
                img = img.detach().cpu().numpy()
            write_image(path, np.asarray(img))
            print(f"[signal {signum}] partial render written to {path}",
                  flush=True)
        except Exception as e:       # never die inside a signal handler
            print(f"[signal {signum}] partial develop failed: {e}",
                  flush=True)

    for s in signals:
        signal.signal(s, handler)
