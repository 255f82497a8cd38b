"""Logging, progress and profiling (counterpart of
liverrenderer_tpu/log.py; the reference's logger, ProgressReporter and
ScopedPhase): log levels with a global threshold, elapsed-time-stamped
lines, a throttled progress bar, and scoped wall-clock phase timers.

`device_trace(dir)` captures a torch.profiler trace of the host and the
card (the JAX package's jax.profiler capture) and exports it as a Chrome
trace into `dir`; while it runs, each `scoped_phase` is also a
record_function span on that trace.
"""
from __future__ import annotations

import os
import sys
import time
from collections import defaultdict
from contextlib import contextmanager

TRACE, DEBUG, INFO, WARN, ERROR = 0, 1, 2, 3, 4
_NAMES = {TRACE: "TRACE", DEBUG: "DEBUG", INFO: "INFO", WARN: "WARN",
          ERROR: "ERROR"}

_level = INFO
_t0 = time.time()


def set_log_level(level: int) -> None:
    global _level
    _level = level


def log(msg: str, level: int = INFO) -> None:
    if level < _level:
        return
    elapsed = time.time() - _t0
    print(f"[{elapsed:8.3f}s] {_NAMES[level]:5s} {msg}",
          file=sys.stderr if level >= WARN else sys.stdout, flush=True)


class ProgressReporter:
    """Throttled progress bar (the reference's src/core/progress.cpp)."""

    def __init__(self, label: str, total: int, min_interval: float = 0.5):
        self.label = label
        self.total = max(total, 1)
        self.min_interval = min_interval
        self._last = 0.0
        self._start = time.time()

    def update(self, done: int) -> None:
        now = time.time()
        if now - self._last < self.min_interval and done < self.total:
            return
        self._last = now
        frac = min(done / self.total, 1.0)
        bar = "#" * int(30 * frac) + "-" * (30 - int(30 * frac))
        eta = (now - self._start) / max(frac, 1e-9) * (1 - frac)
        end = "\n" if done >= self.total else "\r"
        print(f"{self.label} [{bar}] {100 * frac:5.1f}% eta {eta:6.1f}s",
              end=end, file=sys.stderr, flush=True)


_phase_totals: dict = defaultdict(float)
_phase_counts: dict = defaultdict(int)
_tracing = False


@contextmanager
def scoped_phase(name: str):
    """Accumulates wall time per phase for `phase_report()`; inside
    `device_trace` the phase is also a record_function span."""
    t0 = time.time()
    span = None
    if _tracing:
        import torch
        span = torch.profiler.record_function(name)
        span.__enter__()
    try:
        yield
    finally:
        if span is not None:
            span.__exit__(None, None, None)
        _phase_totals[name] += time.time() - t0
        _phase_counts[name] += 1


@contextmanager
def device_trace(log_dir: str):
    """torch.profiler over the block (host ops, and the card's kernels
    when there is one), exported as a Chrome trace (trace.json) into
    log_dir.  CLI: `--trace DIR`."""
    global _tracing
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        _tracing = True
        try:
            yield prof
        finally:
            _tracing = False
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    log(f"device trace written to {path}")


def phase_report() -> str:
    lines = ["phase timings:"]
    for name, total in sorted(_phase_totals.items(), key=lambda kv: -kv[1]):
        n = _phase_counts[name]
        lines.append(f"  {name:28s} {total:9.3f}s total"
                     f"  {total / n * 1000:9.2f} ms/call  x{n}")
    return "\n".join(lines)


def reset_phases() -> None:
    _phase_totals.clear()
    _phase_counts.clear()
