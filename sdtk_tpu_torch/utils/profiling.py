"""Per-stage timers and the device trace (the JAX package's
``sdtk_tpu/utils/profiling.py``).

- ``stage(name)``: an accumulating wall-clock timer, on with
  ``SDTK_PROFILE=1``; the report goes to stderr at exit, or to any stream
  through ``report()``.  Off, it times nothing and waits for no device.
- ``trace(dir)``: ``torch.profiler`` over the host and the card, written
  as a Chrome / TensorBoard trace (``*.pt.trace.json``) under ``dir`` or
  ``$SDTK_TRACE_DIR``; with neither set it does nothing.
"""

from __future__ import annotations

import atexit
import os
import sys
import time
from collections import defaultdict
from contextlib import contextmanager

_times: dict[str, list[float]] = defaultdict(list)
_registered = False


def enabled() -> bool:
    return os.environ.get("SDTK_PROFILE") == "1"


@contextmanager
def stage(name: str):
    """Accumulating per-stage wall-clock timer (no-op unless SDTK_PROFILE=1)."""
    if not enabled():
        yield
        return
    global _registered
    if not _registered:
        atexit.register(report)
        _registered = True
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _times[name].append(time.perf_counter() - t0)


def report(out=None) -> None:
    if not _times:
        return
    out = out or sys.stderr
    print("── sdtk profile ──", file=out)
    width = max(len(k) for k in _times)
    for name, vals in sorted(_times.items(), key=lambda kv: -sum(kv[1])):
        total = sum(vals)
        print(
            f"  {name:<{width}}  {total:8.3f}s  ({len(vals)}x, avg {total / len(vals):.3f}s)",
            file=out,
        )


def reset() -> None:
    _times.clear()


@contextmanager
def trace(trace_dir: str | None = None):
    """Host and device timeline (``torch.profiler``, CPU and, where there
    is a card, CUDA activities) written under ``trace_dir`` or
    ``$SDTK_TRACE_DIR``; viewable in TensorBoard or chrome://tracing."""
    trace_dir = trace_dir or os.environ.get("SDTK_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(trace_dir))):
        yield
