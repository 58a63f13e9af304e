"""Per-stage spans, counters and the device trace (the JAX package's
``sdtk_tpu/utils/profiling.py``, extended).

- ``stage(name)``: the port's one span.  While a ``torch.profiler`` runs it
  is a ``record_function`` range ``sdtk.<name>``, a ``user_annotation`` on
  the trace's clock, nested in the spans around it; the profiler path never
  synchronizes.  With ``SDTK_PROFILE=1`` it also accumulates wall time,
  reported to stderr at exit or to any stream through ``report()``; there
  a stage ends in ``torch.cuda.synchronize()`` once CUDA is initialised, so
  its seconds hold its device work.  With both off it does nothing.
- ``count(name, n)``: adds to a counter while either is on; ``counters()``
  reads them and ``report()`` lists them under the stage times.
- ``launched(fn)``: one launch of kernel wrapper ``fn``, counted in its
  ``.launches``.
- ``tape()``: inside it a thread's counts and launches go to the tape
  instead, the counts whether or not either is on (what a CUDA graph's
  capture counts, added again at each replay); other threads count as
  before.
- ``trace(dir)``: ``torch.profiler`` over the host and the card, written
  as a Chrome / TensorBoard trace (``*.pt.trace.json``) under ``dir`` or
  ``$SDTK_TRACE_DIR``; with neither set it does nothing.
- ``span_self_ms(events)``: each ``sdtk.*`` span's host time less the
  ``sdtk.*`` spans it holds, from a trace's host events.
"""

from __future__ import annotations

import atexit
import os
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

import torch

PREFIX = "sdtk."

_times: dict[str, list[float]] = defaultdict(list)
_counts: dict[str, int] = defaultdict(int)
_pending: dict[str, list[torch.Tensor]] = defaultdict(list)  # device counts, read later
_lock = threading.Lock()  # worker threads share the registry
_taped = threading.local()  # .tape: the open Tape of this thread
_registered = False


def enabled() -> bool:
    return os.environ.get("SDTK_PROFILE") == "1"


def _tracing() -> bool:
    """A ``torch.profiler`` is recording."""
    return getattr(torch.autograd.profiler, "_is_profiler_enabled", False)


@contextmanager
def stage(name: str):
    """A span ``sdtk.<name>`` in a running profiler's trace and, with
    ``SDTK_PROFILE=1``, an accumulating wall-clock timer that waits for the
    stage's device work; a no-op with both off."""
    timed, traced = enabled(), _tracing()
    if not (timed or traced):
        yield
        return
    with torch.profiler.record_function(PREFIX + name) if traced else nullcontext():
        if not timed:
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
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            with _lock:
                _times[name].append(elapsed)


def count(name: str, n: "int | torch.Tensor" = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler runs or
    ``SDTK_PROFILE=1``.  A tensor ``n`` (a count still on the card) is kept
    and read by :func:`counters`, so counting never waits for the device.
    Inside :func:`tape`, ``n`` goes to the tape (a plain count only)."""
    taped = getattr(_taped, "tape", None)
    if taped is not None:
        if isinstance(n, torch.Tensor):
            raise ValueError(f"counter {name}: a count left on the card cannot be taped")
        taped.counts[name] = taped.counts.get(name, 0) + int(n)
        return
    if _tracing() or enabled():
        with _lock:
            if isinstance(n, torch.Tensor):
                _pending[name].append(n.detach())
            else:
                _counts[name] += int(n)


def launched(fn) -> None:
    """One launch of kernel wrapper ``fn``: added to ``fn.launches``, or,
    inside :func:`tape`, to the tape."""
    taped = getattr(_taped, "tape", None)
    if taped is None:
        fn.launches += 1
    else:
        taped.launches[fn] = taped.launches.get(fn, 0) + 1


class Tape:
    """What one thread counted inside :func:`tape`: ``counts`` by counter
    name, ``launches`` by kernel wrapper."""

    def __init__(self):
        self.counts: dict[str, int] = {}
        self.launches: dict[object, int] = {}

    def add(self) -> None:
        """Count all of it once more, as if it had run again."""
        for name, n in self.counts.items():
            count(name, n)
        for fn, n in self.launches.items():
            fn.launches += n


@contextmanager
def tape():
    """Within the block, this thread's :func:`count` and :func:`launched`
    calls add to the yielded :class:`Tape` and not to the registry or the
    wrappers, whether or not counting is on."""
    outer, _taped.tape = getattr(_taped, "tape", None), Tape()
    try:
        yield _taped.tape
    finally:
        _taped.tape = outer


def counters() -> dict[str, int]:
    with _lock:
        for name, kept in _pending.items():
            _counts[name] += sum(int(t) for t in kept)
        _pending.clear()
        return dict(_counts)


def report(out=None) -> None:
    counters()
    if not _times and not _counts:
        return
    out = out or sys.stderr
    print("── sdtk profile ──", file=out)
    width = max((len(k) for k in _times), default=0)
    for name, vals in sorted(_times.items(), key=lambda kv: -sum(kv[1])):
        total = sum(vals)
        print(
            f"  {name:<{width}}  {total:8.3f}s  ({len(vals)}x, avg {total / len(vals):.3f}s)",
            file=out,
        )
    if _counts:
        print("── sdtk counters ──", file=out)
        width = max(len(k) for k in _counts)
        for name, n in sorted(_counts.items()):
            print(f"  {name:<{width}}  {n}", file=out)


def reset() -> None:
    _times.clear()
    _counts.clear()
    _pending.clear()


def span_self_ms(events) -> dict[str, tuple[int, float]]:
    """{span name without ``sdtk.``: (calls, host ms)} over (start µs, end
    µs, name) host events; a span's time excludes the ``sdtk.*`` spans it
    holds, so the values add up to the spans' union."""
    spans = sorted((s, -e, n) for s, e, n in events if n.startswith(PREFIX))
    out: dict[str, tuple[int, float]] = {}
    stack: list[list] = []  # [end, name, self µs] of the open spans

    def close(until: float) -> None:
        while stack and stack[-1][0] <= until:
            end, name, own = stack.pop()
            calls, ms = out.get(name, (0, 0.0))
            out[name] = (calls + 1, ms + own / 1e3)

    for s, neg_e, name in spans:
        e = -neg_e
        close(s)
        if stack:
            stack[-1][2] -= e - s
        stack.append([e, name[len(PREFIX):], e - s])
    close(float("inf"))
    return out


@contextmanager
def trace(trace_dir: str | None = None):
    """Host and device timeline (``torch.profiler``, CPU and, where there
    is a card, CUDA activities) written under ``trace_dir`` or
    ``$SDTK_TRACE_DIR``; viewable in TensorBoard or chrome://tracing."""
    trace_dir = trace_dir or os.environ.get("SDTK_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(trace_dir))):
        yield
