"""Reduction of a ``torch.profiler`` Chrome trace to device time.

Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events.  Busy time is the length of the union of their
intervals inside the traced window (the benchmark's ``bench.window`` span,
which ends after a synchronize, or its ``bench.request`` spans where a loop
marks requests), so overlapping streams count once.  An
operation belongs to a benchmark span (``bench.<name>``) when the host call
that launched it (the runtime event with its correlation id) lies inside
that span.  Idle gaps are named by the innermost host event under their
middle.  Times in the trace are microseconds.
"""

from __future__ import annotations

import json
from bisect import bisect_right
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
SPAN_PREFIX = "bench."


@dataclass
class Op:
    name: str
    ts: float
    dur: float
    cat: str
    span: str | None = None


@dataclass
class Trace:
    ops: list[Op]
    spans: dict[str, list[tuple[float, float]]]
    host: list[tuple[float, float, str]] = field(default_factory=list)

    def window(self) -> list[tuple[float, float]]:
        """The traced intervals: the ``request`` spans where a loop marks
        its requests (the time the system serves, without the load
        generator's), else the ``window`` span."""
        return merged(self.spans.get("request", []) or self.spans.get("window", []))

    def window_s(self) -> float:
        return sum(end - start for start, end in self.window()) / 1e6

    def busy_s(self) -> float:
        return union_length([(max(o.ts, a), min(o.ts + o.dur, b))
                             for a, b in self.window() for o in self.ops]) / 1e6

    def idle_gaps(self) -> list[tuple[float, float]]:
        busy = merged([(o.ts, o.ts + o.dur) for o in self.ops])
        gaps = []
        for start, end in self.window():
            t = start
            for a, b in busy:
                if b <= t or a >= end:
                    continue
                if a > t:
                    gaps.append((t, a))
                t = max(t, b)
            if t < end:
                gaps.append((t, end))
        return gaps

    def span_count(self, name: str) -> int:
        return len(self.spans.get(name, []))

    def device_s(self, span: str | None = None, name_has: str | None = None,
                 kernels_only: bool = False, exclude: str | None = None) -> float:
        """Summed device seconds of the operations launched in ``span``
        (any span when None), whose name holds ``name_has`` and not
        ``exclude``."""
        return sum(o.dur for o in self.select(span, name_has, kernels_only, exclude)) / 1e6

    def select(self, span=None, name_has=None, kernels_only=False, exclude=None) -> list[Op]:
        return [o for o in self.ops
                if (span is None or o.span == span)
                and (name_has is None or name_has in o.name)
                and (exclude is None or exclude not in o.name)
                and (not kernels_only or o.cat == "kernel")]

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict[str, float] = {}
        for o in self.ops:
            by_name[o.name] = by_name.get(o.name, 0.0) + o.dur / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": [[self.host_at((a + b) / 2)[:200], (b - a) / 1e6] for a, b in gaps]}

    def host_at(self, t: float) -> str:
        """The enclosing benchmark span and the innermost host event at t."""
        inner = [(e - s, n) for s, e, n in self.host if s <= t <= e]
        span = next((n for n, iv in self.spans.items() if n not in ("window", "request")
                     and any(s <= t <= e for s, e in iv)), None)
        name = min(inner)[1] if inner else "host"
        if name in (f"{SPAN_PREFIX}window", f"{SPAN_PREFIX}request"):
            name = "python"  # between host operations, in no benchmark span
        return f"{SPAN_PREFIX}{span}/{name}" if span and not name.startswith(SPAN_PREFIX) else name


def merged(intervals):
    out = []
    for a, b in sorted(iv for iv in intervals if iv[1] > iv[0]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(iv) for iv in out]


def union_length(intervals) -> float:
    return sum(b - a for a, b in merged(intervals))


def parse(events: list[dict]) -> Trace:
    """A ``Trace`` from the ``traceEvents`` of a Chrome trace."""
    launches: dict[int, float] = {}
    spans: dict[str, list[tuple[float, float]]] = {}
    host, device = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, e.get("name", "")))
            if cat in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = ts
            if cat == "user_annotation" and e.get("name", "").startswith(SPAN_PREFIX):
                spans.setdefault(e["name"][len(SPAN_PREFIX):], []).append((ts, ts + dur))
    span_ivs = sorted((s, e, n) for n, ivs in spans.items() if n not in ("window", "request")
                      for s, e in ivs)
    starts = [s for s, _, _ in span_ivs]
    ops = []
    for e in device:
        launch = launches.get(e.get("args", {}).get("correlation"))
        span = None
        if launch is not None:
            i = bisect_right(starts, launch) - 1
            while i >= 0 and span is None:  # innermost span that holds the launch
                s, end, n = span_ivs[i]
                span = n if s <= launch <= end else None
                i -= 1
        ops.append(Op(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)),
                      e["cat"], span))
    return Trace(ops, spans, host)


def load(path) -> Trace:
    with open(path) as f:
        data = json.load(f)
    return parse(data["traceEvents"] if isinstance(data, dict) else data)
