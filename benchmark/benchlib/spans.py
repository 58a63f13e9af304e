"""The program's own spans and counters in a traced run.

While a profiler records, the port opens a range ``sdtk.<name>`` around
each of its stages (``sdtk_tpu_torch.utils.profiling.stage``); they reach
``Trace.host`` as host events on the trace's clock, nested in the
benchmark's spans.  A span's self time is its time inside the traced window
less that of the ``sdtk.*`` spans it holds.  The program's counters
(``profiling.counters()``) count only while a profiler records, so in a
traced run they cover the traced slice.  A program without them (an older
checkout) leaves each reader None."""

from __future__ import annotations

from benchlib.trace import merged

PREFIX = "sdtk."


def program_spans(trace) -> list[tuple[float, float, str]]:
    """(start µs, end µs, name without ``sdtk.``), by start, outer first."""
    return sorted(((s, e, n[len(PREFIX):]) for s, e, n in trace.host if n.startswith(PREFIX)),
                  key=lambda x: (x[0], -x[1]))


def overlap(a: list[tuple[float, float]], b: list[tuple[float, float]]) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def self_us(spans, window) -> list[tuple[str, float]]:
    """(name, self µs inside ``window``) of each span of ``program_spans``."""
    out = []
    for i, (s, e, name) in enumerate(spans):
        inner, j = [], i + 1
        while j < len(spans) and spans[j][0] < e:
            if spans[j][1] <= e:
                inner.append(spans[j][:2])
            j += 1
        out.append((name, overlap([(s, e)], window) - overlap(merged(inner), window)))
    return out


def leaves(spans) -> list[tuple[float, float, str]]:
    """The spans that hold no other ``sdtk.*`` span."""
    return [sp for i, sp in enumerate(spans)
            if not (i + 1 < len(spans) and spans[i + 1][0] < sp[1] and spans[i + 1][1] <= sp[1])]


def split(trace, steps: int) -> dict:
    """Where the traced steps went, a step at a time: the window, the
    device's busy and idle ms; each span's calls and self ms; the idle ms
    under each leaf span and the share of the idle time the leaves cover;
    the self ms of the embed spans (``diarize.*``, ``embed.*``) and of the
    clustering's (``cluster.*``) as shares of the ``bench.embed`` and
    ``bench.cluster`` spans' time."""
    spans, window, gaps = program_spans(trace), trace.window(), trace.idle_gaps()
    idle = sum(b - a for a, b in gaps)
    own: dict[str, float] = {}
    for name, us in self_us(spans, window):
        own[name] = own.get(name, 0.0) + us
    leaf = leaves(spans)
    under = {n: overlap(gaps, merged([(s, e) for s, e, m in leaf if m == n]))
             for n in sorted({n for _, _, n in leaf})}
    outside = {k: overlap(merged(v), window) for k, v in trace.spans.items()}

    def share(prefixes, span):
        mine = sum(us for n, us in own.items() if n.startswith(prefixes))
        return mine / outside[span] if outside.get(span) else None

    return {"steps": steps, "window_ms": trace.window_s() * 1e3 / steps,
            "busy_ms": trace.busy_s() * 1e3 / steps, "idle_ms": idle / 1e3 / steps,
            "calls": {n: sum(1 for _, _, m in spans if m == n) / steps for n in sorted(own)},
            "self_ms": {n: us / 1e3 / steps for n, us in sorted(own.items())},
            "idle_under_leaf_ms": {n: us / 1e3 / steps for n, us in under.items()},
            "idle_under_leaf_share": (overlap(gaps, merged([(s, e) for s, e, _ in leaf])) / idle
                                      if idle else None),
            "embed_self_share": share(("diarize.", "embed."), "embed"),
            "cluster_self_share": share(("cluster.",), "cluster")}


def ms_per_step(*names: str):
    """A reader: the summed self ms of the spans ``names`` over the traced
    steps (``ctx.work["steps"]``); None where no such span was traced."""
    def read(ctx):
        steps = ctx.work.get("steps")
        spans = program_spans(ctx.trace)
        if not steps or not any(n in names for _, _, n in spans):
            return None
        window = ctx.trace.window()
        return sum(us for n, us in self_us(spans, window) if n in names) / 1e3 / steps
    return read


def idle_ms_per_step(prefix: str):
    """A reader: ms a step in which the device is idle under the spans
    whose name starts with ``prefix``; None where none was traced."""
    def read(ctx):
        steps = ctx.work.get("steps")
        under = merged([(s, e) for s, e, n in program_spans(ctx.trace) if n.startswith(prefix)])
        if not steps or not under:
            return None
        return overlap(ctx.trace.idle_gaps(), under) / 1e3 / steps
    return read


def counters(ctx) -> dict | None:
    """The program's counters, where the trace holds its spans."""
    if not ctx.work.get("steps") or not program_spans(ctx.trace):
        return None
    try:
        from sdtk_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "counters", None)
    return read() if read else None


def pad_row_share(ctx):
    """Pad rows among the rows the embed engine ran, in %."""
    c = counters(ctx)
    if not c or not c.get("embed.rows"):
        return None
    return 100.0 * c.get("embed.pad_rows", 0) / c["embed.rows"]


def h2d_mb(ctx):
    """MB a step copied from the host to the card by the embed engine."""
    c = counters(ctx)
    if not c or "embed.h2d_bytes" not in c:
        return None
    return c["embed.h2d_bytes"] / 1e6 / ctx.work["steps"]
