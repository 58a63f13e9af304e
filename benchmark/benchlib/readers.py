"""The arithmetic of the per-layer metrics, on a parsed trace and the work a
loop reports (``ctx.trace``, ``ctx.work``).  Each metric's file under
``metrics/`` names one of these; each returns None where it finds nothing to
read, never 0 for a share."""

from __future__ import annotations

import statistics

from benchlib import yardstick

K1 = "log_mel"  # K1's kernel: dft::log_mel_mma_kernel<...>


def k1_roofline(ctx):
    """K1's least time for its launch shape (``yardstick.k1_work`` on the
    data-sheet peaks) over the mean device time of its launches, in %; the
    mean is not moved by a launch the trace dropped."""
    times = [o.dur / 1e6 for o in ctx.trace.select(name_has=K1, kernels_only=True)]
    launches = ctx.work.get("k1_launches", [])
    if not times or not launches:
        return None
    fe = ctx.work["config"]["frontend"]
    least = sum(yardstick.bound_s(*yardstick.k1_work(b, n, fe), fe["compute_dtype"])
                for b, n in launches) / len(launches)
    return 100.0 * least / (sum(times) / len(times))


def tower_mfu(ctx):
    """The tower's analytic FLOPs for the traced windows over the device
    time of the kernels launched in the embed spans other than K1's, against
    the bf16 peak, in %."""
    secs = ctx.trace.device_s(span="embed", kernels_only=True, exclude=K1)
    if secs <= 0 or not ctx.work.get("windows"):
        return None
    m = ctx.work["config"]["model"]
    flops = yardstick.ecapa_flops_per_window(m, ctx.work["n_frames"]) * ctx.work["windows"]
    return 100.0 * flops / secs / yardstick.PEAK_FLOPS["bfloat16"]


def step_mfu(ctx):
    """The frontend's and the tower's analytic FLOPs for the traced windows
    over the traced window's wall time, against the bf16 peak, in %."""
    window = ctx.trace.window_s()
    if window <= 0 or not ctx.work.get("windows") or ctx.trace.busy_s() <= 0:
        return None
    cfg, n = ctx.work["config"], ctx.work["n_frames"]
    flops = (yardstick.ecapa_flops_per_window(cfg["model"], n)
             + yardstick.frontend_flops_per_window(cfg["frontend"], n)) * ctx.work["windows"]
    return 100.0 * flops / window / yardstick.PEAK_FLOPS["bfloat16"]


def cluster_device_ms(ctx):
    """Device ms a call of the operations launched in the cluster spans."""
    calls = ctx.trace.span_count("cluster")
    secs = ctx.trace.device_s(span="cluster")
    return 1e3 * secs / calls if calls and secs > 0 else None


def cluster_host_ms(ctx):
    """Host ms of the clustering call, the median over the window's calls."""
    times = ctx.work.get("cluster_s")
    return 1e3 * statistics.median(times) if times else None


def idle_share(ctx):
    """The share of the traced window in which no operation runs on the
    device (the complement of the union of device intervals), in %."""
    window, busy = ctx.trace.window_s(), ctx.trace.busy_s()
    return 100.0 * (1.0 - busy / window) if window > 0 and busy > 0 else None
