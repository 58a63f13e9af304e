"""The whole step's share of the bf16 peak in the waveform cell: the model's
analytic FLOPs for the traced clips (``wavlm_yardstick.flops_per_clip``,
padded frames included) over the traced window's wall time, in %."""

from benchlib import wavlm_yardstick, yardstick


def read(ctx):
    window = ctx.trace.window_s()
    if window <= 0 or not ctx.work.get("clips") or ctx.trace.busy_s() <= 0:
        return None
    flops = wavlm_yardstick.flops_per_clip(ctx.work["config"]["model"], ctx.work["samples"])
    return 100.0 * flops * ctx.work["clips"] / window / yardstick.PEAK_FLOPS["bfloat16"]
