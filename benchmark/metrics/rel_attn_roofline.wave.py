"""The gated-bias attention's share of its roofline, in %: the least time of
the attention's own work (``wavlm_yardstick.attention_work``: q, k, v, o, the
gates and the table once, QKᵀ and AV; not the materialised bias) at the
traced launches' shape, over the mean device time of the attention kernels,
selected by name.  None where the trace holds no such kernel."""

from benchlib import wavlm_yardstick, yardstick
from benchlib.wavlm_yardstick import ATTENTION_KERNELS


def read(ctx):
    times = [o.dur / 1e6 for o in ctx.trace.ops if o.cat == "kernel"
             and any(n in o.name for n in ATTENTION_KERNELS)]
    if not times or not ctx.work.get("clips"):
        return None
    m = ctx.work["config"]["model"]
    b = ctx.work["clips"] // ctx.work["steps"]
    t = wavlm_yardstick.frames(ctx.work["samples"], m)[-1]
    least = yardstick.bound_s(*wavlm_yardstick.attention_work(b, t, m))
    return 100.0 * least / (sum(times) / len(times))
