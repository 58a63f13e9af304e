"""Where the time goes in one offline diarization on the GPU.

    python -m sdtk_tpu_torch.tools.profile_diarize [--seconds 60] [--out trace.json]

Synthesizes a 3-speaker meeting, runs ``Diarizer(device="cuda")`` once to
warm up, then once more under ``torch.profiler`` (CPU + CUDA activities).
Prints one JSON line: each ``sdtk.*`` span's calls and host self ms (its
time less the spans it holds, ``utils.profiling.span_self_ms``), the
program's counters over the profiled run, total device kernel time, the
device's idle share of the wall time, and the kernels with the most device
time.  ``--out`` also writes the Chrome trace.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seconds", type=float, default=60.0, help="meeting length (approx.)")
    p.add_argument("--out", help="write the Chrome trace here")
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..data.synth import build_meeting
    from ..pipeline.diarize import Diarizer
    from ..utils import profiling

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    wav, _ = build_meeting(0, 3, max(2, int(args.seconds / 3.0)), 3.0)
    d = Diarizer(device="cuda")
    d.diarize_waveform(wav)  # warm-up: weights, cuDNN plans, kernel build
    torch.cuda.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        d.diarize_waveform(wav)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.out:
        prof.export_chrome_trace(args.out)

    def device_us(e) -> float:
        return float(getattr(e, "self_device_time_total", 0.0)
                     or getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only (kernels, memcpy/memset); CPU ops that
    # launched them, and the spans' ranges on the device's timeline, would
    # count the same time twice
    events = [e for e in prof.key_averages()
              if device_us(e) > 0 and str(e.device_type).endswith("CUDA")
              and not e.key.startswith(profiling.PREFIX)]
    total_us = sum(device_us(e) for e in events)
    top = sorted(events, key=device_us, reverse=True)[: args.top]
    print(json.dumps({
        "audio_seconds": len(wav) / 16000, "wall_seconds": wall,
        "span_self_ms": profiling.span_self_ms(  # the host's ranges, not their device copies
            (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if str(e.device_type).endswith("CPU")),
        "counters": profiling.counters(), "device_kernel_seconds": total_us / 1e6,
        "device_idle_share": 1.0 - total_us / 1e6 / wall,
        "top_kernels": [{"name": e.key[:90], "calls": e.count, "device_ms": device_us(e) / 1e3}
                        for e in top],
        "device": torch.cuda.get_device_name(0),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
