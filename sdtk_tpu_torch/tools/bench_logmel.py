"""Device time of the two log-mel kernels, beside a library product.

    python -m sdtk_tpu_torch.tools.bench_logmel [--spin SECONDS] [--phases]

The device time (``torch.profiler``, mean of 20 launches) of
``log_mel_wave`` at (128, 16000) and (32, 48000) and of ``fbank_frames`` at
(12544, 400), bfloat16 compute, beside the time of one cuBLAS bfloat16
product of the DFT's size, (12544, 400) @ (400, 544).

Taken twice: in a process that has just started, and again after the card
has been kept busy for ``--spin`` seconds (default 2), since a card that
has idled runs the same kernel slower.  Each line carries the SM and
memory clocks ``nvidia-smi`` reads at that moment.

``--phases`` builds the two kernels a second time with
``-DDFT_PHASE_CLOCKS`` and prints, for the first block of each bfloat16
kernel, the SM clocks between its phase boundaries (``clock64``): the
frames into shared memory, the wait for the first chunk and the loading of
the A fragments, the chunks (DFT, power, mel), the log and the store.

One JSON object per line; the first names the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import time

from .measure import built_with, device_ms_by_kernel, smi


def phase_clocks(cases: dict) -> None:
    import ctypes

    import torch

    from ..utils import build

    with built_with("-DDFT_PHASE_CLOCKS"):
        for name, lib in (("log_mel_wave_128x16000", "log_mel_wave"),
                          ("fbank_frames_12544x400", "fbank_frames")):
            for _ in range(3):
                cases[f"{name}_ms"]()
            torch.cuda.synchronize()
            clocks = (ctypes.c_longlong * 8)()
            rc = build.load_library(lib).dft_phase_clocks_read(clocks)
            if rc:
                raise RuntimeError(f"dft_phase_clocks_read: CUDA error {rc}")
            t = list(clocks)
            print(json.dumps({"phase_clocks": name, "frames": t[1] - t[0],
                              "first_chunk_and_a": t[2] - t[1], "chunks": t[3] - t[2],
                              "log_and_store": t[4] - t[3], "total": t[4] - t[0]}), flush=True)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--spin", type=float, default=2.0,
                   help="seconds to keep the card busy before the second reading")
    p.add_argument("--phases", action="store_true",
                   help="clock64 at the phase boundaries of the bfloat16 kernels")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from ..ops import fbank, fbank_frames, fbank_wave

    print(json.dumps({"nvidia_smi": smi("name,power.limit")}), flush=True)
    cfg = fbank.FrontendConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = 0.1 * torch.randn(128, 16000, device="cuda", generator=gen)
    x32 = 0.1 * torch.randn(32, 48000, device="cuda", generator=gen)
    frames = 0.1 * torch.randn(12544, 400, device="cuda", generator=gen)
    a = torch.randn(12544, 400, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(400, 544, device="cuda", dtype=torch.bfloat16)
    cases = {
        "log_mel_wave_128x16000_ms": lambda: fbank_wave.log_mel_wave_cuda(x, cfg, 0.97),
        "log_mel_wave_32x48000_ms": lambda: fbank_wave.log_mel_wave_cuda(x32, cfg, 0.97),
        "fbank_frames_12544x400_ms": lambda: fbank_frames.fbank_frames_cuda(frames, cfg),
        "cublas_bf16_12544x400x544_ms": lambda: a @ b,
    }
    for state in ("fresh", "busy"):
        if state == "busy":
            end = time.perf_counter() + args.spin
            while time.perf_counter() < end:
                for fn in cases.values():
                    fn()
                torch.cuda.synchronize()
        print(json.dumps({"card": state, "clocks_sm_mem": smi("clocks.sm,clocks.mem"),
                          **{name: sum(device_ms_by_kernel(fn).values())
                             for name, fn in cases.items()}}), flush=True)
    if args.phases:
        phase_clocks(cases)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
