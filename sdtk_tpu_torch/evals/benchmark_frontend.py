"""Frontend A/B at the serving shape: the plain PyTorch log-mel against the
two log-mel kernels.

The counterpart of ``evals/benchmark_frontend.py``, with its flags but
``--chunk-rows``, plus ``--device``.  Three functions of one (B, N)
waveform, each to (B, T, 80) log-mel with CMN, in bf16 (the serving
type):

  torch      ``ops/fbank.py:log_mel``, plain PyTorch (JAX's XLA side);
  k4_frames  ``ops/fbank_frames.py:log_mel_fused``: the (B·T, 400) frames
             written out by ``unfold``, then K4 (``csrc/fbank_frames.cu``);
             at (1024, 48 000) that copy is 305 152 × 400 f32, 488 MB;
  k1_wave    ``ops/fbank_wave.py:log_mel_wave``: K1
             (``csrc/log_mel_wave.cu``) frames the waveform in shared
             memory.

K1 has no rows-per-step argument (its launcher tiles 128 frames a block),
so the JAX script's ``--chunk-rows`` has no counterpart, and the line
gives the tile instead (``k1_frames_per_block``).

First the spot checks, on the batch's first 4 rows: K1 and K4 against the
plain function, each at the kernel phase's bf16 bar (0.05 in ln); a check
above its bar prints the line, then the failure to stderr, and the exit
code is 1.  Then each function's ms per call over ``--iters`` calls, each
fed the one before (``evals/mfu_probe.py:bench``: CUDA events on the
card, the host clock on the CPU), and its device ms per call summed over
its kernels (the larger of two ``torch.profiler`` traces,
``tools/measure.py:device_ms_total``; "not measured" where neither shows
any; null on the CPU), and ``winner``, the fastest by ms.

Keys, against the JAX script's: ``torch_ms`` is ``xla_ms``,
``k4_frames_ms`` is ``pallas_frames_ms``, ``k1_wave_ms`` is
``pallas_wave_ms``, ``wave_vs_torch_max_abs_err`` is
``wave_vs_xla_max_abs_err``, ``k1_frames_per_block`` is ``chunk_rows``;
``benchmark``, ``batch``, ``seconds``, ``backend`` and ``winner`` keep
their names (``winner`` names one of the three above).  Added: each
function's ``*_device_ms``, ``frames_vs_torch_max_abs_err``, ``tol``,
``frames`` (M, the rows K4 takes) and the launches of K1 and K4.

    python -m sdtk_tpu_torch.evals.benchmark_frontend [--batch 1024]
        [--seconds 3] [--iters 20] [--device cuda]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

TOL = 0.05  # K1 / K4 against the plain function, bf16, ln (chip_smoke's kernel phase)
K1_FRAMES_PER_BLOCK = 128  # csrc/dft_mma.cuh: MT
FUNCTIONS = ("torch", "k4_frames", "k1_wave")


def functions(cfg) -> dict:
    """The three functions, by name: waveform -> feats."""
    from ..ops import fbank, fbank_frames, fbank_wave

    return {"torch": lambda a: fbank.log_mel(a, cfg)[0],
            "k4_frames": lambda a: fbank_frames.log_mel_fused(a, cfg)[0],
            "k1_wave": lambda a: fbank_wave.log_mel_wave(a, cfg)[0]}


def spot_checks(x, cfg) -> dict:
    """max|Δ| of K1 and K4 against the plain function on ``x``."""
    import torch

    fns = functions(cfg)
    with torch.inference_mode():
        ref = fns["torch"](x)
        return {"wave_vs_torch_max_abs_err": float((fns["k1_wave"](x) - ref).abs().max()),
                "frames_vs_torch_max_abs_err": float((fns["k4_frames"](x) - ref).abs().max())}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="sdtk_tpu_torch.evals.benchmark_frontend")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    import torch

    from ..ops import fbank_frames, fbank_wave
    from ..ops.fbank import FrontendConfig
    from ..utils.device import resolve_device
    from .mfu_probe import bench

    device = resolve_device(args.device)
    cfg = FrontendConfig()
    n = int(args.seconds * cfg.sample_rate)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((args.batch, n)).astype(np.float32)).to(device)

    fbank_wave.log_mel_wave.launches = fbank_frames.fbank_frames.launches = 0
    results = {"benchmark": "frontend", "batch": args.batch, "seconds": args.seconds,
               **spot_checks(x[:4], cfg), "tol": TOL,
               "frames": args.batch * cfg.num_frames(n)}
    fns = functions(cfg)
    for name, fn in fns.items():
        with torch.inference_mode():
            results[f"{name}_ms"] = bench(fn, x, args.iters, device) * 1e3
            results[f"{name}_device_ms"] = None
            if device.type == "cuda":
                from ..tools.measure import device_ms_total

                results[f"{name}_device_ms"] = device_ms_total(lambda fn=fn: fn(x), reps=5)
    results.update({"k1_frames_per_block": K1_FRAMES_PER_BLOCK, "backend": device.type,
                    "launches": {"log_mel_wave": fbank_wave.log_mel_wave.launches,
                                 "fbank_frames": fbank_frames.fbank_frames.launches}})
    results["winner"] = min(FUNCTIONS, key=lambda f: results[f"{f}_ms"])
    if device.type == "cuda":
        from ..tools.measure import smi

        results["nvidia_smi"] = smi("name,power.limit", index=device.index)
    print(json.dumps(results), flush=True)
    bad = [k for k in ("wave_vs_torch_max_abs_err", "frames_vs_torch_max_abs_err")
           if not results[k] <= TOL]
    if bad:
        print(f"PARITY FAILURE: {', '.join(bad)} above {TOL}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
