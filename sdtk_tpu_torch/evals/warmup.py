"""Deploy-time warm-up of the serving shapes.

The counterpart of ``evals/warmup.py``.  It builds what a first request
would otherwise build: the four CUDA kernels (``nvcc``, into
``sdtk_tpu_torch/_build/``; on ``--device cuda`` only, as the CPU runs
their plain versions) and the host library (``g++``), then loads the
GPU backend's tower and calls each serving shape once, so the tower's
weights, cuDNN's plans and the allocator's pools are in place:

  (W, L) ``embed_rows``      W ∈ {1, 4, 16} × L ∈ {window/2, window}:
                             identify, verify, streaming and the evals
  (128, window/2), (128, 16 000)  ``embed``: the diarizer's chunk

Usage: python -m sdtk_tpu_torch.evals.warmup [--shapes 1x24000,16x48000,...]
       [--device cuda]
Prints one JSON line for the build, one for the engine, and one a shape
with its first-call seconds and a second call's milliseconds.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="sdtk_tpu_torch.evals.warmup")
    ap.add_argument("--shapes", default=None,
                    help="comma list of WxL (default: all serving shapes)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' builds only the host library)")
    args = ap.parse_args(argv)

    import torch

    from ..backends.base import get_backend
    from ..utils import build
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    kernels = sorted(build.build()) if device.type == "cuda" else []
    kernels_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = build.build_host()
    print(json.dumps({"stage": "build", "kernels": kernels, "kernels_s": round(kernels_s, 2),
                      "host_library": host.name,
                      "host_library_s": round(time.perf_counter() - t0, 2)}), flush=True)

    t0 = time.perf_counter()
    eng = get_backend("gpu", device=str(device)).engine
    print(json.dumps({"stage": "engine-init", "seconds": round(time.perf_counter() - t0, 1)}),
          flush=True)

    L, half = eng.window_len, eng.window_len // 2
    if args.shapes:
        shapes = [tuple(int(v) for v in s.split("x")) for s in args.shapes.split(",")]
    else:
        shapes = [(w, length) for length in (half, L) for w in (1, 4, 16)]
        shapes += [(128, half), (128, 16000)]  # the diarizer's chunk: 128 windows of 1.0 s

    def call(w: int, length: int) -> None:
        arr = np.zeros((w, length), np.float32)
        if w <= 16 and length in (half, L):
            eng.embed_rows(arr)  # ends on a device→host copy
        else:
            eng.embed(arr, np.full(w, length, np.int32)).cpu()

    for w, length in shapes:
        t0 = time.perf_counter()
        call(w, length)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        call(w, length)
        warm = time.perf_counter() - t0
        print(json.dumps({"shape": f"{w}x{length}", "first_call_s": round(first, 3),
                          "warm_call_ms": round(warm * 1000, 1),
                          "device": torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu"}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
