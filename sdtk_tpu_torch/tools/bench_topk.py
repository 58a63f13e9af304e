"""Device time of the identify kernel's two passes and its merge, beside
the library call for the same function.

    python -m sdtk_tpu_torch.tools.bench_topk [--trees DIR ...] [--phases]

At the identify shape (32 windows x 8 192 profiles x 192, k 192) and at
catalog scale (64 x 100 000 x 192, k 64, f32 and bf16 profiles; and
x 512 columns, f32), and with 512 windows (a 10-minute query, bucketed)
against 8 192 and 100 000 profiles, it prints, from ``torch.profiler``
(mean of 20 calls): the device time of the queries' split (``identify_topk_split``),
of pass A (``identify_topk_max``), of pass B (``identify_topk_select``)
and of the merge (every other kernel of the wrapper call: the sort of the
survivors and the gathers); the device time
of the library product ``F.normalize(q) @ F.normalize(p).T`` alone and of
the whole library call ``torch.topk(... .amax(0), k)``; the CUDA-event
times of the wrapper and of the library call (median of 30, after 5
warm-up calls); and the host time of each call, from its start to its
return with the card idle (median of 50).

``--trees`` runs this tool once per directory, each a checkout of the
repository, in a fresh process with that directory as its working
directory, in the order given (for example parent, change, change,
parent): device times read in a process that has loaded several builds
of one kernel drift.  ``--phases`` builds the kernel a second time with
``-DTOPK_PHASE_CLOCKS`` and prints, for pass A's first block at catalog
scale (f32), the SM clocks its thread 0 spends in each phase.

One JSON object per line, each with the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them.
"""

from __future__ import annotations

import argparse
import json

from .measure import built_with, device_ms_by_kernel, event_ms, host_ms, run_per_tree, smi

SHAPES = [  # (name, W, N, D, k, profile dtype)
    ("identify", 32, 8192, 192, 192, "float32"),
    ("catalog", 64, 100_000, 192, 64, "float32"),
    ("catalog-bf16", 64, 100_000, 192, 64, "bfloat16"),
    ("catalog-d512", 64, 100_000, 512, 64, "float32"),
    ("identify-w512", 512, 8192, 192, 192, "float32"),  # a 10-minute query, bucketed
    ("catalog-w512", 512, 100_000, 192, 64, "float32"),
]
PHASES = ("query_staging", "wait_for_chunk", "land_chunk", "product", "window_max", "tail")


def inputs(w: int, n: int, d: int, dtype: str, seed: int = 0):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(w, d, device="cuda", generator=gen)
    p = torch.randn(n, d, device="cuda", generator=gen).to(getattr(torch, dtype))
    return q, p


def bench(card: str) -> None:
    import torch
    import torch.nn.functional as F

    from ..ops import topk_fused

    torch.backends.cuda.matmul.allow_tf32 = False  # the library product in full f32
    for name, w, n, d, k, dtype in SHAPES:
        q, p = inputs(w, n, d, dtype)
        qn, pn = F.normalize(q, dim=1), F.normalize(p.float(), dim=1)

        def kernel(q=q, p=p, k=k):
            return topk_fused.identify_topk_cuda(q, p, k)

        def library(q=q, p=p, k=k):
            return torch.topk((F.normalize(q, dim=1) @ F.normalize(p.float(), dim=1).T).amax(0), k)

        by_kernel = device_ms_by_kernel(kernel)
        pass_a = sum(v for key, v in by_kernel.items() if "identify_topk_max" in key)
        pass_b = sum(v for key, v in by_kernel.items() if "identify_topk_select" in key)
        split = sum(v for key, v in by_kernel.items() if "identify_topk_split" in key)
        print(json.dumps({
            "nvidia_smi": card, "shape": name, "w": w, "n": n, "d": d, "k": k, "profiles": dtype,
            "split_device_ms": split, "pass_a_device_ms": pass_a, "pass_b_device_ms": pass_b,
            "merge_device_ms": sum(by_kernel.values()) - split - pass_a - pass_b,
            "kernel_device_ms": sum(by_kernel.values()),
            "library_product_device_ms": sum(device_ms_by_kernel(lambda: qn @ pn.T).values()),
            "library_device_ms": sum(device_ms_by_kernel(library).values()),
            "kernel_event_ms": event_ms(kernel), "library_event_ms": event_ms(library),
            "kernel_host_ms": host_ms(kernel), "library_host_ms": host_ms(library)}),
            flush=True)


def phase_clocks(card: str) -> None:
    import ctypes

    import torch

    from ..ops import topk_fused
    from ..utils import build

    with built_with("-DTOPK_PHASE_CLOCKS"):
        _, w, n, d, k, dtype = SHAPES[1]
        q, p = inputs(w, n, d, dtype)
        for _ in range(3):
            topk_fused.identify_topk_cuda(q, p, k)
        torch.cuda.synchronize()
        clocks = (ctypes.c_longlong * 8)()
        rc = build.load_library("identify_topk").identify_topk_phase_clocks_read(clocks)
        if rc:
            raise RuntimeError(f"identify_topk_phase_clocks_read: CUDA error {rc}")
        print(json.dumps({"nvidia_smi": card, "phase_clocks": "catalog",
                          **dict(zip(PHASES, list(clocks))), "total": sum(list(clocks)[:6])}),
              flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", metavar="DIR",
                    help="run once per checkout, each in a fresh process, in this order")
    ap.add_argument("--phases", action="store_true",
                    help="SM clocks by phase in pass A's first block (catalog scale, f32)")
    args = ap.parse_args(argv)
    if args.trees:
        return run_per_tree("sdtk_tpu_torch.tools.bench_topk", args.trees, ["--phases"] if args.phases else [])

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = smi("name,power.limit")
    bench(card)
    if args.phases:
        phase_clocks(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
