"""Device time of the cosine kernel (``csrc/cosine.cu``) beside the library
call for the same function.

    python -m sdtk_tpu_torch.tools.bench_cosine [--trees DIR ...] [--phases]

At the dense identify shape (29 windows x 8 192 profiles x 192), at
(32, 4 096, 192) and a ragged (29, 4 093, 192), for a 5-minute query
(199 x 8 192 x 192) and at the x-vector width (29 x 8 192 x 512) it
prints, from ``torch.profiler`` (mean of 20 calls): the kernel's device
time, the device time of the library call ``F.normalize(q) @
F.normalize(p).T`` (all its kernels) and of its product alone; the
CUDA-event times of both calls (median of 30, after 5 warm-up calls); and
the host time of each call, from its start to its return with the card
idle (median of 50).

``--trees`` runs this tool once per directory, each a checkout of the
repository, in a fresh process with that directory as its working
directory, in the order given (for example parent, change, change,
parent).  ``--phases`` builds the kernel a second time with
``-DCOSINE_PHASE_CLOCKS`` and prints, at each shape, the SM clocks that
thread 0 of block 0 spends waiting for its copies, in products and in the
epilogue.

One JSON object per line, each with the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them.
"""

from __future__ import annotations

import argparse
import json

from .measure import built_with, device_ms_by_kernel, event_ms, host_ms, run_per_tree, smi

SHAPES = [  # (name, Q, N, D)
    ("identify", 29, 8192, 192),
    ("n4096", 32, 4096, 192),
    ("ragged", 29, 4093, 192),
    ("q199", 199, 8192, 192),  # a 5-minute query
    ("d512", 29, 8192, 512),   # the x-vector width
]
PHASES = ("wait_for_copies", "products", "epilogue")


def inputs(q: int, n: int, d: int, seed: int = 0):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(q, d, device="cuda", generator=gen),
            torch.randn(n, d, device="cuda", generator=gen))


def bench(card: str) -> None:
    import torch
    import torch.nn.functional as F

    from ..ops import cosine

    torch.backends.cuda.matmul.allow_tf32 = False  # the library product in full f32
    for name, nq, n, d in SHAPES:
        q, p = inputs(nq, n, d)
        qn, pn = F.normalize(q, dim=1), F.normalize(p, dim=1)

        def kernel(q=q, p=p):
            return cosine.cosine_cuda(q, p)

        def library(q=q, p=p):
            return F.normalize(q, dim=1) @ F.normalize(p, dim=1).T

        by_kernel = device_ms_by_kernel(kernel)
        print(json.dumps({
            "nvidia_smi": card, "shape": name, "q": nq, "n": n, "d": d,
            "kernel_device_ms": sum(v for key, v in by_kernel.items() if "cosine_kernel" in key),
            "other_device_ms": sum(v for key, v in by_kernel.items()
                                   if "cosine_kernel" not in key),
            "library_device_ms": sum(device_ms_by_kernel(library).values()),
            "library_product_device_ms": sum(device_ms_by_kernel(lambda: qn @ pn.T).values()),
            "kernel_event_ms": event_ms(kernel), "library_event_ms": event_ms(library),
            "kernel_host_ms": host_ms(kernel), "library_host_ms": host_ms(library)}),
            flush=True)


def phase_clocks(card: str) -> None:
    import ctypes

    import torch

    from ..ops import cosine
    from ..utils import build

    with built_with("-DCOSINE_PHASE_CLOCKS"):
        for name, nq, n, d in SHAPES:
            q, p = inputs(nq, n, d)
            for _ in range(3):
                cosine.cosine_cuda(q, p)
            torch.cuda.synchronize()
            clocks = (ctypes.c_longlong * len(PHASES))()
            rc = build.load_library("cosine").cosine_phase_clocks_read(clocks)
            if rc:
                raise RuntimeError(f"cosine_phase_clocks_read: CUDA error {rc}")
            print(json.dumps({"nvidia_smi": card, "phase_clocks": name,
                              **dict(zip(PHASES, list(clocks))), "total": sum(clocks)}),
                  flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", metavar="DIR",
                    help="run once per checkout, each in a fresh process, in this order")
    ap.add_argument("--phases", action="store_true",
                    help="SM clocks by phase in block 0, at each shape")
    args = ap.parse_args(argv)
    if args.trees:
        return run_per_tree("sdtk_tpu_torch.tools.bench_cosine", args.trees, ["--phases"] if args.phases else [])

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
