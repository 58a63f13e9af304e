"""Large-N identify scoring A/B: the fused kernel K2 against the library
decomposition (product -> (W, N) score matrix -> window max -> top-k).

The counterpart of ``evals/benchmark_topk.py``, with its flags but
``--tile-n``, plus ``--device``.  K2 (``ops/topk_fused.py:
identify_topk_fused``, ``csrc/identify_topk.cu``) takes W query windows and
the N-row profile matrix in bf16 as the store holds it, normalizes in
flight and never writes the (W, N) matrix.  The library side is
``ops/topk.py:identify_topk_plain(..., assume_normalized=True)`` on the
same profiles normalized beforehand (its best case, as in JAX): on the
card a cuBLAS product, ``amax`` and ``torch.topk``.  K2's launcher has
fixed 512-row tiles (``TILE``), so the JAX script's ``--tile-n`` has no
counterpart: a tile size the kernel would not use is not accepted.

Inputs as in JAX: ``default_rng(0)`` draws the (W, D) queries, then each
size's (N, D) profiles, once per process, on the host.  Parity comes
first and is a hard gate: each size's survivor sets must be equal
(overlap 1.0) and the sorted scores within 5e-2 (bf16 rounding of the two
sides' profiles); otherwise the line is printed, the failure goes to
stderr and the exit code is 1.  Then each call's time: CUDA events around
it, the median of ``--iters`` after 5 warm-up calls (the host clock on the
CPU), and its device time summed over its kernels (the larger of two
``torch.profiler`` traces, ``tools/measure.py:device_ms_total``; "not
measured" where neither shows any), beside K2's bound (its bytes
over HBM's rate against its products at two TF32 passes,
``tools/measure.py:bound``).

Keys, against the JAX script's: ``k2_ms`` is ``pallas_ms``,
``library_ms`` is ``xla_ms``, ``k2_wins_all`` is ``pallas_wins_all``;
``speedup``, ``survivor_overlap``, ``max_score_diff``, ``parity_ok`` and
the rest keep their names; ``tile_n`` is K2's fixed tile.  Added:
``k2_device_ms``, ``library_device_ms``, ``k2_kernels_device_ms`` (K2's
own kernels, without the merge's sort), ``k2_bound_ms``, ``k2_bound_by``
and ``launches``.

    python -m sdtk_tpu_torch.evals.benchmark_topk [--n 100000 1000000]
        [--windows 64] [--dim 192] [--k 64] [--iters 20] [--device cuda]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from ..ops.topk import identify_topk_plain
from ..ops.topk_fused import TILE, identify_topk_fused

OVERLAP_BAR, SCORE_BAR = 1.0, 5e-2  # the JAX script's gate


def profiles(rng: np.random.Generator, n: int, dim: int, device) -> tuple:
    """(N, D) raw profiles in bf16 and the same rows normalized in f32,
    then bf16, both on ``device``."""
    p_raw = rng.standard_normal((n, dim)).astype(np.float32)
    p = torch.from_numpy(p_raw).to(device=device, dtype=torch.bfloat16)
    p_raw /= np.linalg.norm(p_raw, axis=1, keepdims=True)
    return p, torch.from_numpy(p_raw).to(device=device, dtype=torch.bfloat16)


def parity(q, p, p_norm, k: int) -> dict:
    """Survivor overlap and the largest sorted-score difference of K2 on
    ``p`` against the library on ``p_norm``."""
    s_k2, i_k2 = identify_topk_fused(q, p, k)
    s_lib, i_lib = identify_topk_plain(q, p_norm, k, assume_normalized=True)
    overlap = len(set(i_k2.tolist()) & set(i_lib.tolist())) / max(k, 1)
    diff = float((torch.sort(s_k2).values - torch.sort(s_lib).values).abs().max())
    return {"survivor_overlap": overlap, "max_score_diff": diff}


def call_ms(fn, iters: int, device) -> float:
    """Median ms of a call of ``fn``: CUDA events on the card, the host
    clock on the CPU."""
    if device.type == "cuda":
        from ..tools.measure import event_ms

        return event_ms(fn, reps=iters, warmup=5)
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, device, kernel: str = ""):
    """Device ms per call of ``fn``, summed over its kernels whose name holds
    ``kernel`` (``tools/measure.py:device_ms_total``); None on the CPU."""
    if device.type != "cuda":
        return None
    from ..tools.measure import device_ms_total

    return device_ms_total(fn, kernel=kernel)


def measure_size(q, p, p_norm, k: int, iters: int) -> dict:
    """One size's row: parity, then the two calls' times and K2's bound."""
    from ..tools.measure import bound

    device = q.device
    row = parity(q, p, p_norm, k)

    def k2():
        return identify_topk_fused(q, p, k)

    def library():
        return identify_topk_plain(q, p_norm, k, assume_normalized=True)

    row["k2_ms"], row["library_ms"] = call_ms(k2, iters, device), call_ms(library, iters, device)
    row["speedup"] = row["library_ms"] / row["k2_ms"]
    row["k2_device_ms"] = device_ms(k2, device)
    row["k2_kernels_device_ms"] = device_ms(k2, device, "identify_topk")
    row["library_device_ms"] = device_ms(library, device)
    (w, d), n = q.shape, p.shape[0]
    b = bound(q.numel() * 4 + p.numel() * p.element_size() + k * (4 + 8),
              2 * w * n * d + 2 * (w + n) * d, "tf32x2")
    row["k2_bound_ms"], row["k2_bound_by"] = b["bound_ms"], b["bound_by"]
    return row


def parity_ok(sizes: dict) -> bool:
    return all(v["survivor_overlap"] >= OVERLAP_BAR and v["max_score_diff"] <= SCORE_BAR
               for v in sizes.values())


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="sdtk_tpu_torch.evals.benchmark_topk")
    ap.add_argument("--n", type=int, nargs="+", default=[100_000, 1_000_000])
    ap.add_argument("--windows", type=int, default=64)
    ap.add_argument("--dim", type=int, default=192)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((args.windows, args.dim)).astype(np.float32)
                         ).to(device)
    out = {"benchmark": "topk", "windows": args.windows, "dim": args.dim, "k": args.k,
           "tile_n": TILE, "backend": device.type, "sizes": {}}
    identify_topk_fused.launches = 0
    for n in args.n:
        p, p_norm = profiles(rng, n, args.dim, device)
        out["sizes"][str(n)] = measure_size(q, p, p_norm, args.k, args.iters)
        del p, p_norm
    out["launches"] = {"identify_topk": identify_topk_fused.launches}
    out["k2_wins_all"] = all(v["speedup"] > 1.0 for v in out["sizes"].values())
    out["parity_ok"] = parity_ok(out["sizes"])
    if device.type == "cuda":
        from ..tools.measure import smi

        out["nvidia_smi"] = smi("name,power.limit", index=device.index)
    print(json.dumps(out), flush=True)
    if not out["parity_ok"]:
        print("PARITY FAILURE: K2 and library survivor sets or scores diverge beyond the "
              f"bf16 tolerance (overlap {OVERLAP_BAR}, scores {SCORE_BAR})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
