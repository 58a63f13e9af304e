"""One run of one cell of the benchmark of ``sdtk_tpu_torch`` (the PyTorch
and CUDA port) on the machine it is started on:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It loads the cell's configuration and traffic (``BENCHMARK.json`` names
them), sets up and warms the program on the cell's shapes, measures for
``--seconds``, checks what the timed path produced against the plain
reference (``reference/``), and prints one JSON line last: the cell's
end-to-end metrics (``--trace 0``) or per-layer metrics from a profiled
slice of the window (``--trace 1``).  The numbers compared and their limits
are the last lines on standard error and the result's last key.

Exit codes: 0 with a result; 2 without the CUDA devices the cell asks for;
3 when JAX, flax or the JAX package was loaded; 1 on any other failure.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "sdtk_tpu")


def fix_caches(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program builds its own kernels into ``sdtk_tpu_torch/_build``)."""
    cache = root / ".benchcache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (names compared whole: ``sdtk_tpu_torch`` is not ``sdtk_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, mode: str = "program",
             t_start: float = T_START, root: Path = ROOT) -> dict:
    """Run ``cell`` (``benchlib.manifest.cell``) once; the result object."""
    from benchlib import check, harness, manifest

    r = harness.Run(seed=seed, seconds=seconds, trace=trace, device=device, config=cell["config"],
                    traffic=cell["traffic"], root=root, t_start=t_start, mode=mode)
    out = manifest.module("loops", cell["traffic"]["loop"]).run(r)
    correct, table = check.verdict(out.numbers, cell["limits"])
    metrics = {}
    if trace:
        ctx = SimpleNamespace(trace=out.trace, work=out.work)
        for m in cell["per_layer"]:
            value = manifest.module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
    dev = harness.device_info(device, cell["workload"]["chips"], out.memory_peak_bytes)
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = out.trace.busy_s()
        dev["window_s"] = out.trace.window_s()
        result["breakdown"] = out.trace.breakdown()
    result["checks"] = table
    return result


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fix_caches(ROOT)

    from benchlib import check, manifest

    cell = manifest.cell(manifest.load(), args.workload)
    import torch

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}", file=sys.stderr)
        return 3
    check.print_table(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
