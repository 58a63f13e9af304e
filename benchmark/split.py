"""Where a cell's traced slice goes, by the program's spans:

    python3 benchmark/split.py --workload <name> --seed <n>

Sets up the cell as ``run.py`` does, runs its traced slice (``trace_steps``
or ``trace_recordings``) and no timed window, and prints one JSON line:
``benchlib.spans.split`` of the slice (a step's window, busy and idle ms;
each ``sdtk.*`` span's calls and self ms; the idle ms under each leaf span
and the share of the idle time the leaves cover; the self times' shares
of the benchmark's ``bench.embed`` and ``bench.cluster`` spans), the
program's counters, the ten longest idle gaps by name, every per-layer
metric of the cell, and the device.  Exit code 2 without a CUDA device.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import run  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    run.fix_caches(run.ROOT)

    import torch

    from benchlib import harness, manifest, spans

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(manifest.load(), args.workload)
    dev = torch.device("cuda", 0)
    r = harness.Run(seed=args.seed, seconds=0.0, trace=True, device=dev, config=cell["config"],
                    traffic=cell["traffic"], root=run.ROOT, t_start=T_START)
    out = manifest.module("loops", cell["traffic"]["loop"]).run(r)
    ctx = SimpleNamespace(trace=out.trace, work=out.work)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        **spans.split(out.trace, out.work["steps"]),
        "counters": spans.counters(ctx),
        "idle_gaps": out.trace.breakdown()["idle_gaps"],
        "metrics": {m["name"]: manifest.module("metrics", m["name"]).read(ctx)
                    for m in cell["per_layer"]},
        "device": harness.device_info(dev, cell["workload"]["chips"], out.memory_peak_bytes)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
