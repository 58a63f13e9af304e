"""Readings that the limits of ``correct`` are set from, on the chip:

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--seconds 3] [--fault <name>]

Runs the cell's timed path for ``--seconds`` on each seed, as a run does,
and then the control (the plain reference at fp8 in the program's place) on
each control seed, in one process, and prints one JSON line per run with the
numbers compared; the last line holds, for each number, the largest the
program read and the smallest the control read.  With ``--fault`` every run
has that fault of ``benchlib/faults.py`` planted under the timed path, so
its readings are the fault's.  The benchmark's own runs never run the
control or a fault.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", default="")
    args = ap.parse_args(argv)
    run.fix_caches(run.ROOT)

    import torch

    from benchlib import manifest

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(manifest.load(), args.workload)
    if args.fault:
        from benchlib.faults import FAULTS

        FAULTS[args.fault](setattr)
    seeds = [("program", int(s)) for s in args.seeds.split(",") if s]
    seeds += [("control", int(s)) for s in args.control_seeds.split(",") if s]
    lower, upper = {}, {}
    for mode, seed in seeds:
        res = run.run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0), mode=mode,
                           t_start=time.perf_counter())
        values = {k: v["value"] for k, v in res["checks"].items()}
        print(json.dumps({"mode": mode, "fault": args.fault, "seed": seed,
                          "correct": res["correct"],
                          "attempted": res["attempted"], **values}), flush=True)
        for k, v in values.items():
            if mode == "program":
                lower[k] = max(lower.get(k, v), v)
            else:
                upper[k] = min(upper.get(k, v), v)
    print(json.dumps({"workload": args.workload, "fault": args.fault, "program_max": lower,
                      "control_min": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
