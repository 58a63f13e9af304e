"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by name:

- ``configs/<config>.json``: the tower's sizes and frontend, its weights and
  where they come from (``BENCHMARK.json`` names the file);
- ``traffic/<traffic>.json``: the mix's parameters, and the ``loop`` that
  runs it (``loops/<loop>.py``);
- ``limits/<workload>.json``: the limits of the numbers that decide
  ``correct`` in that cell;
- ``metrics/<metric>.py``: the reader of a per-layer metric, ``read(ctx)``.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell ``workload`` with its configuration, traffic, limits and the
    metrics it reports: {"workload", "config", "traffic", "limits",
    "end_to_end", "per_layer"}."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{wl['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    return {"workload": wl, "config": config, "traffic": traffic, "limits": limits["limits"],
            "end_to_end": [m for m in bench["end_to_end"] if reports(m, workload)],
            "per_layer": [m for m in bench["per_layer"] if reports(m, workload)]}


def reports(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark, loaded by path (a name may
    hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def problems(bench: dict, root: Path = ROOT) -> list[str]:
    """What in ``bench`` breaks the benchmark's rules of names and references."""
    out = []
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = ([c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in metrics] + [w["traffic"] for w in bench["workloads"]]
             + [k for c in bench["configs"] for k in c["reduced"]])
    out += [f"bad name {n!r}" for n in names if not NAME.match(n)]
    out += [f"bad unit {m['unit']!r}" for m in metrics if not UNIT.match(m["unit"])]
    for kind in ("configs", "workloads"):
        seen = [x["name"] for x in bench[kind]]
        out += [f"{kind}: {n} twice" for n in set(seen) if seen.count(n) > 1]
    seen = [m["name"] for m in metrics]
    out += [f"metric {n} twice" for n in set(seen) if seen.count(n) > 1]
    cells = {w["name"]: w for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        if w["config"] not in {c["name"] for c in bench["configs"]}:
            out.append(f"{w['name']}: no config {w['config']}")
        if not (HERE / "traffic" / f"{w['traffic']}.json").exists():
            out.append(f"{w['name']}: no traffic file")
        if not (HERE / "limits" / f"{w['name']}.json").exists():
            out.append(f"{w['name']}: no limits file")
        own = [m["name"] for m in bench["end_to_end"] if reports(m, w["name"])]
        if "setup_s" not in own or len(own) < 2:
            out.append(f"{w['name']}: needs setup_s and another end-to-end metric")
        if not any(reports(m, w["name"]) for m in bench["per_layer"]):
            out.append(f"{w['name']}: no per-layer metric")
    for m in metrics:
        out += [f"{m['name']}: no cell {c}" for c in m.get("workloads", []) if c not in cells]
        if m["better"] not in ("lower", "higher"):
            out.append(f"{m['name']}: better {m['better']!r}")
    for m in bench["end_to_end"]:
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"{m['name']}: end-to-end source {m['source']}")
        if not 0.01 <= m["bound"] <= 0.25:
            out.append(f"{m['name']}: bound {m['bound']}")
    for m in bench["per_layer"]:
        moved = e2e.get(m["moves"])
        if moved is None:
            out.append(f"{m['name']}: moves {m['moves']}, not an end-to-end metric")
            continue
        for c in m.get("workloads", list(cells)):
            if not reports(moved, c):
                out.append(f"{m['name']}: {m['moves']} is not reported in {c}")
        if not (HERE / "metrics" / f"{m['name']}.py").exists():
            out.append(f"{m['name']}: no reader")
    for c in bench["configs"]:
        if not (root / c["file"]).exists():
            out.append(f"{c['name']}: no file {c['file']}")
        if not any(w["config"] == c["name"] for w in bench["workloads"]):
            out.append(f"{c['name']}: used by no cell")
    return out
