"""``BENCHMARK.json`` against the benchmark's rules, and the files it names."""

import json
import re

import pytest
from conftest import HERE, ROOT

from benchlib import manifest

BENCH = manifest.load()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_no_rule_broken():
    assert manifest.problems(BENCH) == []


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_keys_names_and_units(metric):
    allowed = {"name", "unit", "better", "source", "workloads"}
    allowed |= {"bound"} if metric in BENCH["end_to_end"] else {"layer", "moves"}
    assert set(metric) <= allowed and set(metric) >= allowed - {"workloads"}
    assert manifest.NAME.match(metric["name"]) and manifest.UNIT.match(metric["unit"])
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_per_layer_moves_an_end_to_end_metric_of_the_same_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert manifest.reports(moved, cell), (m["name"], cell)
    layers = {m["layer"] for m in BENCH["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"| {layer} |" in perf, f"layer {layer!r} is not in PERF.md's list of layers"


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        names = [m["name"] for m in BENCH["end_to_end"] if manifest.reports(m, w["name"])]
        assert "setup_s" in names and len(names) >= 2
        assert any(manifest.reports(m, w["name"]) for m in BENCH["per_layer"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(conf):
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"] and data["source"] == conf["source"]
    assert conf["file"].startswith("benchmark/configs/")
    width = re.compile(r"(hidden|intermediate|latent|state|projection|head|_dim$|_rank$|channels"
                       r"|expansion|experts_per)")
    assert not [k for k in conf["reduced"] if width.search(k)]
    model = data["model"]
    assert model["channels"] % model["scale"] == 0 and model["dtype"] == "bfloat16"
    assert ("file" in data["weights"]) != ("seed" in data["weights"])


def test_each_traffic_has_a_loop_and_each_cell_its_limits():
    for w in BENCH["workloads"]:
        tr = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        assert (HERE / "loops" / f"{tr['loop']}.py").exists()
        limits = json.loads((HERE / "limits" / f"{w['name']}.json").read_text())["limits"]
        assert limits and all(v >= 0 for v in limits.values())


def test_metric_readers_return_nothing_without_a_trace():
    from types import SimpleNamespace

    from benchlib import trace

    empty = SimpleNamespace(trace=trace.parse([]), work={})
    for m in BENCH["per_layer"]:
        assert manifest.module("metrics", m["name"]).read(empty) is None, m["name"]
