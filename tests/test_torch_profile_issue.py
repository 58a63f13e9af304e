"""``tools/profile_issue.py``: the host-issue profile of one chunk, on the
CPU (the eager route: no epilogue launch, so no wrapper time)."""

import contextlib
import cProfile
import io
import json
import pstats

import pytest

from sdtk_tpu_torch.tools import profile_issue


@pytest.mark.parametrize("path,func,group", [
    ("/x/sdtk_tpu_torch/models/ecapa.py", "serving", "route"),
    ("/x/sdtk_tpu_torch/models/ecapa.py", "_serving_copy", "route"),
    ("/x/sdtk_tpu_torch/models/ecapa.py", "forward", "tower_python"),
    ("/x/sdtk_tpu_torch/ops/tower_epilogue.py", "_check", "wrapper"),
    ("/x/sdtk_tpu_torch/utils/build.py", "launch", "wrapper"),
    ("/x/sdtk_tpu_torch/utils/profiling.py", "count", "counters"),
    ("~", "<built-in method torch.conv1d>", "torch_ops"),
    ("/x/torch/nn/modules/module.py", "_call_impl", "module_call"),
    ("/usr/lib/python3.12/json/__init__.py", "dumps", "other"),
])
def test_group(path, func, group):
    assert profile_issue._group(path, func) == group


def test_split_counts_per_forward():
    def route_like():
        return sum(range(10))

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(4):
        route_like()
    prof.disable()
    out = profile_issue.split(pstats.Stats(prof), reps=4, top=3)
    assert out["profiled_ms"] == pytest.approx(sum(out["group_ms"].values()))
    assert len(out["top"]) <= 3 and all(r["self_ms"] >= 0 for r in out["top"])
    assert out["calls_per_forward"] == {}  # nothing of the route or the wrapper ran


def test_main_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = profile_issue.main(["--device", "cpu", "--windows", "2", "--reps", "2", "--top", "4"])
    assert rc == 0
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    issue, prof, route = (ln[k] for ln, k in zip(lines, ("issue", "profile", "route")))
    assert issue["card"] == "cpu" and issue["windows"] == 2
    assert issue["embed_issue_ms"] > 0 and issue["tower_issue_ms"] > 0
    assert prof["group_ms"]["torch_ops"] > 0 and len(prof["top"]) == 4
    assert prof["calls_per_forward"]["_epilogue"] == 29  # c512: every epilogue, eager
    assert "tower_epilogue_cuda" not in prof["calls_per_forward"]
    assert route["wrapper_ms"] == 0 and route["route_ms"] >= 0
    assert set(route["us_per_call"]) == {"serving", "_cast_copy", "serving_affine", "relu_eager"}
