"""The benchmark's own tests run on the CPU: ``python -m pytest benchmark``.

They import the harness as ``run.py`` does (the benchmark's folder and the
checkout's root on the import path) and build small cells of their own, so
nothing here runs at a configuration's full size.
"""

import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

# a tower of the c1024 layout at a small width, for CPU runs
TINY = {"n_mels": 80, "channels": 64, "emb_dim": 32, "scale": 4, "se_bottleneck": 16,
        "attention_channels": 16, "mfa_channels": 192, "dilations": [2, 3, 4],
        "dtype": "bfloat16", "mfa_bn": True, "asp_tdnn": True}


def small_cell(workload: str, trained: bool = False, **traffic) -> dict:
    """Cell ``workload`` of ``BENCHMARK.json`` with a small tower (seeded
    weights), or with ``trained`` its configuration's own checkpoint, and
    the traffic's sizes overridden by ``traffic``; its limits are the
    cell's own."""
    from benchlib import manifest

    cell = manifest.cell(manifest.load(), workload)
    cfg = dict(cell["config"], name=f"small-{cell['config']['name']}", weights={"seed": 5})
    if trained:
        cfg["weights"] = {"file": str(ROOT / cell["config"]["weights"]["file"])}
    else:
        cfg["model"] = dict(TINY, mfa_bn=cfg["model"]["mfa_bn"],
                            asp_tdnn=cfg["model"]["asp_tdnn"])
    return dict(cell, config=cfg, traffic=dict(cell["traffic"], **traffic))


# a recording on the seeded small tower counts one speaker, whatever the
# labels; on the trained c512 tower it counts the meeting's voices.  30 s
# gives 78 windows, more than half of the diarizer's 128-window chunk
SMALL = {"batch": {"batch": 12, "warmup_steps": 1, "trace_steps": 1, "check_steps": 2},
         "recording": {"trained": True, "recording_s": 30.0, "warmup_recordings": 1,
                       "trace_recordings": 1, "check_recordings": 1}}


@pytest.fixture
def small(tmp_path):
    """(cell maker, root) for CPU runs whose seeded weights go to tmp_path."""
    def make(workload: str, **over):
        from benchlib import manifest

        loop = manifest.cell(manifest.load(), workload)["traffic"]["loop"]
        return small_cell(workload, **(SMALL[loop] | over))
    return make, tmp_path


def load_json(path) -> dict:
    return json.loads(Path(path).read_text())
