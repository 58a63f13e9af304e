"""``correct`` fails where it must: the control (the plain reference at fp8 in
the program's place) reads far above the program, and a run with the timed
path broken underneath comes out not correct, once for each fault a cell can
have (``benchlib/faults.py``).  Small cells on the CPU, the cells' own
limits; the harness's look for a chip is skipped (``run.run_cell`` on the
CPU).  The cells run on one chip, so no exchange between chips can be left
out."""

import time

import pytest
import torch

import run
from benchlib.faults import FAULTS

CELLS = ["ecapa-c512.batch-3s", "ecapa-c1024.batch-3s", "ecapa-c512.recording-10min"]


def go(small, workload, mode="program", **over):
    make, root = small
    return run.run_cell(make(workload, **over), 20260, 0.05, False, torch.device("cpu"),
                        mode=mode, t_start=time.perf_counter(), root=root)


@pytest.mark.parametrize("workload", CELLS)
def test_program_passes_and_the_control_reads_far_above_it(small, workload):
    ok = go(small, workload)
    control = go(small, workload, mode="control")
    assert ok["correct"], ok["checks"]
    gap, control_gap = (r["checks"]["emb_cos_gap"]["value"] for r in (ok, control))
    assert control_gap > 10 * gap


# ecapa-c1024.batch-3s holds its labels to a share of the windows (its seeded
# tower leaves a few windows of the k = 8 partition to rounding), so its
# altered answer is an eighth of the windows; the other cells' labels are
# exact, and one altered window fails them
ALTERED = {"ecapa-c1024.batch-3s": "altered_labels"}
FAULT_CASES = [(w, f) for w in CELLS
               for f in ("stale", "half_batch", "stale_labels", ALTERED.get(w, "altered_label"))]


@pytest.mark.parametrize("workload,fault", FAULT_CASES)
def test_a_broken_timed_path_is_not_correct(small, monkeypatch, workload, fault):
    FAULTS[fault](monkeypatch.setattr)
    got = go(small, workload)
    assert got["correct"] is False, got["checks"]
