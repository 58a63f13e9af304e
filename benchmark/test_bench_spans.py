"""The readers of the program's spans and counters (``benchlib/spans.py``)
on a canned trace with ``sdtk.*`` annotations and a filled registry, and
on small traced runs on the CPU."""

import time

import pytest
import torch
from test_bench_trace import CANNED, ev, read

import run
from benchlib import spans, trace
from sdtk_tpu_torch.utils import profiling

NEW = ["windows_ms.recording", "copy_in_ms.recording", "embed_issue_ms.recording",
       "device_wait_ms.recording", "eig_ms.recording", "kmeans_ms.recording",
       "merge_count_ms.recording", "pad_row_share.recording", "h2d_mb.recording",
       "cluster_idle_ms.batch"]


def sdtk(name, ts, dur):
    return ev("user_annotation", f"sdtk.{name}", ts, dur)


# two requests of 1 000 µs; the first holds the embed spans and a
# clustering whose eigensolve holds the subspace start (40 µs); one window
# span straddles the second request's start, one lies between requests
REQUESTS = [
    ev("user_annotation", "bench.request", 0, 1000),
    ev("user_annotation", "bench.request", 2000, 1000),
    ev("user_annotation", "bench.embed", 10, 590),
    sdtk("diarize.windows", 20, 80),
    sdtk("embed.copy_in", 100, 50),
    ev("cuda_runtime", "cudaMemcpyAsync", 110, 5, corr=1),
    sdtk("embed.issue", 150, 150),
    ev("cuda_runtime", "cudaLaunchKernel", 160, 5, corr=2),
    sdtk("diarize.copy_out", 300, 100),
    ev("user_annotation", "bench.cluster", 610, 380),
    sdtk("cluster.copy_in", 620, 30),
    sdtk("cluster.affinity", 650, 50),
    sdtk("cluster.eig", 700, 200),
    sdtk("cluster.start", 720, 40),
    ev("cuda_runtime", "cudaLaunchKernel", 780, 5, corr=3),
    sdtk("cluster.kmeans", 900, 50),
    sdtk("cluster.copy_out", 950, 10),
    sdtk("cluster.merge_count", 960, 30),
    sdtk("diarize.windows", 1200, 100),
    sdtk("diarize.windows", 1900, 200),
    ev("gpu_memcpy", "Memcpy HtoD", 120, 30, corr=1),
    ev("kernel", "sm90_xmma_fprop", 170, 330, corr=2),
    ev("kernel", "geqrf", 800, 50, corr=3),
]
WORK = {"steps": 2}


@pytest.fixture
def tr():
    return trace.parse(REQUESTS)


@pytest.mark.parametrize("name,us", [
    ("windows_ms.recording", 80 + 0 + 100),  # clipped to the requests
    ("copy_in_ms.recording", 50 + 30),
    ("embed_issue_ms.recording", 150),
    ("device_wait_ms.recording", 100 + 10),
    ("eig_ms.recording", 50 + 200 - 40),  # the start subtracted from the eigensolve
    ("kmeans_ms.recording", 50),
    ("merge_count_ms.recording", 30)])
def test_span_self_time_over_steps(tr, name, us):
    assert read(name, tr, WORK) == pytest.approx(us / 1e3 / 2)


def test_self_times_add_up_to_the_spans_union(tr):
    window = tr.window()
    got = sum(us for _, us in spans.self_us(spans.program_spans(tr), window))
    union = trace.merged([(s, e) for s, e, _ in spans.program_spans(tr)])
    assert got == pytest.approx(spans.overlap(union, window))


def test_cluster_idle_is_the_idle_gaps_under_the_cluster_spans(tr):
    # the cluster spans cover [620, 990): of the gaps, 180 + 140 µs over 2 steps
    assert tr.idle_gaps() == [(0.0, 120.0), (150.0, 170.0), (500.0, 800.0), (850.0, 1000.0),
                              (2000.0, 3000.0)]
    assert read("cluster_idle_ms.batch", tr, WORK) == pytest.approx(0.16)


def test_leaves_hold_no_other_span(tr):
    names = [n for _, _, n in spans.leaves(spans.program_spans(tr))]
    assert "cluster.eig" not in names and "cluster.start" in names and len(names) == 12


def test_counter_ratios(tr, monkeypatch):
    # a 600 s recording: 1 598 windows in 13 chunks of 128
    rec = {"embed.rows": 2 * 1664, "embed.pad_rows": 2 * 66,
           "embed.h2d_bytes": 2 * 13 * 128 * (16000 * 4 + 8)}
    monkeypatch.setattr(profiling, "counters", lambda: dict(rec))
    assert read("pad_row_share.recording", tr, WORK) == pytest.approx(3.966, abs=1e-3)
    assert read("h2d_mb.recording", tr, WORK) == pytest.approx(106.5, abs=0.05)
    monkeypatch.setattr(profiling, "counters", lambda: {"embed.rows": 3})
    assert read("h2d_mb.recording", tr, WORK) is None  # nothing counted: not on a card
    monkeypatch.delattr(profiling, "counters")
    assert read("pad_row_share.recording", tr, WORK) is None  # a program without counters


def test_program_spans_move_no_existing_reader():
    """The benchmark's own spans, device attribution and readers read the
    same with the program's annotations in the trace."""
    extra = [sdtk("embed.issue", 15, 80), sdtk("cluster.eig", 505, 90),
             sdtk("cluster.start", 506, 10)]
    plain, annotated = trace.parse(CANNED), trace.parse(CANNED + extra)
    assert annotated.spans == plain.spans
    assert [o.span for o in annotated.ops] == [o.span for o in plain.ops]
    work = {"config": {"frontend": {}, "model": {}}, "cluster_s": [0.01]}
    for name in ("cluster_ms.batch", "cluster_ms.recording", "idle_share.batch"):
        assert read(name, annotated, work) == read(name, plain, work)
    for name in NEW:
        assert read(name, plain, {"steps": 1}) is None


@pytest.mark.parametrize("name", NEW)
def test_none_on_the_empty_trace(name):
    assert read(name, trace.parse([]), {}) is None
    assert read(name, trace.parse([]), WORK) is None


def traced(small, workload, **over):
    make, root = small
    profiling.reset()
    return run.run_cell(make(workload, **over), 20261, 0.05, True, torch.device("cpu"),
                        t_start=time.perf_counter(), root=root)["metrics"]


def test_a_small_traced_recording_reads_the_embed_spans_and_counters(small):
    """30 s of windows (78 in one 128-window chunk) embed on the CPU; the
    clustering takes the host path below 1 024 windows, so its spans and
    the card's copies are absent."""
    got = traced(small, "ecapa-c512.recording-10min")
    for name in ("windows_ms.recording", "copy_in_ms.recording", "embed_issue_ms.recording",
                 "device_wait_ms.recording"):
        assert got[name]["value"] > 0, name
    assert got["pad_row_share.recording"]["value"] == pytest.approx(100 * 50 / 128)
    assert not {"eig_ms.recording", "kmeans_ms.recording", "merge_count_ms.recording",
                "h2d_mb.recording"} & set(got)


def test_a_small_traced_batch_reads_the_cluster_idle(small):
    """No device operations on the CPU: the whole of the cluster spans is
    idle."""
    got = traced(small, "ecapa-c512.batch-3s")
    assert got["cluster_idle_ms.batch"]["value"] > 0


def test_the_profiler_alone_counts(small):
    """Counters count in the traced slice only: none in an untraced run."""
    make, root = small
    profiling.reset()
    run.run_cell(make("ecapa-c512.recording-10min"), 20262, 0.05, False, torch.device("cpu"),
                 t_start=time.perf_counter(), root=root)
    assert profiling.counters() == {}


def test_split_of_the_canned_requests(tr):
    got = spans.split(tr, 2)
    assert got["window_ms"] == pytest.approx(1.0) and got["busy_ms"] == pytest.approx(0.205)
    assert got["idle_ms"] == pytest.approx(0.795)
    assert got["calls"]["diarize.windows"] == 1.5 and got["calls"]["cluster.eig"] == 0.5
    assert got["self_ms"]["cluster.eig"] == pytest.approx(0.08)
    # the idle under each leaf: the window cutting's 80 + 100 µs, the copy
    # in's and the issue's 20 each, the clustering's 30 + 50 + 40 + 50 + 10 + 30
    assert got["idle_under_leaf_ms"] == pytest.approx(
        {"diarize.windows": 0.09, "embed.copy_in": 0.01, "embed.issue": 0.01,
         "diarize.copy_out": 0.0, "cluster.copy_in": 0.015, "cluster.affinity": 0.025,
         "cluster.start": 0.02, "cluster.kmeans": 0.025, "cluster.copy_out": 0.005,
         "cluster.merge_count": 0.015})
    assert got["idle_under_leaf_share"] == pytest.approx(430 / 1590)
    assert got["embed_self_share"] == pytest.approx(480 / 590)
    assert got["cluster_self_share"] == pytest.approx(370 / 380)


def test_split_exits_2_without_a_card():
    import split

    assert split.main(["--workload", "ecapa-c512.batch-3s", "--seed", "1"]) == 2
