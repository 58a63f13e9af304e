"""The port's spans and counters (sdtk_tpu_torch/utils/profiling.py) and
their call sites in the embed and clustering paths, on the CPU:

1. Under a ``torch.profiler``, ``stage`` emits nested ``sdtk.*``
   ``user_annotation`` ranges that the benchmark's trace reduction
   (``benchmark/benchlib/trace.py``) keeps among its host events, while its
   own spans and their device operations stay as they were.
2. With the profiler and ``SDTK_PROFILE`` off, ``stage`` enters no
   ``record_function``, reads the environment once and records nothing;
   ``count`` counts only while either is on; ``reset`` clears both.
3. ``SDTK_PROFILE=1`` ends a stage in ``torch.cuda.synchronize()`` only
   where CUDA is initialised; the profiler alone never synchronizes.
4. ``Diarizer._embed_windows`` on a narrow CPU ECAPA engine records its
   four spans once a chunk and counts rows and pad rows by the chunk
   arithmetic (no host-to-device bytes on the CPU); ``spectral_cluster``'s
   device path and ``cluster_stage`` record each ``cluster.*`` span as
   often as its call site runs.
5. ``span_self_ms`` subtracts the ``sdtk.*`` spans a span holds.
"""

from __future__ import annotations

import io
import json
import os
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sdtk_tpu_torch.backends.gpu import EmbedEngine
from sdtk_tpu_torch.cluster import spectral
from sdtk_tpu_torch.pipeline.diarize import DiarizeConfig, Diarizer
from sdtk_tpu_torch.utils import profiling

BENCH = Path(__file__).resolve().parent.parent / "benchmark"


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    monkeypatch.delenv("SDTK_PROFILE", raising=False)
    profiling.reset()
    yield
    profiling.reset()


def host_spans(prof) -> list[tuple[float, float, str]]:
    return [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if e.name.startswith(profiling.PREFIX)]


def calls(prof) -> dict[str, int]:
    return {k: n for k, (n, _) in profiling.span_self_ms(host_spans(prof)).items()}


def test_spans_nest_in_the_benchmark_trace(tmp_path):
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from benchlib import trace

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench.embed"):
            with profiling.stage("outer"):
                with profiling.stage("inner"):
                    (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    tr = trace.load(path)
    ours = {n: (s, e) for s, e, n in tr.host if n.startswith("sdtk.")}
    assert set(ours) == {"sdtk.outer", "sdtk.inner"}
    (bs, be), = tr.spans["embed"]
    (os_, oe), (is_, ie) = ours["sdtk.outer"], ours["sdtk.inner"]
    assert bs <= os_ <= is_ <= ie <= oe <= be
    assert set(tr.spans) == {"embed"}  # device operations go to benchmark spans only
    cats = {e["name"]: e["cat"] for e in json.loads(path.read_text())["traceEvents"]
            if e.get("name", "").startswith("sdtk.")}
    assert cats == {"sdtk.outer": "user_annotation", "sdtk.inner": "user_annotation"}


def test_off_enters_nothing_and_counts_nothing(monkeypatch):
    class Environ(dict):
        reads = 0

        def get(self, *a):
            Environ.reads += 1
            return super().get(*a)

    def refuse(*a, **k):
        raise AssertionError("record_function entered while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "os", SimpleNamespace(environ=Environ()))
    with profiling.stage("x"):
        pass
    assert Environ.reads == 1
    profiling.count("embed.rows", 5)
    assert profiling.counters() == {} and not profiling._times
    buf = io.StringIO()
    profiling.report(out=buf)
    assert buf.getvalue() == ""


@pytest.mark.parametrize("how", ["profiler", "environment"])
def test_counters_count_only_while_on(how, monkeypatch):
    profiling.count("a", 3)
    if how == "profiler":
        with profile(activities=[ProfilerActivity.CPU]):
            profiling.count("a", 2)
            profiling.count("b")
    else:
        monkeypatch.setenv("SDTK_PROFILE", "1")
        profiling.count("a", 2)
        profiling.count("b")
        monkeypatch.delenv("SDTK_PROFILE")
    profiling.count("a", 7)
    assert profiling.counters() == {"a": 2, "b": 1}
    buf = io.StringIO()
    profiling.report(out=buf)
    assert buf.getvalue().splitlines()[-3:] == ["── sdtk counters ──", "  a  2", "  b  1"]
    profiling.reset()
    assert profiling.counters() == {} and not profiling._times


def test_threads_lose_no_count_or_time(monkeypatch):
    """More threads than cores count and time at once, switching every
    microsecond: no update is lost."""
    monkeypatch.setenv("SDTK_PROFILE", "1")
    n_threads, n = 2 * (os.cpu_count() or 4), 100

    def work():
        for i in range(n):
            profiling.count("rows", 2)
            with profiling.stage(f"s{i % 3}"):
                pass

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(before)
    assert not any(t.is_alive() for t in threads)
    assert profiling.counters() == {"rows": 2 * n * n_threads}
    assert sum(len(v) for v in profiling._times.values()) == n * n_threads


@pytest.mark.parametrize("initialised", [False, True])
def test_synchronize_only_with_sdtk_profile_where_cuda_is_initialised(initialised,
                                                                       monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: initialised)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: synced.append(1))
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.stage("traced"):
            pass
    assert synced == []
    monkeypatch.setenv("SDTK_PROFILE", "1")
    with profiling.stage("timed"):
        with profiling.stage("inner"):
            pass
    assert len(synced) == (2 if initialised else 0)
    assert {k: len(v) for k, v in profiling._times.items()} == {"timed": 1, "inner": 1}


@pytest.fixture(scope="module")
def narrow_engine(tmp_path_factory):
    """A random ECAPA at 32 channels on the CPU (no checkpoint at the path)."""
    missing = tmp_path_factory.mktemp("none") / "none.msgpack"
    return EmbedEngine("ecapa", 32, 16, missing, 0, torch.device("cpu"))


@pytest.mark.parametrize("how", ["profiler", "environment"])
def test_embed_windows_spans_and_counters(how, narrow_engine, monkeypatch):
    """19 windows of 1 s at 0.5 s hop in chunks of 8: 3 chunks, 24 rows, 5
    of them padding."""
    d = Diarizer("fake", DiarizeConfig(window_seconds=1.0, hop_seconds=0.5, embed_chunk=8),
                 device="cpu")
    d.backend = SimpleNamespace(engine=narrow_engine)
    wav = np.random.default_rng(0).standard_normal(160000).astype(np.float32) * 0.1
    starts = np.arange(19) * 0.5
    if how == "profiler":
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            emb = d._embed_windows(wav, starts)
        got = calls(prof)
    else:
        monkeypatch.setenv("SDTK_PROFILE", "1")
        emb = d._embed_windows(wav, starts)
        got = {k: len(v) for k, v in profiling._times.items()}
    assert emb.shape == (19, narrow_engine.emb_dim)
    assert got == {"diarize.windows": 3, "embed.copy_in": 3, "embed.issue": 3,
                   "diarize.copy_out": 3}
    assert profiling.counters() == {"embed.rows": 24, "embed.pad_rows": 5}


def test_embed_all_windows_counts_pad_rows(narrow_engine, monkeypatch):
    """A 10 s recording in 3 s windows at 1.5 s hop: 6 windows in one call
    of 16 rows."""
    monkeypatch.setenv("SDTK_PROFILE", "1")
    narrow_engine.embed_all_windows(np.zeros(160000, np.float32))
    assert profiling.counters() == {"embed.rows": 16, "embed.pad_rows": 10}


def three_voices(n: int = 96, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((3, 32))
    return (centres[np.arange(n) % 3] + 0.2 * rng.standard_normal((n, 32))).astype(np.float32)


@pytest.mark.parametrize("subspace", [False, True])
def test_spectral_cluster_spans(subspace):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        labels, k = spectral.spectral_cluster(three_voices(), max_speakers=6,
                                              use_subspace=subspace, force_device=True,
                                              device="cpu")
    assert k == 3 and len(np.unique(labels)) == 3
    want = {"cluster.copy_in": 1, "cluster.affinity": 1, "cluster.eig": 1,
            "cluster.kmeans": 2, "cluster.copy_out": 2, "cluster.merge_count": 1}
    assert calls(prof) == want | ({"cluster.start": 1} if subspace else {})


def test_spectral_cluster_spans_with_the_count_given():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spectral.spectral_cluster(three_voices(), n_speakers=3, force_device=True,
                                  device="cpu")
    assert calls(prof) == {"cluster.copy_in": 1, "cluster.affinity": 1, "cluster.eig": 1,
                           "cluster.kmeans": 1, "cluster.copy_out": 1}


@pytest.mark.parametrize("subspace", [False, True])
def test_cluster_stage_spans(subspace):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spectral.cluster_stage(torch.from_numpy(three_voices()), 3, use_subspace=subspace)
    want = {"cluster.affinity": 1, "cluster.eig": 1, "cluster.kmeans": 1}
    assert calls(prof) == want | ({"cluster.start": 1} if subspace else {})


def test_the_numpy_path_opens_no_span():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spectral.spectral_cluster(three_voices(), max_speakers=6)
    assert calls(prof) == {}


def test_span_self_ms_subtracts_children():
    events = [(0.0, 1000.0, "sdtk.a"), (100.0, 300.0, "sdtk.b"), (400.0, 500.0, "sdtk.b"),
              (150.0, 200.0, "sdtk.c"), (120.0, 130.0, "aten::mm"), (2000.0, 2500.0, "sdtk.a")]
    got = profiling.span_self_ms(events)
    assert got == {"a": (2, pytest.approx(1.2)), "b": (2, pytest.approx(0.25)),
                   "c": (1, pytest.approx(0.05))}
    assert sum(ms for _, ms in got.values()) == pytest.approx(1.5)
