"""The port's stage profiler and device trace (sdtk_tpu_torch/utils/
profiling.py) against the JAX package's (sdtk_tpu/utils/profiling.py):

1. ``stage`` accumulates under ``SDTK_PROFILE=1`` and the report lists it
   (tests/test_aux.py's two profiling tests, on the port); off, it records
   nothing; the report's text equals JAX's for the same timings.
2. One CPU diarize of a short meeting through both packages with
   ``SDTK_PROFILE=1`` (``fake`` backend, the trained gate): the same
   stage names, each as many times; the port's long-form records JAX's
   two long-form names.
3. ``trace()`` with no directory does nothing; with one, on the CPU, it
   writes a Chrome trace.
"""

from __future__ import annotations

import io
import json

import pytest

from sdtk_tpu.backends import base as jbase
from sdtk_tpu.pipeline.diarize import DiarizeConfig as JaxDiarizeConfig
from sdtk_tpu.pipeline.diarize import Diarizer as JaxDiarizer
from sdtk_tpu.utils import profiling as jprofiling
from sdtk_tpu_torch.backends import base
from sdtk_tpu_torch.data.synth import build_meeting
from sdtk_tpu_torch.pipeline.diarize import DiarizeConfig, Diarizer
from sdtk_tpu_torch.utils import profiling

DIARIZE_STAGES = {"diarize.vad", "diarize.denoise", "diarize.embed", "diarize.cluster",
                  "diarize.resegment"}


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    """Both profilers empty before and after; fresh backends."""
    monkeypatch.setattr(base, "_instances", {})
    monkeypatch.setattr(jbase, "_instance_cache", {})
    profiling.reset()
    jprofiling.reset()
    yield
    profiling.reset()
    jprofiling.reset()


def test_profiling_stage(monkeypatch):
    monkeypatch.setenv("SDTK_PROFILE", "1")
    with profiling.stage("demo"):
        pass
    with profiling.stage("demo"):
        pass
    buf = io.StringIO()
    profiling.report(out=buf)
    assert "demo" in buf.getvalue() and "2x" in buf.getvalue()
    assert profiling.enabled()


def test_profiling_disabled(monkeypatch):
    monkeypatch.delenv("SDTK_PROFILE", raising=False)
    with profiling.stage("x"):
        pass
    buf = io.StringIO()
    profiling.report(out=buf)
    assert buf.getvalue() == "" and not profiling.enabled()


def test_report_text_equals_jax(monkeypatch):
    """The same timings print the same report, line for line."""
    times = {"diarize.embed": [0.5, 0.25], "diarize.vad": [0.125], "x": [2.0, 0.0, 1.5]}
    for mod in (profiling, jprofiling):
        for k, v in times.items():
            mod._times[k] = list(v)
    got, want = io.StringIO(), io.StringIO()
    profiling.report(out=got)
    jprofiling.report(out=want)
    assert got.getvalue() == want.getvalue() and got.getvalue().count("\n") == 4


def test_diarize_stages_equal_jax(monkeypatch):
    """With ``SDTK_PROFILE=1`` one diarize through each package records
    the five ``diarize.*`` stages, the same names as often; the port adds
    its finer spans (``fake`` embeds on the host: only the window cutting,
    once a 128-window chunk), and its ``timings`` keep their names."""
    monkeypatch.setenv("SDTK_PROFILE", "1")
    wav, _ = build_meeting(0, 3, 6, 2.0)
    got = Diarizer("fake", DiarizeConfig(vad="trained"), device="cpu").diarize_waveform(wav)
    JaxDiarizer("fake", JaxDiarizeConfig(vad="trained")).diarize_waveform(wav)
    counts = {k: len(v) for k, v in profiling._times.items()}
    jax_counts = {k: len(v) for k, v in jprofiling._times.items()}
    assert {k: counts[k] for k in jax_counts} == jax_counts
    assert set(jax_counts) == DIARIZE_STAGES and set(jax_counts.values()) == {1}
    assert {k: v for k, v in counts.items() if k not in jax_counts} == {"diarize.windows": 1}
    assert profiling.counters() == {}
    assert set(got["timings"]) == {"vad", "denoise", "embed", "cluster", "resegment", "segments"}


def test_longform_stages(monkeypatch):
    """The port's long-form records JAX's two names, once a call."""
    from sdtk_tpu_torch.pipeline.longform import LongformConfig, LongformDiarizer

    monkeypatch.setenv("SDTK_PROFILE", "1")
    wav, _ = build_meeting(1, 2, 4, 2.0)
    d = LongformDiarizer(LongformConfig(window_seconds=1.0, hop_seconds=0.5, n_speakers=2),
                         channels=32, device="cpu")
    d.diarize_waveform(wav)
    d.diarize_waveform(wav)
    assert {k: len(v) for k, v in profiling._times.items()} == {
        "longform.embed_program": 2, "longform.cluster_program": 2}


def test_stage_off_records_nothing_in_diarize(monkeypatch):
    monkeypatch.delenv("SDTK_PROFILE", raising=False)
    wav, _ = build_meeting(0, 2, 3, 2.0)
    Diarizer("fake", DiarizeConfig(vad="energy"), device="cpu").diarize_waveform(wav)
    assert not profiling._times


def test_trace_without_a_directory_does_nothing(monkeypatch, tmp_path):
    import torch

    monkeypatch.delenv("SDTK_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.trace():
        assert not torch.autograd.profiler._is_profiler_enabled
        torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_trace_writes_a_chrome_trace_on_the_cpu(how, monkeypatch, tmp_path):
    import torch

    out = tmp_path / "trace"
    if how == "environment":
        monkeypatch.setenv("SDTK_TRACE_DIR", str(out))
        ctx = profiling.trace()
    else:
        monkeypatch.delenv("SDTK_TRACE_DIR", raising=False)
        ctx = profiling.trace(str(out))
    with ctx:
        assert torch.autograd.profiler._is_profiler_enabled
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = list(out.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)
