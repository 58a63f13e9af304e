"""The port's identify, streaming, mapper and warm-up evals
(sdtk_tpu_torch/evals/{identify,streaming,mapper,warmup}.py) against the
JAX package's scripts (evals/benchmark_identify.py,
benchmark_streaming.py, benchmark_mapper.py):

1. With the ``fake`` backend (NumPy, the same vectors in both packages)
   each module prints the JAX script's JSON, wall-time fields aside
   (exact): identify at two sizes, streaming in its latency mode and in
   ``--der`` mode (train family and ``--heldout`` tiers).
2. The mapper's ``pattern`` provider over every test of
   ``evals/mapper/tests``, in both output formats.
3. The warm-up on the CPU: the host library built, one JSON line a shape.
"""

from __future__ import annotations

import json
import os
import runpy
import sys
from pathlib import Path

import pytest

from sdtk_tpu.backends import base as jbase
from sdtk_tpu_torch.backends import base
from sdtk_tpu_torch.evals import identify, mapper, streaming, warmup
from sdtk_tpu_torch.utils import build

REPO = Path(__file__).resolve().parent.parent
EVALS = REPO / "evals"


def _jax_script(name: str, argv: list[str], monkeypatch, capsys) -> tuple[int, str]:
    """Run ``evals/<name>`` as ``python evals/<name> argv`` does, in this
    process (``evals/`` first on the path, as for a script); its exit code
    and standard output."""
    monkeypatch.setattr(sys, "argv", [str(EVALS / name), *argv])
    monkeypatch.syspath_prepend(str(EVALS))
    with pytest.raises(SystemExit) as done:
        runpy.run_path(str(EVALS / name), run_name="__main__")
    return done.value.code, capsys.readouterr().out


def _port(module, argv: list[str], capsys) -> tuple[int, str]:
    rc = module.main(argv)
    return rc, capsys.readouterr().out


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(autouse=True)
def isolated(monkeypatch, tmp_path):
    """Fresh backends in both registries; the store and the LLM cache in
    this test's directory (the identify scripts set the store's variables
    themselves, and monkeypatch restores them after)."""
    monkeypatch.setattr(base, "_instances", {})
    monkeypatch.setattr(jbase, "_instance_cache", {})
    monkeypatch.setenv("SPEAKERS_EMBEDDINGS_DIR", str(tmp_path / "db"))
    monkeypatch.setenv("SPEAKER_DETECTION_BACKEND", "fake")
    monkeypatch.setenv("SPEAKER_LLM_CACHE_DIR", str(tmp_path / "llm"))


@pytest.mark.parametrize("argv", [
    ["--speakers", "3", "--utterances", "2", "--seconds", "2.0"],
    ["--speakers", "4", "--utterances", "1", "--seconds", "3.0", "--threshold", "0.5"],
])
def test_identify_fake_prints_the_jax_json(argv, tmp_path, monkeypatch, capsys):
    """The JSON line equals the JAX script's but for its two wall times;
    the exit code too; ``--cases`` lists every case with its expected and
    identified speakers, and the pass rates follow from it."""
    jax_rc, jax_out = _jax_script("benchmark_identify.py", ["--backend", "fake", *argv],
                                  monkeypatch, capsys)
    cases_file = tmp_path / "cases.json"
    rc, out = _port(identify, ["--backend", "fake", "--device", "cpu", *argv,
                               "--cases", str(cases_file)], capsys)
    got, want = _last_json(out), _last_json(jax_out)
    for key in ("enroll_seconds", "identify_seconds"):
        assert got.pop(key) >= 0
        want.pop(key)
    assert got == want and rc == jax_rc == 0
    cases = json.loads(cases_file.read_text())
    single = [c for c in cases if c["case"].startswith("test_")]
    conv = [c for c in cases if c["case"].startswith("conv_")]
    assert len(single) == got["single_cases"] and len(conv) == got["conversation_cases"]
    assert sum(c["identified"][:1] == c["expected"] for c in single) / len(single) == \
        got["single_pass_rate"]
    assert sum(set(c["expected"]) <= set(c["identified"]) for c in conv) / len(conv) == \
        pytest.approx(got["conversation_pass_rate"], abs=5e-4)


def test_identify_leaves_the_environment_as_it_was(monkeypatch, capsys):
    monkeypatch.delenv("SPEAKERS_EMBEDDINGS_DIR")
    assert identify.main(["--device", "cpu", "--speakers", "2", "--utterances", "1",
                          "--seconds", "1.0"]) == 0
    capsys.readouterr()
    assert "SPEAKERS_EMBEDDINGS_DIR" not in os.environ
    assert os.environ["SPEAKER_DETECTION_BACKEND"] == "fake"


@pytest.mark.parametrize("argv", [["--seconds", "12"],
                                  ["--seconds", "16", "--chunk-seconds", "0.25"]])
def test_streaming_latency_fake_prints_the_jax_json(argv, monkeypatch, capsys):
    """Latency mode: the same line but for the real-time factor and the
    chunk latencies (wall time)."""
    jax_rc, jax_out = _jax_script("benchmark_streaming.py", ["--backend", "fake", *argv],
                                  monkeypatch, capsys)
    rc, out = _port(streaming, ["--backend", "fake", "--device", "cpu", *argv], capsys)
    got, want = _last_json(out), _last_json(jax_out)
    assert got.pop("rtf") > 0 and set(got.pop("chunk_latency_ms")) == {"p50", "p95", "max"}
    want.pop("rtf"), want.pop("chunk_latency_ms")
    assert got == want and rc == jax_rc == 0


@pytest.mark.parametrize("argv", [
    ["--meetings", "1"],
    ["--meetings", "2", "--heldout"],
    ["--meetings", "1", "--heldout", "--tier", "noise", "--speakers", "2", "--window", "1.5",
     "--hop", "0.75", "--chunk-seconds", "0.25"],
])
def test_streaming_der_fake_prints_the_jax_json(argv, monkeypatch, capsys):
    """``--der``: live, finalized and offline DER at both collars, and the
    two differences, equal the JAX script's (no wall-time field)."""
    jax_rc, jax_out = _jax_script("benchmark_streaming.py", ["--backend", "fake", "--der", *argv],
                                  monkeypatch, capsys)
    rc, out = _port(streaming, ["--backend", "fake", "--device", "cpu", "--der", *argv], capsys)
    assert _last_json(out) == _last_json(jax_out) and rc == jax_rc == 0


def test_streaming_conversation_equals_jax():
    jax_conv = runpy.run_path(str(EVALS / "benchmark_streaming.py"))["conversation"]
    assert (streaming.conversation(9.0) == jax_conv(9.0)).all()


def _without_elapsed(summary: dict) -> dict:
    for r in summary["results"]:
        assert r.pop("elapsed_s") >= 0
    return summary


def test_mapper_pattern_json_equals_jax(monkeypatch, capsys):
    """``--format json`` over every test of ``evals/mapper/tests``: the
    summary equals the JAX script's but for each test's seconds, and every
    test is graded."""
    jax_rc, jax_out = _jax_script("benchmark_mapper.py", ["--format", "json"], monkeypatch, capsys)
    rc, out = _port(mapper, ["--format", "json"], capsys)
    got, want = _without_elapsed(json.loads(out)), _without_elapsed(json.loads(jax_out))
    assert got == want and rc == jax_rc
    assert got["total"] == len(list((EVALS / "mapper" / "tests").glob("*.json"))) > 0
    assert got["provider"] == "pattern"


@pytest.mark.parametrize("argv", [[], ["--only", "00"], ["--only", "003"]])
def test_mapper_text_equals_jax(argv, monkeypatch, capsys):
    """The text report line by line, each test's seconds aside."""
    jax_rc, jax_out = _jax_script("benchmark_mapper.py", argv, monkeypatch, capsys)
    rc, out = _port(mapper, argv, capsys)

    def strip(text: str) -> list[str]:
        return [" ".join(w for w in ln.split() if not (w.endswith("s") and w[:-1]
                                                       .replace(".", "").isdigit()))
                for ln in text.splitlines()]

    assert strip(out) == strip(jax_out) and rc == jax_rc


def test_mapper_score_mapping_equals_jax():
    jax_score = runpy.run_path(str(EVALS / "benchmark_mapper.py"))["score_mapping"]
    expected = {"preferred": "Dana Reyes", "acceptable": ["Dana Reyes", "Dana"],
                "_partial_weight": 0.4}
    for actual in ("Dana Reyes", "Dana", "Reyes", "dana reyes smith", "Omar", None, ""):
        assert mapper.score_mapping(actual, expected) == jax_score(actual, expected)


def test_warmup_on_the_cpu_builds_the_host_library(capsys):
    """``--device cpu``: no kernel build (the CPU runs the plain
    versions), the host library built, then one line a shape."""
    assert warmup.main(["--device", "cpu", "--shapes", "1x24000,2x16000"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["stage"] == "build" and lines[0]["kernels"] == []
    assert lines[0]["host_library"] == build.host_library_path().name
    assert build.host_library_path().exists()
    assert [ln["shape"] for ln in lines[2:]] == ["1x24000", "2x16000"]
    assert all(ln["first_call_s"] >= 0 and ln["device"] == "cpu" for ln in lines[2:])
