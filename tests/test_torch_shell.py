"""The port's host shell (``cli/catalog.py``, ``cli/samples.py``,
``cli/segments.py``, ``cli/report.py``, ``cli/review.py``, ``cli/llm.py``
and the modules under them) against the JAX package's, on two temporary
stores: the flows of tests/test_cli.py (catalog, samples and their review,
the report half of assign-and-report, llm) and the interactive review,
each command run through both packages in turn.  The port's commands go
through its umbrella dispatcher (``python -m sdtk_tpu_torch <tool>``), the
JAX package's through each tool's ``main``.

Every command must give the same return code, standard output and
standard error, and the stores the same files, with time fields aside:
each ISO-8601 timestamp is replaced by ``<time>`` and each package's own
temporary root by ``<root>`` before comparing.  Embedding ids are drawn
from one counter in each store.  Binary files (embeddings, MP3 samples)
compare byte for byte.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

from sdtk_tpu.cli import assign as jassign
from sdtk_tpu.cli import catalog as jcatalog
from sdtk_tpu.cli import detection as jdetection
from sdtk_tpu.cli import llm as jllm
from sdtk_tpu.cli import report as jreport
from sdtk_tpu.cli import review as jreview
from sdtk_tpu.cli import samples as jsamples
from sdtk_tpu.cli import segments as jsegments
from sdtk_tpu.store import profiles as jprofiles
from sdtk_tpu_torch import __main__ as pmain
from sdtk_tpu_torch.store import profiles as pprofiles
from sdtk_tpu_torch.utils.audio import load_audio, save_wav

JAX_TOOLS = {"catalog": jcatalog, "samples": jsamples, "segments": jsegments, "report": jreport,
             "review": jreview, "llm": jllm, "detection": jdetection, "assign": jassign}
# port subcommands that take --device (the JAX package has no such flag)
DEVICE_COMMANDS = {("detection", "enroll"), ("detection", "identify"), ("assign", "assign"),
                   ("detection", "check-validity"), ("detection", "backends")}
_TIME = re.compile(r"\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}(\.\d+)?(Z|[+-]\d{2}:\d{2})?")


class Shell:
    """Runs one command line through either package against its own
    store, session and LLM cache directories, and compares the stores."""

    def __init__(self, tmp_path: Path, monkeypatch):
        self.tmp, self.mp = tmp_path, monkeypatch
        monkeypatch.setenv("SPEAKER_DETECTION_BACKEND", "fake")
        for var in ("ANTHROPIC_API_KEY", "OPENAI_API_KEY", "SPEAKER_REVIEW_PLAYER"):
            monkeypatch.delenv(var, raising=False)
        monkeypatch.setenv("OLLAMA_HOST", "http://127.0.0.1:1")
        for mod in (jprofiles, pprofiles):
            ids = itertools.count()
            monkeypatch.setattr(mod, "new_embedding_id", lambda ids=ids: f"emb-{next(ids):08d}")

    def root(self, pkg: str) -> Path:
        return self.tmp / pkg

    def norm(self, text: str, pkg: str) -> str:
        return _TIME.sub("<time>", text.replace(str(self.root(pkg)), "<root>"))

    def run(self, pkg: str, tool: str, *argv: str, stdin: str | None = None):
        root = self.root(pkg)
        self.mp.setenv("SPEAKERS_EMBEDDINGS_DIR", str(root / "store"))
        self.mp.setenv("SPEAKER_LLM_CACHE_DIR", str(root / "llm"))
        self.mp.setenv("SPEAKER_REVIEW_SESSION_DIR", str(root / "review"))
        args = list(argv)
        if pkg == "port" and (tool, args[0]) in DEVICE_COMMANDS:
            args += ["--device", "cpu"]
        out, err = io.StringIO(), io.StringIO()
        self.mp.setattr(sys, "stdin", io.StringIO(stdin or ""))
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = (pmain.main([tool, *args]) if pkg == "port"
                  else JAX_TOOLS[tool].main(args))
        return rc, self.norm(out.getvalue(), pkg), self.norm(err.getvalue(), pkg)

    def both(self, tool: str, *argv: str, stdin: str | None = None, rc: int | None = 0):
        """The command in both packages: equal results, returned."""
        want = self.run("jax", tool, *argv, stdin=stdin)
        got = self.run("port", tool, *argv, stdin=stdin)
        assert got == want, f"{tool} {' '.join(argv)}"
        if rc is not None:
            assert want[0] == rc, f"{tool} {' '.join(argv)}: rc {want[0]}: {want[2]}"
        return want

    def files(self, pkg: str) -> dict[str, object]:
        """Every file under the package's root: text normalized, binary
        as bytes."""
        out = {}
        for p in sorted(self.root(pkg).rglob("*")):
            if not p.is_file():
                continue
            data = p.read_bytes()
            key = str(p.relative_to(self.root(pkg)))
            try:
                out[key] = self.norm(data.decode(), pkg)
            except UnicodeDecodeError:
                out[key] = data
        return out

    def same_files(self) -> dict[str, object]:
        want, got = self.files("jax"), self.files("port")
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key] == want[key], key
        return want


@pytest.fixture()
def shell(tmp_path, monkeypatch):
    return Shell(tmp_path, monkeypatch)


def voice_wav(path: Path, freq: float, seconds: float = 4.0, seed: int = 0) -> Path:
    """tests/test_cli.py's harmonic voice."""
    sr = 16000
    t = np.arange(int(seconds * sr)) / sr
    x = sum((0.5 / (k + 1)) * np.sin(2 * np.pi * freq * (k + 1) * t) for k in range(4))
    x += 0.01 * np.random.default_rng(seed).standard_normal(len(t))
    path.parent.mkdir(parents=True, exist_ok=True)
    save_wav(path, (0.5 * x / np.max(np.abs(x))).astype(np.float32), sr)
    return path


def _transcript(path: Path, utterances) -> Path:
    path.write_text(json.dumps({"utterances": [
        {"speaker": s, "start": a, "end": b, "text": t} for s, a, b, t in utterances]}))
    return path


def test_catalog_flow(shell, tmp_path):
    """tests/test_cli.py:test_catalog_flow and every listing, show, context
    and query form on the way."""
    wav = voice_wav(tmp_path / "audio" / "rec.wav", 330, seed=5)
    tr = _transcript(tmp_path / "t.json", [("S1", 0, 2000, "hi")])
    shell.both("catalog", "create-context", "standup", "--speakers", "alice,bob",
               "--description", "daily sync")
    shell.both("catalog", "create-context", "standup", rc=1)
    shell.both("catalog", "add", str(wav), "--context", "standup", "--tags", "q1,eng")
    shell.both("catalog", "add", str(wav), rc=1)
    b3 = shell.both("catalog", "list", "--format", "ids")[1].strip()
    assert len(b3) == 32
    for fmt in ("table", "json", "paths"):
        shell.both("catalog", "list", "--format", fmt)
    assert shell.both("catalog", "status", b3[:8])[1].strip() == "unprocessed"
    shell.both("catalog", "register-transcript", b3, str(tr), "--backend", "assemblyai")
    assert shell.both("catalog", "status", b3)[1].strip() == "transcribed"
    shell.both("catalog", "status", b3, "--format", "json")
    entry = json.loads(shell.both("catalog", "show", b3[:8], "--format", "json")[1])
    assert entry["context"]["expected_speakers"] == ["alice", "bob"]
    for fmt in ("text", "yaml"):
        shell.both("catalog", "show", b3[:8], "--format", fmt)
    shell.both("catalog", "list", "--status", "transcribed", "--format", "json")
    shell.both("catalog", "list", "--context", "standup")
    assert "standup" in shell.both("catalog", "list-contexts")[1]
    shell.both("catalog", "list-contexts", "--format", "json")
    shell.both("catalog", "show-context", "standup")
    shell.both("catalog", "context-add-speaker", "standup", "carol")
    shell.both("catalog", "show-context", "standup", "--format", "json")
    shell.both("catalog", "create-context", "retro")
    shell.both("catalog", "set-context", b3, "retro", "--expected-speakers", "bob")
    found = shell.both("catalog", "query", '.[] | select(.recording.path | endswith("rec.wav"))'
                       ' | {b3: .recording.b3sum, status, ctx: .context.name}')[1]
    assert json.loads(found) == {"b3": b3, "status": "transcribed", "ctx": "retro"}
    shell.both("catalog", "query", ".[] | .a = 3", rc=1)
    shell.same_files()
    shell.both("catalog", "remove", b3, "--force")
    shell.both("catalog", "status", b3, rc=1)
    shell.same_files()


def test_samples_flow(shell, tmp_path):
    """tests/test_cli.py:test_samples_cli (extract, list, review, info,
    speakers, remove) and the segments tools on the same transcript: the
    MP3 samples byte for byte, their metadata alike."""
    wav = voice_wav(tmp_path / "audio" / "src.wav", 220, seconds=5, seed=6)
    tr = _transcript(tmp_path / "t.json", [("S1", 0, 1500, "one"), ("S2", 1600, 3400, "two"),
                                           ("S1", 3500, 4800, "three")])
    shell.both("samples", "extract", "alice", str(wav), "--transcript", str(tr), "-l", "S1",
               "--dry-run")
    out = shell.both("samples", "extract", "alice", str(wav), "--transcript", str(tr),
                     "--max-segments", "2", "-l", "S1", "-v")[1]
    assert "sample-001" in out and "sample-002" in out
    shell.both("samples", "extract", str(wav), "-s", "bob", "--transcript", str(tr), "-l", "S2",
               "--format", "wav")
    metas = json.loads(shell.both("samples", "list", "--format", "json")[1])
    assert [m["speaker_id"] for m in metas] == ["alice", "alice", "bob"]
    shell.both("samples", "list")
    assert "pending -> reviewed" in shell.both("samples", "review", "alice", "--sample-id",
                                               "sample-001", "--approve")[1]
    shell.both("samples", "review", "alice", "--sample-id", "sample-002", "--reject",
               "--notes", "cross-talk")
    meta = json.loads(shell.both("samples", "info", "alice", "sample-001", "--format", "json")[1])
    assert meta["review"]["status"] == "reviewed"
    shell.both("samples", "info", "alice", "sample-002")
    shell.both("samples", "list", "--status", "rejected", "--format", "json")
    assert "alice" in shell.both("samples", "speakers")[1]
    shell.both("samples", "segments", str(tr), "-l", "S1")
    shell.both("samples", "segments", "-t", str(tr))
    files = shell.same_files()
    assert isinstance(files["store/samples/alice/sample-001.mp3"], bytes)
    assert load_audio(tmp_path / "port" / "store" / "samples" / "alice" / "sample-001.mp3")[0].size
    shell.both("samples", "remove", "alice", "sample-001")
    shell.same_files()
    assert shell.both("segments", str(tr))[1].split() == ["S1", "S2"]
    for argv in (["S1", "--format", "csv"], ["S1", "--format", "tuples", "--merge-gap", "1.0"],
                 ["S1"], ["--list-speakers"]):
        shell.both("segments", str(tr), *argv)
    shell.both("segments", str(tr), "Z", rc=1)


def _assigned_store(shell, tmp_path, llm: bool = True):
    """Two enrolled voices, a two-speaker recording in the catalog with a
    transcript, and its assignment, made in each store by its own
    package."""
    a = voice_wav(tmp_path / "audio" / "a.wav", 220, seed=1)
    b = voice_wav(tmp_path / "audio" / "b.wav", 520, seed=2)
    conv = tmp_path / "audio" / "conv.wav"
    save_wav(conv, np.concatenate([load_audio(a)[0], load_audio(b)[0]]), 16000)
    tr = _transcript(tmp_path / "conv.json", [
        ("S1", 0, 1500, "Hi, I'm Alice."), ("S1", 2700, 4000, "Welcome."),
        ("S2", 4000, 8000, "My name is Bob.")])
    shell.both("detection", "add", "alice", "--name", "Alice")
    shell.both("detection", "add", "bob", "--name", "Bob")
    shell.both("detection", "enroll", "alice", str(a))
    shell.both("detection", "enroll", "bob", str(b))
    shell.both("catalog", "create-context", "standup", "--speakers", "alice,bob")
    shell.both("catalog", "add", str(conv), "--context", "standup")
    shell.both("catalog", "register-transcript", str(conv), str(tr), "--backend", "assemblyai")
    out = json.loads(shell.both("assign", "assign", str(conv), "--transcript", str(tr),
                                *(["--use-llm"] if llm else []), "--threshold", "0.2",
                                "--format", "json")[1])
    assert out["mappings"]["S1"]["speaker_id"] == "alice"
    assert out["mappings"]["S2"]["speaker_id"] == "bob"
    return conv, tr


def test_report_flow(shell, tmp_path):
    """The report half of tests/test_cli.py:test_assign_and_report_cli, and
    every report in both formats."""
    _assigned_store(shell, tmp_path)
    assert "Recordings:     1 total" in shell.both("report", "status")[1]
    stats = json.loads(shell.both("report", "status", "--format", "json")[1])
    assert stats["speakers"]["total"] == 2
    shell.both("report", "--format", "json")  # status is the default subcommand
    for cmd in (["coverage"], ["coverage", "-c", "standup"], ["confidence"],
                ["confidence", "-b", "90"], ["stale"], ["stale", "-d", "0"], ["speakers"],
                ["contexts"], ["status", "--confidence-threshold", "95", "--stale-days", "1"]):
        for fmt in ("text", "json"):
            shell.both("report", *cmd, "--format", fmt)
    shell.same_files()


@pytest.mark.parametrize("mode", ["simple", "keys"])
def test_review_flow(shell, tmp_path, mode):
    """``review review <recording>`` with scripted input, ``--simple`` line
    prompts or keys read line by line: approve S1's first turn, reject its
    second, help, back and forth, approve S2's.  Then ``status`` and
    ``clear``.  The session file, the approved samples (MP3 bytes), their
    metadata, the profiles' trust and the catalog's review state are
    alike."""
    conv, _ = _assigned_store(shell, tmp_path, llm=False)
    flag = ["--simple"] if mode == "simple" else []
    shell.both("review", "status")
    shell.both("review", "review", str(conv), *flag, stdin="a\n?\nr\nN\nn\nq\n")
    shell.both("review", "status", "--format", "json")
    shell.same_files()
    shell.both("review", "review", "--continue", *flag, stdin="x\na\n")
    st = json.loads(shell.both("review", "status", "--format", "json")[1])
    assert st["decided"] == 3 and st["position"] == 3
    shell.both("review", "status")
    files = shell.same_files()
    samples = sorted(k for k in files if k.startswith("store/samples/"))
    assert samples == ["store/samples/alice/sample-001.meta.yaml",
                       "store/samples/alice/sample-001.mp3",
                       "store/samples/bob/sample-001.meta.yaml",
                       "store/samples/bob/sample-001.mp3"]
    assert "status: reviewed" in files["store/samples/bob/sample-001.meta.yaml"]
    shell.both("samples", "list", "--status", "reviewed", "--format", "json")
    shell.both("catalog", "show", str(conv), "--format", "json")
    shell.both("review", "clear")
    shell.both("review", "review", "--continue", rc=1)
    shell.same_files()


def test_review_without_assignments(shell, tmp_path):
    """Nothing to review: the messages and codes of both packages."""
    shell.both("review", "review", "--simple")
    wav = voice_wav(tmp_path / "audio" / "x.wav", 300)
    shell.both("catalog", "add", str(wav))
    shell.both("review", "review", str(wav), "--simple", rc=1)
    shell.both("review", "review", str(tmp_path / "nope.wav"), rc=1)


def test_llm_flow(shell, tmp_path):
    """tests/test_cli.py:test_llm_cli with the offline pattern provider,
    the text formats and the cache."""
    tr = _transcript(tmp_path / "t.json", [("S1", 0, 2000, "Hello, I'm Dave."),
                                           ("S2", 2000, 4000, "Thanks Dave, this is Erin.")])
    res = json.loads(shell.both("llm", "analyze", str(tr), "--provider", "pattern")[1])
    assert res["detections"][0]["detected_name"] == "Dave"
    shell.both("llm", "analyze", str(tr), "--provider", "pattern")  # from the cache
    shell.both("llm", "analyze", str(tr), "--provider", "pattern", "--format", "text",
               "--no-cache")
    assert json.loads(shell.both("llm", "detect-names", str(tr), "--provider", "pattern")[1]
                      )["S1"] == "Dave"
    shell.both("llm", "detect-names", str(tr), "--provider", "pattern", "--format", "text")
    assert "pattern" in shell.both("llm", "providers")[1]
    shell.same_files()
    shell.both("llm", "clear-cache", "--force")
    shell.same_files()


def test_detection_profile_commands(shell, tmp_path, monkeypatch):
    """The detection subcommands of PR 13 (update, delete, tag, export,
    query, remove-embedding, update-embedding, check-validity, validate,
    backends) through both packages on two stores under one frozen clock
    (profiles' ``utc_now_iso``; export's own timestamp is replaced by
    ``<time>``): equal return codes, stdout and stderr, and equal files
    after each step, the exported JSON and the embeddings' vectors
    included."""
    from sdtk_tpu.store import profiles as jp
    from sdtk_tpu_torch.store import profiles as pp

    for mod in (jp, pp):
        monkeypatch.setattr(mod, "utc_now_iso", lambda: "2026-01-02T03:04:05+00:00")
    a = voice_wav(tmp_path / "audio" / "a.wav", 220, seed=1)
    b = voice_wav(tmp_path / "audio" / "b.wav", 520, seed=2)
    tr = _transcript(tmp_path / "t.json", [("S1", 0, 1500, "one"), ("S1", 2000, 3500, "two")])
    shell.both("detection", "add", "alice", "--name", "Alice", "--tag", "team",
               "--name-context", "work=A. Smith", "--nickname", "Al")
    shell.both("detection", "add", "bob", "--name", "Bob", "--tag", "team", "--tag", "ext")
    shell.both("detection", "add", "carol", "--name", "Carol")
    shell.both("detection", "enroll", "alice", str(a))
    shell.both("detection", "enroll", "alice", str(a), "--segments", "0-2")
    shell.both("detection", "enroll", "bob", str(b), "--trust-level", "high")
    shell.both("samples", "extract", "alice", str(a), "--transcript", str(tr), "-l", "S1")
    shell.both("samples", "review", "alice", "--sample-id", "sample-001", "--reject")
    shell.same_files()

    shell.both("detection", "update", "alice", "--name", "Alicia", "--description", "lead",
               "--nickname", "Ali", "--remove-nickname", "Al", "--tag", "core",
               "--remove-tag", "team", "--metadata", "org=acme", "--name-context", "home=Ally")
    shell.both("detection", "update", "nobody", "--name", "X", rc=1)
    assert shell.both("detection", "tag", "bob", "--add", "vip", "--remove", "ext")[1] \
        == "team,vip\n"
    shell.both("detection", "tag", "nobody", "--add", "x", rc=1)
    shell.same_files()

    for argv in ([], ["--format", "speechmatics"], ["--tags", "team", "--context", "work"],
                 ["--format", "speechmatics", "--context", "home"]):
        shell.both("detection", "export", *argv)
    for pkg in ("jax", "port"):  # the file lands in each package's own root
        shell.run(pkg, "detection", "export", "-o", str(shell.root(pkg) / "export.json"))
    for expr in (".[].id", "[.[] | select(.tags | contains([\"team\"]))] | length",
                 ".[] | {id, n: (.embeddings | to_entries | map(.value | length) | add)}",
                 ".[] | .names.default | ascii_downcase", ".[0].nope.deeper"):
        shell.both("detection", "query", expr)
    # an unknown function: the message names each package's own jqlite module
    got = shell.run("port", "detection", "query", ".[] | frobnicate")
    want = shell.run("jax", "detection", "query", ".[] | frobnicate")
    assert got[:2] == want[:2] == (1, "")
    assert got[2] == want[2].replace("sdtk_tpu/", "sdtk_tpu_torch/")
    shell.same_files()

    for argv, rc in ((["alice"], 1), (["-v"], 1), (["bob", "-v"], 0), (["carol"], 0),
                     (["--fix", "-v"], 1), (["nobody"], 0)):
        shell.both("detection", "check-validity", *argv, rc=rc)
    shell.same_files()

    shell.both("detection", "update-embedding", "bob", "emb-00000002", "--trust-level", "low")
    shell.both("detection", "update-embedding", "bob", "emb-99999999", rc=1)
    shell.both("detection", "update-embedding", "nobody", "emb-00000002", rc=1)
    shell.both("detection", "remove-embedding", "alice", "emb-00000000")
    shell.both("detection", "remove-embedding", "alice", "emb-00000000", rc=1)
    shell.both("detection", "embeddings", "alice", "--show-trust")
    shell.same_files()

    assert shell.both("detection", "validate")[1] == "All files valid.\n"
    for pkg in ("jax", "port"):  # the same broken profile and sample file in each store
        store = shell.root(pkg) / "store"
        (store / "db" / "dave.json").write_text(json.dumps(
            {"id": "dave", "names": {"nick": "D"}, "tags": "oops", "version": "2",
             "embeddings": {"fake": [{"id": "e1", "created_at": "not a date",
                                      "trust_level": "great", "samples": {"reviewed": [1]},
                                      "source_segments": [{"start": 0}], "model_version": 3}],
                            "gpu": "notalist"}}))
        (store / "samples" / "alice" / "sample-009.meta.yaml").write_text(
            "sample_id: 9\nsource: {audio_b3sum: 5}\nsegment: []\nreview: {status: maybe}\n")
    out = shell.both("detection", "validate")[1]
    assert "db/dave.json:" in out and "samples/alice/sample-009.meta.yaml:" in out
    shell.both("detection", "validate", "--strict", rc=1)
    shell.both("detection", "validate", "dave", "--strict", rc=1)
    shell.both("detection", "validate", "bob", "--strict", rc=0)

    shell.both("detection", "delete", "carol", "--dry-run")
    shell.both("detection", "delete", "carol", rc=1)
    shell.both("detection", "delete", "carol", "--force")
    shell.both("detection", "delete", "carol", "-f", rc=1)
    shell.same_files()

    # the registries differ by the on-device backend's name: gpu here, tpu there.
    # Both start from their defaults: other test files register backends of
    # their own in the same process.
    from sdtk_tpu.backends import base as jbase
    from sdtk_tpu_torch.backends import base as pbase

    monkeypatch.setattr(pbase, "_REGISTRY", dict(pbase._DEFAULT_REGISTRY))
    monkeypatch.setattr(pbase, "_config_read", False)
    monkeypatch.setattr(jbase, "_registry_cache", None)
    monkeypatch.delenv("SPEAKER_BACKENDS_CONFIG", raising=False)
    got = shell.run("port", "detection", "backends")[1].split()
    want = shell.run("jax", "detection", "backends")[1].split()
    assert got == ["fake", "gpu", "speechmatics"]
    assert sorted(n if n != "tpu" else "gpu" for n in want) == got
    verbose = shell.run("port", "detection", "backends", "-v")[1].splitlines()
    assert verbose[0] == "fake  (dim=192, model=fake-spectral-v2)"
    assert verbose[2] == "speechmatics  (dim=0, model=speechmatics-v2)"


def test_detection_parser_matches_jax():
    """The port's detection tool has the JAX tool's seventeen subcommands,
    each with the JAX one's positionals and options; the port adds only
    ``--device``, on the commands that build an embedding backend."""
    import argparse

    from sdtk_tpu_torch.cli import detection as pdetection

    def commands(parser):
        sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
        return {name: sorted((a.dest, tuple(a.option_strings)) for a in p._actions)
                for name, p in sub.choices.items()}

    got, want = commands(pdetection.build_parser()), commands(jdetection.build_parser())
    assert list(got) == list(want) and len(got) == 17
    device = ("device", ("--device",))
    for name in want:
        extra = [d for d in got[name] if d not in want[name]]
        assert extra == ([device] if ("detection", name) in DEVICE_COMMANDS
                         or name == "verify" else []), name
        assert all(d in got[name] for d in want[name]), name
