"""The port's batch layer (``store/queue.py``, ``store/catalog.py``,
``pipeline/process.py``) against the JAX package's, and the kernel build
from several threads (``utils/build.py``, ``backends/gpu.py``), on the CPU.

Timestamps: each package's clock functions (``queue._now``,
``catalog.utc_now_iso``) are replaced by one deterministic clock in both,
so the YAML files compare byte for byte; assignment files carry their own
``assigned_at`` (``datetime.now`` inline), dropped before comparing.
Paths that name a package's own output directory are replaced by a
placeholder before comparing.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import sys
import threading
import time

import numpy as np
import pytest

from sdtk_tpu.pipeline import identify as jident
from sdtk_tpu.pipeline import process as jprocess
from sdtk_tpu.store import catalog as jcatalog
from sdtk_tpu.store import queue as jqueue
from sdtk_tpu_torch.backends import base, gpu
from sdtk_tpu_torch.data.synth import synth_utterance
from sdtk_tpu_torch.pipeline import assign as passign
from sdtk_tpu_torch.pipeline import identify as pident
from sdtk_tpu_torch.pipeline import process as pprocess
from sdtk_tpu_torch.store import catalog as pcatalog
from sdtk_tpu_torch.store import queue as pqueue
from sdtk_tpu_torch.utils import build
from sdtk_tpu_torch.utils.audio import save_wav
from sdtk_tpu_torch.utils.build import KernelError

PKGS = {"port": (pqueue, pcatalog, pprocess, pident, {"device": "cpu"}),
        "jax": (jqueue, jcatalog, jprocess, jident, {})}


def _clock(monkeypatch, module, attr):
    """Replace ``module.attr`` by a clock that ticks one second a call."""
    ticks = itertools.count()

    def now() -> str:
        n = next(ticks)
        return f"2026-01-01T00:{n // 60:02d}:{n % 60:02d}+00:00"

    monkeypatch.setattr(module, attr, now)


@pytest.fixture()
def wavs(tmp_path):
    """Two short recordings of two synthetic voices and a file with an
    audio suffix that no decoder reads."""
    d = tmp_path / "audio"
    d.mkdir()
    save_wav(d / "one.wav", np.concatenate([synth_utterance(0, 800, 2.5),
                                            synth_utterance(1, 801, 2.5)]))
    save_wav(d / "two.wav", synth_utterance(1, 802, 4.0))
    (d / "three.mp3").write_bytes(b"\x00" * 1000)
    return d


def test_queue_lifecycle_and_recovery_match_jax(wavs, tmp_path, monkeypatch):
    files, returns = {}, {}
    for name, (queue, *_rest) in PKGS.items():
        _clock(monkeypatch, queue, "_now")
        path = tmp_path / f"{name}.yaml"
        q = queue.ProcessingQueue(path)
        out = [q.add(wavs / "one.wav", context="standup"),
               q.add(wavs / "two.wav", backends=["tpu-diarize"]),
               q.add(wavs / "three.mp3"), q.add(tmp_path / "missing.wav")]
        out.append(q.next_pending())
        q.mark(out[0]["b3sum"], "completed", results={"transcripts": {"x": "y"}})
        out.append(q.next_pending())
        q.mark(wavs / "two.wav", "failed", error="boom")
        out.append(q.add(wavs / "two.wav", context="retro"))  # failed → pending again
        out.append(q.add(wavs / "one.wav", force=True))
        out.append(q.next_pending())  # left 'processing': a crash
        out += [q.get_pending(limit=1), q.counts(), q.items("pending")]
        files[name, "before"] = path.read_bytes()
        q2 = queue.ProcessingQueue(path)  # recovery: processing → pending
        out += [q2.get_stats(), q2.items()]
        q2.mark(wavs / "three.mp3", "skipped", error="unsupported")
        out += [q2.clear(status="skipped"), q2.get_stats()]
        with pytest.raises(ValueError):
            q2.mark(wavs / "one.wav", "bogus")
        files[name, "after"] = path.read_bytes()
        out.append(q2.clear())
        returns[name] = out
    assert files["port", "before"] == files["jax", "before"]
    assert files["port", "after"] == files["jax", "after"]
    assert returns["port"] == returns["jax"]
    recovered = returns["port"][12]  # get_stats() of the queue read after the crash
    assert recovered["processing"] == 0 and recovered["pending"] == 3
    assert pqueue.DEFAULT_BACKENDS == jqueue.DEFAULT_BACKENDS
    assert pqueue.VALID_STATES == jqueue.VALID_STATES


def test_catalog_and_contexts_match_jax(wavs, tmp_path, monkeypatch):
    snapshots = {}
    for name, (_, catalog, *_rest) in PKGS.items():
        root = tmp_path / name
        monkeypatch.setenv("SPEAKERS_EMBEDDINGS_DIR", str(root))
        _clock(monkeypatch, catalog, "utc_now_iso")
        out = [catalog.create_context("standup", ["alice", "bob"], "daily sync"),
               catalog.context_add_speaker("standup", "carol")]
        with pytest.raises(FileExistsError):
            catalog.create_context("standup")
        one = catalog.add_recording(wavs / "one.wav", context="standup", tags=["q1"])
        bad = catalog.add_recording(wavs / "three.mp3")  # no decoder: no duration
        with pytest.raises(FileExistsError):
            catalog.add_recording(wavs / "one.wav")
        b3 = one["recording"]["b3sum"]
        transcript = tmp_path / "t.json"
        transcript.write_text(json.dumps({"results": [
            {"type": "word", "start_time": 0.0, "end_time": 1.0, "speaker": "S1",
             "alternatives": [{"content": "hi"}]},
            {"type": "word", "start_time": 1.0, "end_time": 2.0, "speaker": "S2",
             "alternatives": [{"content": "yo"}]}]}))
        out += [one, bad, catalog.register_transcript(b3, transcript, "speechmatics",
                                                      version="2", tool_version="1.0")]
        with pytest.raises(FileExistsError):
            catalog.register_transcript(b3, transcript, "speechmatics")
        out.append(catalog.register_transcript(b3, transcript, "speechmatics", force=True))
        out.append(catalog.set_context(b3, "retro", add_tags=["x", "q1"], remove_tags=["q1"]))
        out.append(catalog.set_context(b3, None, expected_speakers=["dave"]))
        (root / "assignments" / f"{b3}.yaml").write_text("mappings: {}\n")
        out.append(catalog.compute_status(catalog.load_entry(b3)))
        out.append(catalog.set_review_status(b3, "partial"))
        out += [catalog.resolve_b3sum(b3[:10]), catalog.resolve_b3sum(str(wavs / "one.wav")),
                catalog.resolve_b3sum("zz"), catalog.find_by_path(wavs / "one.wav"),
                catalog.list_entries(), catalog.load_contexts()]
        snapshots[name] = {p.relative_to(root).as_posix(): p.read_bytes()
                           for p in sorted(root.rglob("*.yaml"))}
        out += [catalog.remove_recording(bad["recording"]["b3sum"]),
                catalog.remove_recording(b3), catalog.remove_recording(b3),
                catalog.list_entries()]
        snapshots[name, "out"] = out
    assert snapshots["port"] == snapshots["jax"]
    assert len(snapshots["port"]) == 4  # two entries, contexts.yaml, one assignment file
    assert snapshots["port", "out"] == snapshots["jax", "out"]
    entry, bad = snapshots["port", "out"][2:4]
    assert entry["recording"]["duration_sec"] == 5.0
    assert entry["context"]["expected_speakers"] == ["alice", "bob", "carol"]
    assert bad["recording"]["duration_sec"] is None


def _normalized(obj, root):
    """``obj`` as JSON text with the package's directory replaced."""
    return json.loads(json.dumps(obj, default=str).replace(str(root), "<ROOT>"))


def test_process_single_and_batch_match_jax(wavs, tmp_path, monkeypatch):
    """The per-recording pipeline (catalog add → on-device transcriber →
    register → assign) and the threaded batch over the queue, with the
    ``fake`` backend, in both packages: the same steps, transcript,
    catalog entries, assignment mappings and queue states."""
    monkeypatch.setenv("SPEAKER_DETECTION_BACKEND", "fake")
    seen = {}
    for name, (queue, catalog, process, ident, kw) in PKGS.items():
        root = tmp_path / name
        monkeypatch.setenv("SPEAKERS_EMBEDDINGS_DIR", str(root / "store"))
        _clock(monkeypatch, catalog, "utc_now_iso")
        monkeypatch.setattr(queue, "_now", lambda: "2026-01-01T00:00:00+00:00")
        monkeypatch.setattr(sys.modules[catalog.__name__.replace("catalog", "profiles")],
                            "new_embedding_id", lambda: "emb-00000001")
        ident.enroll("alice", wavs / "two.wav", create_missing=True, name="Alice", **kw)
        out_dir = root / "transcripts"
        res = process.process_single(wavs / "one.wav", backends=["tpu-diarize"],
                                     output_dir=out_dir, embed_backend="fake", quiet=True, **kw)
        b3 = res.b3sum
        assignment = (root / "store" / "assignments" / f"{b3}.yaml").read_text()
        seen[name] = {
            "result": _normalized(res.__dict__, root),
            "transcript": json.loads((out_dir / "one.tpu-diarize.json").read_text()),
            "entry": _normalized(catalog.load_entry(b3), root),
            "status": catalog.compute_status(catalog.load_entry(b3)),
            "assignment": [ln.replace(str(root), "<ROOT>") for ln in assignment.splitlines()
                           if not ln.startswith("assigned_at:")],
        }
        q = queue.ProcessingQueue(root / "queue.yaml")
        items = [q.add(wavs / f, backends=["tpu-diarize"]) for f in ("one.wav", "two.wav",
                                                                     "three.mp3")]
        results = process.process_batch(items, queue=q, parallel=2, output_dir=out_dir,
                                        embed_backend="fake", quiet=True, **kw)
        seen[name]["batch"] = sorted((r.audio_path, r.success, r.unsupported_format,
                                      r.steps_completed, r.steps_failed) for r in results)
        seen[name]["queue"] = _normalized(
            sorted(((i["audio_path"], i["status"], i["attempts"], i["results"]) for i in q.items()),
                   key=str), root)
        seen[name]["entries"] = sorted((e["recording"]["path"], catalog.compute_status(e),
                                        len(e["transcriptions"]))
                                       for e in catalog.list_entries())
    port, ref = seen["port"], seen["jax"]
    for key in port:
        assert port[key] == ref[key], key
    assert port["result"]["success"] and "speaker_assign" in port["result"]["steps_completed"]
    assert port["status"] == "assigned"
    assert [i[1] for i in port["queue"]] == ["completed", "skipped", "completed"]
    assert [e[1] for e in port["entries"]] == ["assigned", "unprocessed", "assigned"]


@pytest.mark.parametrize("step", ["transcribe_local", "assign"])
def test_device_errors_propagate_out_of_process(step, wavs, tmp_path, monkeypatch):
    """A kernel fault in the transcriber or in assignment stops
    ``process_single``; ``process_batch`` marks the item failed, then
    raises it.  Another failure still degrades to a failed step."""
    monkeypatch.setenv("SPEAKER_DETECTION_BACKEND", "fake")
    monkeypatch.setenv("SPEAKERS_EMBEDDINGS_DIR", str(tmp_path / "store"))
    target = (pprocess, "transcribe_local") if step == "transcribe_local" else \
        (passign, "assign")
    error = [KernelError("log_mel_wave kernel launch failed: cudaError 700")]

    def failing(*args, **kwargs):
        raise error[0]

    monkeypatch.setattr(*target, failing)
    kw = {"backends": ["tpu-diarize"], "output_dir": tmp_path / "out", "embed_backend": "fake",
          "quiet": True, "device": "cpu"}
    with pytest.raises(KernelError):
        pprocess.process_single(wavs / "one.wav", **kw)
    q = pqueue.ProcessingQueue(tmp_path / "q.yaml")
    items = [q.add(wavs / "one.wav"), q.add(wavs / "two.wav")]
    kw.pop("backends")
    with pytest.raises(KernelError):
        pprocess.process_batch(items, queue=q, parallel=2, **kw)
    assert q.counts()["failed"] == 2
    error[0] = RuntimeError("something else")
    res = pprocess.process_single(wavs / "two.wav", backends=["tpu-diarize"],
                                  **{k: v for k, v in kw.items()})
    failed_step = "transcribe_tpu-diarize" if step == "transcribe_local" else "speaker_assign"
    assert failed_step in res.steps_failed


def test_host_shard_is_a_partition_every_process_agrees_on():
    """Hosts are separate processes: the split must not depend on the
    per-process string hash seed."""
    import os
    import subprocess

    paths = [f"/data/rec-{i}.wav" for i in range(50)]
    shards = [pprocess.host_shard(paths, h, 4) for h in range(4)]
    assert sorted(sum(shards, [])) == sorted(paths)
    assert all(shards)
    code = ("import json; from sdtk_tpu_torch.pipeline.process import host_shard; "
            f"print(json.dumps([host_shard({paths!r}, h, 4) for h in range(4)]))")
    seed = "1" if os.environ.get("PYTHONHASHSEED") != "1" else "2"
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONHASHSEED": seed},
                         cwd=str(pprocess.Path(pprocess.__file__).parents[2]))
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout) == shards


def test_process_cli_on_cpu_matches_jax(wavs, tmp_path, monkeypatch):
    """``speaker-process-gpu`` with ``--device cpu`` against the JAX
    package's CLI: queue, status, process, run and clear-queue give the
    same return codes and output (paths replaced)."""
    import contextlib
    import io

    from sdtk_tpu.cli import process as jcli
    from sdtk_tpu_torch.cli import process as pcli

    monkeypatch.setenv("SPEAKER_DETECTION_BACKEND", "fake")
    runs = {}
    for name, main, dev in (("port", pcli.main, ["--device", "cpu"]), ("jax", jcli.main, [])):
        root = tmp_path / name
        monkeypatch.setenv("SPEAKERS_EMBEDDINGS_DIR", str(root / "store"))
        out_dir = str(root / "out")

        def run(*argv):
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = main(list(argv))
            return rc, out.getvalue().replace(str(root), "<ROOT>"), \
                err.getvalue().replace(str(root), "<ROOT>")

        r = runs[name] = {}
        r["missing"] = run("queue", str(tmp_path / "nowhere"))
        r["queue"] = run("queue", str(wavs), "-b", "tpu-diarize")
        r["status"] = run("status")
        r["process"] = run("process", str(wavs / "one.wav"), "-b", "tpu-diarize", "-o", out_dir,
                           "--embed-backend", "fake", *dev)
        r["run"] = run("run", "-o", out_dir, "--embed-backend", "fake", "--parallel", "1", *dev)
        r["run-empty"] = run("run", *dev)
        r["status-after"] = run("-v", "status")
        r["clear"] = run("clear-queue", "--status", "completed", "--force")
        r["counts"] = json.loads(run("status", "--format", "json")[1])["stats"]
    port, ref = runs["port"], runs["jax"]
    for key in port:
        if key in ("process", "run", "status-after"):
            assert port[key][0] == ref[key][0], key
            continue
        assert port[key] == ref[key], key
    assert [ln for ln in port["status-after"][1].splitlines() if "error:" not in ln] == \
        [ln for ln in ref["status-after"][1].splitlines() if "error:" not in ln]
    assert port["process"][0] == 0 and "Summary: 1 succeeded, 0 failed" in port["process"][1]
    assert port["run"][0] == 1  # the .mp3 is skipped, which the summary counts as failed
    assert port["counts"] == {"pending": 0, "processing": 0, "completed": 0, "failed": 0,
                              "skipped": 1, "total": 1}


# -- the kernel build from several threads ------------------------------------


def _fake_nvcc(tmp_path, sleep_s: float, fail: bool = False):
    """An ``nvcc`` stand-in: logs its call, sleeps, writes its ``-o`` file
    (or fails)."""
    log = tmp_path / "calls.log"
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        f"open({str(log)!r}, 'a').write('call\\n')\n"
        f"time.sleep({sleep_s})\n"
        f"if {fail}:\n"
        "    print('error: boom'); sys.exit(2)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').write(b'half')\n"
        "time.sleep(0.05)\n"
        "open(out, 'ab').write(b' and whole')\n")
    script.chmod(0o755)
    return str(script), log


def test_load_library_from_four_threads_builds_once(tmp_path, monkeypatch):
    nvcc, log = _fake_nvcc(tmp_path, 0.3)
    monkeypatch.setattr(build, "nvcc", lambda: nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_loaded", {})
    opened = []

    def fake_cdll(path):
        opened.append(open(path, "rb").read())
        return object()

    monkeypatch.setattr(ctypes, "CDLL", fake_cdll)
    barrier, libs, errors = threading.Barrier(4), [], []

    def worker():
        try:
            barrier.wait(timeout=10)
            libs.append(build.load_library("cosine"))
        except Exception as e:  # noqa: BLE001 — collected for the assertion
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert log.read_text().count("call") == 1
    assert len(libs) == 4 and all(lib is libs[0] for lib in libs)
    assert opened == [b"half and whole"]
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [build.library_path("cosine").name]


def test_failed_build_raises_kernel_error(tmp_path, monkeypatch):
    nvcc, _ = _fake_nvcc(tmp_path, 0.0, fail=True)
    monkeypatch.setattr(build, "nvcc", lambda: nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(KernelError, match="boom"):
        build.load_library("cosine")
    assert list((tmp_path / "_build").iterdir()) == []
    assert issubclass(KernelError, RuntimeError)


def test_backend_and_engine_built_once_from_four_threads(monkeypatch):
    built = []

    class SlowEngine:
        def __init__(self, *args, device):
            time.sleep(0.2)
            built.append(self)

    monkeypatch.setattr(gpu, "EmbedEngine", SlowEngine)
    monkeypatch.setattr(base, "_instances", {})
    barrier, seen = threading.Barrier(4), []

    def worker():
        barrier.wait(timeout=10)
        backend = base.get_backend("gpu", device="cpu")
        seen.append((backend, backend.engine))

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(built) == 1 and len(seen) == 4
    assert all(b is seen[0][0] and e is built[0] for b, e in seen)
