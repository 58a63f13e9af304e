"""The port's speaker-assign path (transcripts → catalog context →
per-label identify → four-signal fusion → assignment file) against the
JAX package's, on the CPU.

1. With the ``fake`` backend (NumPy embeddings, equal to the bit in both
   packages) the two ``assign`` calls on one recording and one transcript
   give equal output, ``mappings`` included (speaker ids, confidences,
   rounded scores, every signal with its evidence, candidates), for both
   transcript formats, with and without the LLM signal (the offline
   pattern provider) and the cross-backend signal.  Embedding ids are
   drawn from one counter in both stores so the evidence compares.  The
   assignment files are equal byte for byte once the ``assigned_at`` line,
   the one timestamp in them, is dropped.
2. ``GpuBackend(device="cpu")`` against ``TpuBackend``, one narrow random
   ECAPA tower read from one flax msgpack (f32): the same label → profile
   map, scores within 1e-4 (f32 towers, products summed in another order).
3. The CLI (``assign``, ``show``, ``apply``, ``clear``) with ``--device
   cpu`` against the JAX package's: the same return codes and output.
4. A ``KernelError`` or a CUDA error under the embedding collectors
   propagates out of ``assign``; other failures still degrade.
5. ``enroll --from-transcript`` and ``resolve_segments`` take the JAX
   package's segments, messages and return codes.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtk_tpu.backends import base as jbase
from sdtk_tpu.backends.tpu import TpuBackend
from sdtk_tpu.cli import assign as jcli
from sdtk_tpu.cli import detection as jdetection
from sdtk_tpu.models.ecapa import EcapaConfig as JaxEcapaConfig
from sdtk_tpu.models.ecapa import EcapaTdnn as JaxEcapa
from sdtk_tpu.pipeline import assign as jassign
from sdtk_tpu.pipeline import identify as jident
from sdtk_tpu.store import catalog as jcatalog
from sdtk_tpu.store import profiles as jprofiles
from sdtk_tpu_torch.backends import base
from sdtk_tpu_torch.backends.gpu import GpuBackend
from sdtk_tpu_torch.cli import assign as pcli
from sdtk_tpu_torch.cli import detection as pdetection
from sdtk_tpu_torch.data.synth import synth_utterance
from sdtk_tpu_torch.pipeline import assign as passign
from sdtk_tpu_torch.pipeline import identify as pident
from sdtk_tpu_torch.store import catalog as pcatalog
from sdtk_tpu_torch.store import profiles as pprofiles
from sdtk_tpu_torch.utils.audio import save_wav
from sdtk_tpu_torch.utils.build import KernelError

PORT = {"ident": pident, "assign": passign, "catalog": pcatalog, "profiles": pprofiles,
        "cli": pcli, "detection": pdetection, "kw": {"device": "cpu"}}
JAX = {"ident": jident, "assign": jassign, "catalog": jcatalog, "profiles": jprofiles,
       "cli": jcli, "detection": jdetection, "kw": {}}
NAMES = ("alice", "bob", "carol")  # voices 0, 1, 2
# (voice, seconds, words): voice 2's 0.4 s turn is dropped before merging
TURNS = [(0, 3.0, "Hi everyone, I'm Alice and I run the team"),
         (1, 2.5, "Thanks Alice. My name is Bob"),
         (2, 3.2, "Good morning all"),
         (0, 2.8, "Carol, what is your update"),
         (2, 0.4, "yes"),
         (1, 3.1, "Making good progress here"),
         (2, 2.6, "This is Carol, all fine"),
         (0, 2.0, "Great, thanks")]


@pytest.fixture(scope="module")
def meeting(tmp_path_factory):
    """A 19.6 s three-voice conversation as a WAV, held-out enrollment WAVs
    and its transcripts: AssemblyAI (ms, labels C/A/B) and Speechmatics
    (s, one item per word, labels S3/S1/S2 and punctuation between turns)."""
    d = tmp_path_factory.mktemp("meeting")
    pieces, t, aai, words = [], 0.0, [], []
    aai_label, sm_label = {0: "C", 1: "A", 2: "B"}, {0: "S3", 1: "S1", 2: "S2"}
    for i, (voice, seconds, text) in enumerate(TURNS):
        pieces.append(synth_utterance(voice, 700 + i, seconds))
        aai.append({"speaker": aai_label[voice], "start": int(round(t * 1000)),
                    "end": int(round((t + seconds) * 1000)), "text": text})
        tokens = text.split()
        for k, token in enumerate(tokens):
            a, b = t + seconds * k / len(tokens), t + seconds * (k + 1) / len(tokens)
            words.append({"type": "word", "start_time": round(a, 3), "end_time": round(b, 3),
                          "alternatives": [{"content": token, "speaker": sm_label[voice]}]})
        words.append({"type": "punctuation", "start_time": round(t + seconds, 3),
                      "end_time": round(t + seconds, 3), "alternatives": [{"content": "."}]})
        t += seconds
    save_wav(d / "meeting.wav", np.concatenate(pieces))
    for voice, name in enumerate(NAMES):
        save_wav(d / f"{name}.wav", synth_utterance(voice, 1, 6.0))
    (d / "assemblyai.json").write_text(json.dumps({"utterances": aai}))
    (d / "speechmatics.json").write_text(json.dumps({"results": words}))
    truth = {"assemblyai": {aai_label[v]: n for v, n in enumerate(NAMES)},
             "speechmatics": {sm_label[v]: n for v, n in enumerate(NAMES)}}
    return d, truth


def _store(pkg, root, wavs, monkeypatch, backends=("fake",), trust="high"):
    """Enroll the three voices of ``wavs`` in a store at ``root`` with each
    backend, embedding ids from a counter, ``trust`` on every record; a
    context expecting all three and the meeting cataloged under it."""
    monkeypatch.setenv("SPEAKERS_EMBEDDINGS_DIR", str(root))
    counter = itertools.count()
    monkeypatch.setattr(pkg["profiles"], "new_embedding_id", lambda: f"emb-{next(counter):08d}")
    for name in NAMES:
        for backend in backends:
            pkg["ident"].enroll(name, wavs / f"{name}.wav", backend_name=backend,
                                create_missing=True, name=name.title(), **pkg["kw"])
        profile = pkg["profiles"].load_speaker(name)
        for records in profile["embeddings"].values():
            for record in records:
                record["trust_level"] = trust
        pkg["profiles"].save_speaker(profile)
    pkg["catalog"].create_context("standup", speakers=list(NAMES))
    pkg["catalog"].add_recording(wavs / "meeting.wav", context="standup")


@pytest.fixture()
def offline_llm(tmp_path, monkeypatch):
    """No LLM provider: the assign collector falls back to the offline
    pattern provider (one response cache per package)."""
    monkeypatch.delenv("ANTHROPIC_API_KEY", raising=False)
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    monkeypatch.setenv("OLLAMA_HOST", "http://127.0.0.1:1")


def _drop_timestamp(yaml_text: str) -> str:
    return "\n".join(ln for ln in yaml_text.splitlines() if not ln.startswith("assigned_at:"))


@pytest.mark.parametrize("llm,cross", [(False, False), (True, False), (False, True),
                                       (True, True)])
@pytest.mark.parametrize("fmt", ["assemblyai", "speechmatics"])
def test_assign_with_fake_backend_matches_jax(meeting, fmt, llm, cross, offline_llm,
                                              tmp_path, monkeypatch):
    d, truth = meeting
    monkeypatch.setenv("SPEAKER_DETECTION_BACKEND", "fake")
    outputs, files = {}, {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        _store(pkg, tmp_path / name, d, monkeypatch)
        monkeypatch.setenv("SPEAKER_LLM_CACHE_DIR", str(tmp_path / f"llm-{name}"))
        outputs[name] = pkg["assign"].assign(
            d / "meeting.wav", d / f"{fmt}.json", use_llm=llm, threshold=0.3, quiet=True,
            cross_backends=["fake"] if cross else None, **pkg["kw"])
        b3 = outputs[name]["recording_b3sum"]
        files[name] = (tmp_path / name / "assignments" / f"{b3}.yaml").read_text()
    got, want = outputs["port"], outputs["jax"]
    assert got.pop("assigned_at") and want.pop("assigned_at")
    assert got == want
    assert _drop_timestamp(files["port"]) == _drop_timestamp(files["jax"])
    assert got["method"] == "speaker-assign-v1.0.0" and got["context"] == "standup"
    mappings = got["mappings"]
    assert {label: m["speaker_id"] for label, m in mappings.items()} == truth[fmt]
    for m in mappings.values():
        types = {s["type"] for s in m["signals"]}
        assert {"embedding_match", "context_expected"} <= types
        assert ("cross_backend_agreement" in types) == cross
    if llm:  # each voice names itself or is named by the next speaker
        assert any(s["type"] == "llm_name_detection"
                   for m in mappings.values() for s in m["signals"])


# -- a real tower: GpuBackend on the CPU against TpuBackend -------------------

TOWER = {"channels": 64, "se_bottleneck": 32, "attention_channels": 32, "mfa_channels": 192,
         "dtype": "float32"}


@pytest.fixture(scope="module")
def narrow_checkpoint(tmp_path_factory):
    """A random narrow ECAPA, BatchNorm statistics redrawn, as a flax
    msgpack with an f32 config sidecar and a calibration sidecar."""
    d = tmp_path_factory.mktemp("narrow")
    v = jax.jit(JaxEcapa(JaxEcapaConfig(**TOWER)).init)(jax.random.PRNGKey(5),
                                                       jnp.zeros((1, 64, 80)))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(6)

    def redraw(t):
        return {k: redraw(x) if isinstance(x, dict) else
                (np.abs(rng.standard_normal(x.shape)) + 0.5 if k == "var"
                 else 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
                for k, x in t.items()}

    path = d / "narrow.msgpack"
    path.write_bytes(flax.serialization.msgpack_serialize(
        {"params": v["params"], "batch_stats": redraw(v["batch_stats"])}))
    path.with_suffix(".config.json").write_text(json.dumps(
        {"model": TOWER, "frontend": {"compute_dtype": "float32"}}))
    path.with_suffix(".calib.json").write_text('{"eer_threshold": 0.2, "gain": 0.5}')
    return path


def test_assign_with_narrow_tower_matches_tpu_backend(meeting, narrow_checkpoint, tmp_path,
                                                      monkeypatch):
    """Primary backend the tower, ``fake`` the cross backend, both formats:
    the same decisions, scores within 1e-4."""
    d, _ = meeting
    port = GpuBackend(channels=64, params_path=narrow_checkpoint, device="cpu")
    monkeypatch.setitem(base._instances, ("gpu-narrow",), port)
    monkeypatch.setitem(base._REGISTRY, "gpu-narrow", "<instance:gpu-narrow>")
    monkeypatch.setitem(jbase._load_registry(), "tpu-narrow", "<instance:tpu-narrow>")
    monkeypatch.setitem(jbase._instance_cache, "tpu-narrow",
                        TpuBackend(channels=64, params_path=narrow_checkpoint))
    out = {}
    for name, pkg, tower in (("port", PORT, "gpu-narrow"), ("jax", JAX, "tpu-narrow")):
        _store(pkg, tmp_path / name, d, monkeypatch, backends=(tower, "fake"))
        for fmt in ("assemblyai", "speechmatics"):
            out[name, fmt] = pkg["assign"].assign(
                d / "meeting.wav", d / f"{fmt}.json", threshold=0.0, backend=tower,
                cross_backends=["fake"], save=False, quiet=True, **pkg["kw"])["mappings"]
    for fmt in ("assemblyai", "speechmatics"):
        got, want = out["port", fmt], out["jax", fmt]
        assert got.keys() == want.keys()
        for label in got:
            g, w = got[label], want[label]
            assert (g["speaker_id"], g["confidence"]) == (w["speaker_id"], w["confidence"])
            assert abs(g["score"] - w["score"]) <= 1e-3  # both rounded to 3 places
            assert [s["type"] for s in g["signals"]] == [s["type"] for s in w["signals"]]
            np.testing.assert_allclose([s["score"] for s in g["signals"]],
                                       [s["score"] for s in w["signals"]], rtol=0, atol=1e-4)
            assert [c["speaker_id"] for c in g.get("candidates", [])] == \
                [c["speaker_id"] for c in w.get("candidates", [])]
            np.testing.assert_allclose([c["score"] for c in g.get("candidates", [])],
                                       [c["score"] for c in w.get("candidates", [])],
                                       rtol=0, atol=1e-4)
            assert any(s["type"] == "embedding_match" and s["backend"] == "gpu"
                       for s in g["signals"])


# -- the CLI -------------------------------------------------------------------


def _run(main, argv) -> tuple[int, str, str]:
    out, errs = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(errs):
        rc = main(argv)
    return rc, out.getvalue(), errs.getvalue()


def test_assign_cli_on_cpu_matches_jax(meeting, offline_llm, tmp_path, monkeypatch):
    d, truth = meeting
    monkeypatch.setenv("SPEAKER_DETECTION_BACKEND", "fake")
    audio, transcript = str(d / "meeting.wav"), str(d / "assemblyai.json")
    runs = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        _store(pkg, tmp_path / name, d, monkeypatch)
        monkeypatch.setenv("SPEAKER_LLM_CACHE_DIR", str(tmp_path / f"llm-{name}"))
        dev = ["--device", "cpu"] if name == "port" else []
        main = pkg["cli"].main
        r = runs[name] = {}
        r["missing-audio"] = _run(main, ["assign", str(tmp_path / "no.wav"), "-t", transcript,
                                         *dev])
        r["missing-transcript"] = _run(main, ["assign", audio, "-t", str(tmp_path / "no.json"),
                                              *dev])
        r["show-none"] = _run(main, ["show", audio])
        r["clear-none"] = _run(main, ["clear", audio, "--force"])
        r["dry-run"] = _run(main, ["assign", audio, "-t", transcript, "-n", "--use-llm", *dev])
        r["assign"] = _run(main, ["assign", audio, "-t", transcript, "--use-llm",
                                  "--cross-backends", "fake", *dev])
        r["show-json"] = _run(main, ["show", audio, "--format", "json"])
        r["show-text"] = _run(main, ["show", audio])
        r["apply"] = _run(main, ["apply", audio])
        r["apply-ids"] = _run(main, ["apply", audio, "--ids", "-o", str(tmp_path / "mapped.json")])
        r["apply-ids-bytes"] = (tmp_path / "mapped.json").read_bytes()
        r["clear"] = _run(main, ["-q", "clear", audio, "--force"])
        r["show-cleared"] = _run(main, ["show", audio])
    port, ref = runs["port"], runs["jax"]
    for key in port:
        if key in ("show-json", "show-text"):
            continue
        assert port[key] == ref[key], key
    got, want = json.loads(port["show-json"][1]), json.loads(ref["show-json"][1])
    assert got.pop("assigned_at") and want.pop("assigned_at")
    assert got == want
    assert [ln for ln in port["show-text"][1].splitlines() if not ln.startswith("Assigned at")] \
        == [ln for ln in ref["show-text"][1].splitlines() if not ln.startswith("Assigned at")]
    assert port["assign"][0] == 0 and "Assigned: 3/3" in port["assign"][1]
    assert port["missing-audio"][0] == 1 and port["show-cleared"][0] == 1
    mapped = json.loads(port["apply"][1])
    assert {u["speaker"] for u in mapped["utterances"]} == {"Alice", "Bob", "Carol"}
    assert json.loads(port["apply-ids-bytes"])["utterances"][0]["speaker"] == "alice"
    assert {m["speaker_id"] for m in got["mappings"].values()} == set(truth["assemblyai"].values())


# -- device faults propagate; other failures degrade ---------------------------


@pytest.mark.parametrize("error,propagates", [
    (KernelError("cosine kernel launch failed: cudaError 700"), True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
    (torch.AcceleratorError("CUDA error: an illegal memory access was encountered"), True),
    (RuntimeError("store unreadable"), False),
])
def test_device_errors_propagate_out_of_assign(meeting, error, propagates, tmp_path,
                                               monkeypatch):
    d, _ = meeting
    monkeypatch.setenv("SPEAKER_DETECTION_BACKEND", "fake")
    _store(PORT, tmp_path / "store", d, monkeypatch)
    calls = []

    def failing_identify(*args, **kwargs):
        calls.append(kwargs.get("backend_name"))
        raise error

    for cross in (None, ["fake"]):
        calls.clear()
        monkeypatch.setattr(pident, "identify", failing_identify)
        if propagates:
            with pytest.raises(type(error)):
                passign.assign(d / "meeting.wav", d / "assemblyai.json", quiet=True,
                               cross_backends=cross, device="cpu")
            assert len(calls) == 1
        else:  # JAX's degradation: context signals only, every label unassigned at 0.3
            out = passign.assign(d / "meeting.wav", d / "assemblyai.json", quiet=True,
                                 threshold=0.3, cross_backends=cross, device="cpu")
            assert all(m["speaker_id"] is None for m in out["mappings"].values())
            assert len(calls) == 3
    if propagates:  # the cross-backend collector re-raises too
        real = pident.identify

        def cross_fails(*args, **kwargs):
            if kwargs.get("backend_name") == "cross":
                raise error
            return real(*args, **kwargs)

        monkeypatch.setattr(pident, "identify", cross_fails)
        with pytest.raises(type(error)):
            passign.assign(d / "meeting.wav", d / "assemblyai.json", quiet=True,
                           cross_backends=["cross"], device="cpu")


def test_assign_defaults_to_cuda(meeting, monkeypatch, tmp_path):
    d, _ = meeting
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("SPEAKERS_EMBEDDINGS_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        passign.assign(d / "meeting.wav", d / "assemblyai.json", quiet=True)


# -- segments from a transcript -------------------------------------------------


def test_enroll_from_transcript_matches_jax(meeting, tmp_path, monkeypatch):
    d, _ = meeting
    monkeypatch.setenv("SPEAKER_DETECTION_BACKEND", "fake")
    audio = str(d / "meeting.wav")
    for fmt, label in (("assemblyai", "A"), ("speechmatics", "S2")):
        path = d / f"{fmt}.json"
        assert pident.resolve_segments(None, path, label) == \
            jident.resolve_segments(None, path, label)
        assert pident.resolve_segments([(0.0, 1.0)], path, label) == [(0.0, 1.0)]
    runs = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        monkeypatch.setenv("SPEAKERS_EMBEDDINGS_DIR", str(tmp_path / name))
        main = pkg["detection"].main
        dev = ["--device", "cpu"] if name == "port" else []
        assert _run(main, ["add", "bob", "--name", "Bob"])[0] == 0
        r = runs[name] = {}
        for fmt, label in (("assemblyai", "A"), ("speechmatics", "S1"),
                           ("speechmatics", "S9")):
            r[fmt, label] = _run(main, ["enroll", "bob", audio, "-t", str(d / f"{fmt}.json"),
                                        "-l", label, *dev])
        r["no-label"] = _run(main, ["enroll", "bob", audio, "-t", str(d / "assemblyai.json"),
                                    *dev])
        r["no-file"] = _run(main, ["enroll", "bob", audio, "-t", str(tmp_path / "none.json"),
                                   "-l", "A", *dev])
        r["dry-run"] = _run(main, ["enroll", "bob", audio, "-t", str(d / "assemblyai.json"),
                                   "-l", "A", "-n", *dev])
        r["records"] = [(rec["source_segments"], rec["model_version"])
                        for rec in pkg["profiles"].load_speaker("bob")["embeddings"]["fake"]]
        r["vectors"] = [pkg["profiles"].load_vector(rec)
                        for rec in pkg["profiles"].load_speaker("bob")["embeddings"]["fake"]]
    port, ref = runs["port"], runs["jax"]
    for key in port:
        if key not in ("vectors",) and not (isinstance(key, tuple) and key[1] != "S9"):
            assert port[key] == ref[key], key
    for key in (("assemblyai", "A"), ("speechmatics", "S1")):
        assert port[key][0] == ref[key][0] == 0
        assert port[key][2].splitlines()[0] == ref[key][2].splitlines()[0]  # "Found N segments"
    assert port[("speechmatics", "S9")][0] == 1
    assert "No segments found for speaker 'S9'" in port[("speechmatics", "S9")][2]
    assert len(port["records"]) == 2 and port["records"][0][0][0] == {"start": 3.0, "end": 5.5}
    for got, want in zip(port["vectors"], ref["vectors"]):
        np.testing.assert_array_equal(got, want)
