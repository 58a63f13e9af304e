"""The port's store schemas (sdtk_tpu_torch/store/schemas.py), audio
profiles (backends/audio_profiles.py) and backend registry with its YAML
file (backends/base.py, ``$SPEAKER_BACKENDS_CONFIG``) against the JAX
package's: the same warnings and errors on valid and broken records, the
same profiles and ffmpeg arguments, the same registry names from one YAML
file."""

from __future__ import annotations

import json
import wave

import numpy as np
import pytest

from sdtk_tpu.backends import audio_profiles as jap
from sdtk_tpu.backends import base as jbase
from sdtk_tpu.store import schemas as jschemas
from sdtk_tpu_torch.backends import audio_profiles as pap
from sdtk_tpu_torch.backends import base as pbase
from sdtk_tpu_torch.backends.fake import FakeBackend
from sdtk_tpu_torch.backends.speechmatics import SpeechmaticsBackend
from sdtk_tpu_torch.store import profiles as pprofiles
from sdtk_tpu_torch.store import schemas as pschemas
from sdtk_tpu_torch.utils.audio import load_audio

GOOD_EMB = {"id": "e", "external_id": None, "created_at": "2026-01-01T00:00:00+00:00",
            "trust_level": "high"}
PROFILES = {
    "created": pprofiles.create_speaker_profile("x", "X", tags=["a"]),
    "not-a-dict": ["x"],
    "bad-types": {"id": "", "names": "oops", "tags": "notalist", "version": "1"},
    "missing": {"names": {"nick": "N"}, "tags": [1, "b"]},
    "embeddings": {"id": "y", "names": {"default": "Y"}, "embeddings": {
        "fake": [GOOD_EMB, {"id": 3, "external_id": 4, "created_at": 5, "vector_file": 6,
                            "model_version": "unknown", "trust_level": "x",
                            "samples": {"reviewed": "no", "rejected": [1]},
                            "source_segments": [1, {"start": 0}]}, "junk"],
        "gpu": "notalist"}},
    "embeddings-not-dict": {"id": "z", "names": {"default": "Z"}, "embeddings": []},
}
EMBEDDINGS = {
    "good": GOOD_EMB,
    "not-a-dict": "e",
    "empty": {},
    "bad": {"id": "", "external_id": 1, "created_at": "yesterday", "model_version": 2,
            "samples": 7, "source_segments": "x", "trust_level": None},
    "samples-none": {**GOOD_EMB, "samples": None, "source_segments": None, "vector_file": None},
}
METADATA = {
    "good": {"sample_id": "s", "source": {"audio_b3sum": None}, "segment": {},
             "review": {"status": "pending"}},
    "not-a-dict": 3,
    "bad": {"sample_id": 1, "source": [], "segment": "x", "review": {"status": "maybe"}},
    "b3sum": {"sample_id": "s", "source": {"audio_b3sum": 5}, "segment": {}},
    "missing": {"review": {"status": None}},
}
CASES = [(fn, name, rec) for fn, recs in (("validate_profile", PROFILES),
                                           ("validate_embedding", EMBEDDINGS),
                                           ("validate_sample_metadata", METADATA))
         for name, rec in recs.items()]


def _outcome(mod, fn: str, rec, strict: bool):
    try:
        return "ok", getattr(mod, fn)(rec, strict=strict)
    except mod.ValidationError as e:
        return "raised", str(e)


@pytest.mark.parametrize("strict", [False, True], ids=["warn", "strict"])
@pytest.mark.parametrize("fn,name,rec", CASES, ids=[f"{f}-{n}" for f, n, _ in CASES])
def test_schemas_match_jax(fn, name, rec, strict):
    """Each validator on each record: the same warnings, or the same
    ``ValidationError`` message under ``strict``."""
    got = _outcome(pschemas, fn, rec, strict)
    assert got == _outcome(jschemas, fn, rec, strict)
    if name == "good" or name == "created":
        assert got == ("ok", [])


def test_validate_all_matches_jax(tmp_path, monkeypatch):
    """``validate_all`` over a store with valid, broken and unreadable files:
    the same issues by relative path."""
    monkeypatch.setenv("SPEAKERS_EMBEDDINGS_DIR", str(tmp_path))
    (tmp_path / "db").mkdir()
    (tmp_path / "samples" / "a").mkdir(parents=True)
    (tmp_path / "db" / "ok.json").write_text(json.dumps(PROFILES["created"]))
    (tmp_path / "db" / "bad.json").write_text(json.dumps(PROFILES["bad-types"]))
    (tmp_path / "db" / "torn.json").write_text("{")
    (tmp_path / "samples" / "a" / "s1.meta.yaml").write_text("sample_id: 1\nsource: []\n")
    (tmp_path / "samples" / "a" / "s2.meta.yaml").write_text(
        "sample_id: s\nsource: {}\nsegment: {}\n")
    got, want = pschemas.validate_all(), jschemas.validate_all()
    assert sorted(got) == ["db/bad.json", "db/torn.json", "samples/a/s1.meta.yaml"]
    assert got.keys() == want.keys()
    for k in got:
        if k == "db/torn.json":  # the decoder's own message, which both read alike
            assert got[k][0].startswith("unreadable: ") and want[k][0].startswith("unreadable: ")
        else:
            assert got[k] == want[k], k


def test_audio_profiles_match_jax(tmp_path):
    """The same profiles by name (``gpu`` where JAX has ``tpu``), the same
    ``load_kwargs`` and ffmpeg arguments, ``register_profile`` and the
    default for an unknown name; ``load_kwargs`` feeds the port's
    ``load_audio`` (mono and two-channel)."""
    assert pap.get_profile("gpu") == pap.AudioProfile() and pap.get_profile("nope") == \
        pap.get_profile("default")
    for name in ("default", "fake", "speechmatics", "pyannote"):
        assert pap.get_profile(name).load_kwargs() == jap.get_profile(name).load_kwargs()
    for kw in ({}, {"sample_rate": 8000, "channels": 2, "bit_depth": 24},
               {"format": "flac", "max_duration_sec": 30.0}, {"bit_depth": 8}):
        assert pap.format_ffmpeg_args(pap.AudioProfile(**kw)) == \
            jap.format_ffmpeg_args(jap.AudioProfile(**kw))
        assert pap.AudioProfile(**kw).container == jap.AudioProfile(**kw).container
    pap.register_profile("custom-8k", pap.AudioProfile(sample_rate=8000, channels=2))
    try:
        prof = pap.get_profile("custom-8k")
        stereo = np.stack([np.linspace(-0.5, 0.5, 32000), np.zeros(32000)], axis=1)
        with wave.open(str(tmp_path / "s.wav"), "wb") as w:  # 16-bit PCM, two channels
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((stereo * 32767).astype("<i2").tobytes())
        x, sr = load_audio(tmp_path / "s.wav", **prof.load_kwargs())
        assert sr == 8000 and x.shape == (16000, 2)
        x, sr = load_audio(tmp_path / "s.wav", **pap.get_profile("default").load_kwargs())
        assert sr == 16000 and x.shape == (32000,)
    finally:
        pap.PROFILES.pop("custom-8k")


def test_backend_audio_profile():
    """Every backend resolves its profile (``default`` unless it names
    another, or returns one)."""
    assert FakeBackend(device="cpu").get_audio_profile() == pap.AudioProfile()
    assert SpeechmaticsBackend().get_audio_profile() == pap.get_profile("default")

    class Custom(FakeBackend):
        audio_profile = pap.AudioProfile(sample_rate=8000)

    assert Custom(device="cpu").get_audio_profile().sample_rate == 8000


def test_yaml_registry_matches_jax(tmp_path, monkeypatch):
    """One ``$SPEAKER_BACKENDS_CONFIG`` file (a string entry and a
    ``class:`` entry) read by both registries: the same names beside each
    package's defaults (``gpu`` here, ``tpu`` there); the entries build;
    ``reload_backends_config`` reads the file again and drops what it no
    longer lists, and registrations with it."""
    cfg = tmp_path / "backends.yaml"
    cfg.write_text("backends:\n  mine: sdtk_tpu_torch.backends.fake:FakeBackend\n"
                   "  other:\n    class: sdtk_tpu_torch.backends.fake:FakeBackend\n"
                   "  broken: 7\n")
    monkeypatch.setenv("SPEAKER_BACKENDS_CONFIG", str(cfg))
    for mod in (pbase, jbase):
        mod.reload_backends_config()
    try:
        got, want = pbase.list_backends(), jbase.list_backends()
        assert got == ["fake", "gpu", "mine", "other", "speechmatics"]
        assert sorted(n if n != "tpu" else "gpu" for n in want) == got
        assert isinstance(pbase.get_backend("other", device="cpu"), FakeBackend)
        pbase.register_backend("extra", FakeBackend(device="cpu"))
        assert "extra" in pbase.list_backends()
        monkeypatch.delenv("SPEAKER_BACKENDS_CONFIG")
        pbase.reload_backends_config()
        assert pbase.list_backends() == ["fake", "gpu", "speechmatics"]
        with pytest.raises(ValueError, match="Unknown backend 'mine'"):
            pbase.get_backend("mine")
    finally:
        for mod in (pbase, jbase):
            mod.reload_backends_config()
