"""The port's profile store (sdtk_tpu_torch/store, utils/hashing.py,
utils/ioutil.py) against the JAX package's: BLAKE3 on the published
vectors and on long inputs, the same bytes on disk for the same profile,
and a store written by either package read by the other (profiles,
trust levels, sample review state and the ``ProfileMatrix``)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from sdtk_tpu.store import migrations as jmig
from sdtk_tpu.store import profiles as jprof
from sdtk_tpu.store import samples as jsamples
from sdtk_tpu.utils import hashing as jhash
from sdtk_tpu_torch import config
from sdtk_tpu_torch.store import migrations, profiles, samples
from sdtk_tpu_torch.utils import hashing

from conftest import make_wav

# Published BLAKE3 test vectors (as in tests/test_hashing.py).
EMPTY_HEX = "af1349b9f5f9a1a6a0404dea36dcc9499bcb25c9adc112b7cc9a93cae41f3262"
ABC_HEX = "6437b3ac38465133ffb63b75273a8db548c558465d79db03fd359c6cd5bd9d85"


@pytest.mark.parametrize("fn", [hashing.blake3_scalar, hashing.blake3_numpy, hashing.blake3])
@pytest.mark.parametrize("data,want", [(b"", EMPTY_HEX), (b"abc", ABC_HEX)])
def test_blake3_published_vectors(fn, data, want):
    assert fn(data).hex() == want


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 2048, 4096, 5000, 65536 + 7])
def test_blake3_matches_jax(n):
    data = bytes((i * 7 + 3) % 251 for i in range(n))
    want = jhash.blake3_scalar(data)
    assert hashing.blake3_numpy(data) == want
    assert hashing.blake3_scalar(data) == want
    assert hashing.blake3(data) == jhash.blake3(data)


def test_compute_b3sum_matches_jax(tmp_path):
    path = make_wav(tmp_path / "a.wav", seconds=0.7, seed=3)
    got = hashing.compute_b3sum(path)
    assert len(got) == 32 and got == jhash.compute_b3sum(path)


def test_layout_follows_the_environment(speakers_dir):
    assert config.speakers_dir() == speakers_dir
    assert config.ensure_layout() == speakers_dir
    for sub in ("db", "embeddings", "samples", "catalog", "assignments"):
        assert (speakers_dir / sub).is_dir()
    assert config.default_backend() == "gpu"


@pytest.mark.parametrize("obj", [
    {"id": "a", "names": {"default": "A"}},
    {"id": "b", "names": {"default": "B"}, "tags": ["x"], "embeddings": {"gpu": []}},
    {"id": "c", "names": {"default": "C"}, "version": 1},
])
def test_profile_migration_matches_jax(obj, speakers_dir):
    assert migrations.migrate_profile(dict(obj)) == jmig.migrate_profile(dict(obj))
    assert migrations.PROFILE_SCHEMA_VERSION == jmig.PROFILE_SCHEMA_VERSION
    # an old profile on disk is migrated and saved on load
    config.ensure_layout()
    (speakers_dir / "db" / f"{obj['id']}.json").write_text(json.dumps(obj))
    assert profiles.load_speaker(obj["id"])["version"] == migrations.PROFILE_SCHEMA_VERSION
    assert jprof.load_speaker(obj["id"], auto_migrate=False)["version"] == 1


def _vector(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(192).astype(np.float32)


def _write_store(P, S, audio: Path, b3: str) -> None:
    """Three speakers, four embedding records, one invalidated, and sample
    metadata that reviews one source recording — through package P / S."""
    P.save_speaker(P.create_speaker_profile("alice", "Alice", tags=["team", "x"],
                                            nicknames=["al"], metadata={"k": "v"}))
    P.save_speaker(P.create_speaker_profile("bob", "Bob", name_contexts={"work": "Robert"}))
    P.save_speaker(P.create_speaker_profile("carol", "Carol"))
    sdir = S.speaker_samples_dir("alice")
    sdir.mkdir(parents=True, exist_ok=True)
    for i, status in enumerate(("reviewed", "reviewed", "pending")):
        jsamples.write_metadata(sdir / f"sample-00{i + 1}.meta.yaml", f"sample-00{i + 1}",
                                f"{i:032x}", audio, b3, None,
                                {"start": float(i), "end": i + 1.0}, "S1")
        if status != "pending":
            jsamples.set_review_status("alice", f"sample-00{i + 1}", status=status)
    segs = [{"start": 0.0, "end": 1.0}]
    P.enroll_embedding("alice", "gpu", _vector(0), audio, b3, segs, "gpu-c512-v1")
    P.enroll_embedding("alice", "gpu", _vector(1), audio, "f" * 32, segs, "gpu-c512-v1")
    P.enroll_embedding("bob", "gpu", _vector(2), audio, "e" * 32, segs, "gpu-c512-v1")
    carol = P.load_speaker("carol")
    P.add_embedding(carol, "gpu", P.create_embedding_record(
        audio, "d" * 32, segs, "gpu-c512-v1", trust_level="invalidated", vector=_vector(3)))
    P.save_speaker(carol)


def _matrix_view(P, **kw):
    pm = P.ProfileMatrix.build("gpu", **kw)
    return pm.matrix, pm.rows


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_written_by_one_package_read_by_the_other(speakers_dir, tmp_path, writer):
    audio = make_wav(tmp_path / "src.wav", seconds=0.5, seed=1)
    b3 = hashing.compute_b3sum(audio)
    w, r = (jprof, profiles) if writer == "jax" else (profiles, jprof)
    _write_store(w, jsamples if writer == "jax" else samples, audio, b3)

    assert [s["id"] for s in r.list_all_speakers()] == ["alice", "bob", "carol"]
    assert r.list_all_speakers() == w.list_all_speakers()
    for sid in ("alice", "bob", "carol"):
        assert r.load_speaker(sid) == w.load_speaker(sid)
    # trust from the sample store: two reviewed samples and one pending
    alice = r.load_speaker("alice")["embeddings"]["gpu"]
    assert [e["trust_level"] for e in alice] == ["medium", "low"]
    assert samples.get_samples_by_source_audio("alice", b3) == \
        jsamples.get_samples_by_source_audio("alice", b3)
    assert samples.get_speaker_samples("alice") == jsamples.get_speaker_samples("alice")
    for rec in alice:
        assert profiles.check_embedding_validity("alice", rec) == \
            jprof.check_embedding_validity("alice", rec)

    for kw in ({}, {"include_invalidated": True}, {"min_trust": "high"}):
        gm, grows = _matrix_view(profiles, **kw)
        wm, wrows = _matrix_view(jprof, **kw)
        assert grows == wrows
        np.testing.assert_array_equal(gm, wm)
    gm, grows = _matrix_view(profiles)
    assert [row["speaker_id"] for row in grows] == ["alice", "alice", "bob"]
    np.testing.assert_allclose(np.linalg.norm(gm, axis=1), 1.0, rtol=0, atol=1e-6)


def test_same_profile_same_bytes(tmp_path, monkeypatch):
    """With the clock and the record ids pinned, both packages write the
    same profile JSON and vector file, byte for byte."""
    audio = make_wav(tmp_path / "src.wav", seconds=0.5, seed=2)
    files = {}
    for name, P in (("jax", jprof), ("port", profiles)):
        root = tmp_path / name
        monkeypatch.setenv("SPEAKERS_EMBEDDINGS_DIR", str(root))
        monkeypatch.setattr(P, "utc_now_iso", lambda: "2026-01-02T03:04:05+00:00")
        monkeypatch.setattr(P, "new_embedding_id", lambda: "emb-0000abcd")
        P.save_speaker(P.create_speaker_profile("dana", "Dana", tags=["b", "a"],
                                                description="d ü"))
        P.enroll_embedding("dana", "gpu", _vector(5), audio, "c" * 32,
                           [{"start": 0.0, "end": 0.5}], "gpu-c512-v1")
        files[name] = {p.relative_to(root): p.read_bytes()
                       for p in sorted(root.rglob("*")) if p.is_file()}
    assert files["jax"].keys() == files["port"].keys() and files["jax"]
    for rel, data in files["jax"].items():
        assert files["port"][rel] == data, rel


def test_trust_levels_and_validity_match_jax(speakers_dir, tmp_path):
    cases = [{}, {"reviewed": ["a"]}, {"reviewed": ["a"], "unreviewed": ["b"]},
             {"unreviewed": ["b"]}, {"rejected": ["c"], "reviewed": ["a"]}]
    for s in cases:
        assert profiles.compute_trust_level(s) == jprof.compute_trust_level(s)
    audio = make_wav(tmp_path / "src.wav", seconds=0.5, seed=4)
    b3 = hashing.compute_b3sum(audio)
    _write_store(profiles, samples, audio, b3)
    jsamples.set_review_status("alice", "sample-003", status="rejected")
    got = profiles.refresh_trust_levels("alice", save=False)
    want = jprof.refresh_trust_levels("alice", save=False)
    assert got == want and got[0]["new_trust"] == "invalidated"
    assert profiles.delete_speaker("bob") and not profiles.load_speaker("bob")
    assert len(list((speakers_dir / "embeddings").glob("*.npy"))) == 3
