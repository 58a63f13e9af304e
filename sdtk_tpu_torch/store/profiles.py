"""Speaker profile + embedding-record CRUD, trust computation.

A copy of ``sdtk_tpu/store/profiles.py``: the files it writes are the JAX
package's byte for byte (``db/{id}.json`` through the same JSON dump,
``embeddings/{emb-id}.npy`` through ``np.save``), so either package reads
a store the other wrote.  Embedding records carry a local dense vector
(``vector_file``); ``external_id`` is kept for cloud backends.
"""

from __future__ import annotations

import re
import uuid
from datetime import datetime, timezone
from pathlib import Path
from typing import Any

import numpy as np

from .. import config
from ..utils.ioutil import load_json, save_json
from .migrations import PROFILE_SCHEMA_VERSION, migrate_profile
from .samples import get_samples_by_source_audio, get_speaker_samples


def utc_now_iso() -> str:
    return datetime.now(timezone.utc).isoformat()


# ---------------------------------------------------------------------------
# Profile schema
# ---------------------------------------------------------------------------


def create_speaker_profile(
    speaker_id: str,
    name: str,
    name_contexts: dict[str, str] | None = None,
    nicknames: list[str] | None = None,
    description: str | None = None,
    metadata: dict[str, Any] | None = None,
    tags: list[str] | None = None,
) -> dict[str, Any]:
    """New profile with defaults (reference speaker_detection:110-137)."""
    now = utc_now_iso()
    names = {"default": name}
    if name_contexts:
        names.update(name_contexts)
    return {
        "id": speaker_id,
        "version": PROFILE_SCHEMA_VERSION,
        "names": names,
        "nicknames": nicknames or [],
        "description": description or "",
        "metadata": metadata or {},
        "tags": sorted(set(tags)) if tags else [],
        "embeddings": {},
        "created_at": now,
        "updated_at": now,
    }


def validate_speaker_id(speaker_id: str) -> bool:
    return bool(re.match(r"^[a-z0-9][a-z0-9_-]*$", speaker_id))


def normalize_speaker_id(speaker_id: str) -> str:
    return speaker_id.lower().replace(" ", "-")


# ---------------------------------------------------------------------------
# Storage
# ---------------------------------------------------------------------------


def get_speaker_path(speaker_id: str) -> Path:
    return config.db_dir() / f"{speaker_id}.json"


def load_speaker(speaker_id: str, auto_migrate: bool = True) -> dict[str, Any] | None:
    path = get_speaker_path(speaker_id)
    if not path.exists():
        return None
    profile = load_json(path)
    if auto_migrate and profile.get("version", 0) < PROFILE_SCHEMA_VERSION:
        profile = migrate_profile(profile)
        save_speaker(profile)
    return profile


def save_speaker(profile: dict[str, Any]) -> None:
    config.ensure_layout()
    profile["updated_at"] = utc_now_iso()
    save_json(get_speaker_path(profile["id"]), profile)


def delete_speaker(speaker_id: str, delete_vectors: bool = True) -> bool:
    path = get_speaker_path(speaker_id)
    if not path.exists():
        return False
    if delete_vectors:
        profile = load_json(path)
        for records in profile.get("embeddings", {}).values():
            for rec in records:
                vf = rec.get("vector_file")
                if vf:
                    vec_path = config.embeddings_dir() / vf
                    if vec_path.exists():
                        vec_path.unlink()
    path.unlink()
    return True


def list_all_speakers() -> list[dict[str, Any]]:
    db = config.db_dir()
    if not db.exists():
        return []
    speakers = []
    for path in sorted(db.glob("*.json")):
        try:
            speakers.append(load_json(path))
        except Exception:
            continue
    return speakers


def filter_speakers_by_tags(
    speakers: list[dict[str, Any]],
    tags: list[str] | None = None,
    any_tag: bool = False,
) -> list[dict[str, Any]]:
    """AND (default) or OR tag filter (reference speaker_detection:223-246)."""
    if not tags:
        return speakers
    tag_set = set(tags)
    out = []
    for s in speakers:
        s_tags = set(s.get("tags", []))
        if any_tag:
            if s_tags & tag_set:
                out.append(s)
        elif tag_set <= s_tags:
            out.append(s)
    return out


# ---------------------------------------------------------------------------
# Embedding records + dense vectors
# ---------------------------------------------------------------------------


def new_embedding_id() -> str:
    return f"emb-{uuid.uuid4().hex[:8]}"


def save_vector(emb_id: str, vector: np.ndarray) -> str:
    """Persist a dense embedding vector; returns the vector_file name."""
    config.ensure_layout()
    fname = f"{emb_id}.npy"
    path = config.embeddings_dir() / fname
    np.save(path, np.asarray(vector, dtype=np.float32))
    return fname


def load_vector(record: dict[str, Any]) -> np.ndarray | None:
    vf = record.get("vector_file")
    if not vf:
        return None
    path = config.embeddings_dir() / vf
    if not path.exists():
        return None
    return np.load(path)


def create_embedding_record(
    source_audio: str | Path,
    source_audio_b3sum: str,
    source_segments: list[dict[str, float]],
    model_version: str,
    samples: dict[str, list[str]] | None = None,
    trust_level: str | None = None,
    external_id: str | None = None,
    vector: np.ndarray | None = None,
    all_identifiers: list[str] | None = None,
) -> dict[str, Any]:
    """Embedding record (reference speaker_detection:890-904 schema)."""
    emb_id = new_embedding_id()
    samples = samples or {"reviewed": [], "unreviewed": [], "rejected": []}
    rec: dict[str, Any] = {
        "id": emb_id,
        "external_id": external_id,
        "source_audio": str(source_audio),
        "source_audio_b3sum": source_audio_b3sum,
        "source_segments": source_segments,
        "model_version": model_version,
        "samples": samples,
        # stored records keep the reference's enroll-time floor of "low"
        # (speaker_detection:379: no samples -> low); "unknown" is only the
        # pure-function answer for the empty case (acceptance contract).
        "trust_level": trust_level
        or compute_trust_level(samples).replace("unknown", "low"),
        "created_at": utc_now_iso(),
    }
    if all_identifiers is not None:
        rec["all_identifiers"] = all_identifiers
    if vector is not None:
        rec["vector_file"] = save_vector(emb_id, vector)
    return rec


def add_embedding(profile: dict[str, Any], backend: str, record: dict[str, Any]) -> None:
    profile.setdefault("embeddings", {}).setdefault(backend, []).append(record)


# ---------------------------------------------------------------------------
# Trust levels (reference speaker_detection:310-379)
# ---------------------------------------------------------------------------


def compute_trust_level(samples: dict[str, list[str]]) -> str:
    """high: all reviewed; medium: mixed; low: all unreviewed;
    invalidated: any rejected; unknown: no samples at all.

    (The reference *implementation* folds no-samples into "low"
    (speaker_detection:359-379) but its own acceptance suite
    test_samples_and_trust.py pins "unknown" for the empty case; the
    tests are the contract.)"""
    reviewed = samples.get("reviewed", [])
    unreviewed = samples.get("unreviewed", [])
    rejected = samples.get("rejected", [])
    if rejected:
        return "invalidated"
    if reviewed and not unreviewed:
        return "high"
    if reviewed:
        return "medium"
    if unreviewed:
        return "low"
    return "unknown"


def check_embedding_validity(speaker_id: str, emb: dict[str, Any]) -> dict[str, Any]:
    """Recompute an embedding's trust from current sample review states
    (reference speaker_detection:1181-1247)."""
    emb_id = emb.get("id", "unknown")
    old_trust = emb.get("trust_level", "unknown")
    stored = emb.get("samples", {}) or {}
    all_hashes = set(
        stored.get("reviewed", []) + stored.get("unreviewed", []) + stored.get("rejected", [])
    )

    current_states = {}
    source_b3 = emb.get("source_audio_b3sum")
    for sample in get_speaker_samples(speaker_id):
        b3 = sample.get("b3sum")
        if not b3:
            continue
        current_states[b3] = sample.get("review", {}).get("status", "pending")
        # Samples extracted later from the same source recording attach to
        # this embedding (the approve→extract→trust-bump loop; the
        # reference re-derives this set at enroll time only).
        if source_b3 and sample.get("source", {}).get("audio_b3sum") == source_b3:
            all_hashes.add(b3)

    if not all_hashes:
        return {
            "id": emb_id,
            "old_trust": old_trust,
            "new_trust": "unknown",
            "changed": False,
            "newly_rejected": [],
        }

    new_samples: dict[str, list[str]] = {"reviewed": [], "unreviewed": [], "rejected": []}
    newly_rejected = []
    for h in sorted(all_hashes):
        status = current_states.get(h, "pending")
        if status == "reviewed":
            new_samples["reviewed"].append(h)
        elif status == "rejected":
            new_samples["rejected"].append(h)
            if h not in stored.get("rejected", []):
                newly_rejected.append(h)
        else:
            new_samples["unreviewed"].append(h)

    new_trust = compute_trust_level(new_samples)
    return {
        "id": emb_id,
        "old_trust": old_trust,
        "new_trust": new_trust,
        "changed": old_trust != new_trust,
        "newly_rejected": newly_rejected,
        "samples": new_samples,
    }


def refresh_trust_levels(speaker_id: str, save: bool = True) -> list[dict[str, Any]]:
    """Apply check_embedding_validity to every embedding of a speaker."""
    profile = load_speaker(speaker_id)
    if not profile:
        return []
    results = []
    changed_any = False
    for backend, records in profile.get("embeddings", {}).items():
        for rec in records:
            res = check_embedding_validity(speaker_id, rec)
            res["backend"] = backend
            results.append(res)
            if res["changed"] and res["new_trust"] != "unknown":
                rec["trust_level"] = res["new_trust"]
                rec["samples"] = res["samples"]
                changed_any = True
    if save and changed_any:
        save_speaker(profile)
    return results


def enroll_embedding(
    speaker_id: str,
    backend: str,
    vector: np.ndarray,
    source_audio: str | Path,
    source_audio_b3sum: str,
    source_segments: list[dict[str, float]],
    model_version: str,
    external_id: str | None = None,
) -> dict[str, Any]:
    """Append a new embedding record to a profile, wiring trust from the
    sample DB (the storage half of reference cmd_enroll :754-919)."""
    profile = load_speaker(speaker_id)
    if profile is None:
        raise KeyError(f"speaker '{speaker_id}' not found")
    samples = get_samples_by_source_audio(speaker_id, source_audio_b3sum)
    rec = create_embedding_record(
        source_audio=source_audio,
        source_audio_b3sum=source_audio_b3sum,
        source_segments=source_segments,
        model_version=model_version,
        samples=samples,
        vector=vector,
        external_id=external_id,
    )
    add_embedding(profile, backend, rec)
    save_speaker(profile)
    return rec


# ---------------------------------------------------------------------------
# Batched profile matrix — the device hot-path view of the DB
# ---------------------------------------------------------------------------


class ProfileMatrix:
    """All enrolled vectors of a backend stacked into one (N, D) float32
    matrix plus row metadata.

    The identify path scores query windows against it in one pass on the
    device (``ops/cosine.py``, ``ops/topk.py``).
    """

    def __init__(self, matrix: np.ndarray, rows: list[dict[str, Any]]):
        self.matrix = matrix  # (N, D) L2-normalized float32
        self.rows = rows  # per-row: speaker_id, embedding_id, trust_level

    @classmethod
    def build(
        cls,
        backend: str,
        speakers: list[dict[str, Any]] | None = None,
        min_trust: str | None = None,
        include_invalidated: bool = False,
    ) -> "ProfileMatrix":
        trust_rank = {"invalidated": -1, "unknown": 0, "low": 1, "medium": 2, "high": 3}
        min_rank = trust_rank.get(min_trust or "", None)
        vectors: list[np.ndarray] = []
        rows: list[dict[str, Any]] = []
        for profile in speakers if speakers is not None else list_all_speakers():
            for rec in profile.get("embeddings", {}).get(backend, []):
                trust = rec.get("trust_level", "unknown")
                if trust == "invalidated" and not include_invalidated:
                    continue
                if min_rank is not None and trust_rank.get(trust, 0) < min_rank:
                    continue
                vec = load_vector(rec)
                if vec is None:
                    continue
                vectors.append(np.asarray(vec, dtype=np.float32).ravel())
                rows.append(
                    {
                        "speaker_id": profile["id"],
                        "embedding_id": rec["id"],
                        "trust_level": trust,
                    }
                )
        if not vectors:
            return cls(np.zeros((0, 0), dtype=np.float32), [])
        mat = np.stack(vectors)
        norms = np.linalg.norm(mat, axis=1, keepdims=True)
        mat = mat / np.maximum(norms, 1e-12)
        return cls(mat, rows)

    def __len__(self) -> int:
        return len(self.rows)
