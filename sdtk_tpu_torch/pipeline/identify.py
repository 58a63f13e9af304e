"""Enroll / identify / verify against the profile store, on the GPU.

The counterpart of ``sdtk_tpu/pipeline/identify.py``: same semantics and
output rows.  Each entry point takes the backend by name (default
$SPEAKER_DETECTION_BACKEND, else ``gpu``) and the device its scoring and
embedding run on (default CUDA; ``device="cpu"`` runs the plain
versions).  Transcript-driven segments are not ported yet.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Any

from .. import config
from ..backends.base import DEFAULT_THRESHOLD, LocalEmbeddingBackend, get_backend
from ..store import profiles as P
from ..utils.device import resolve_device
from ..utils.hashing import compute_b3sum


def _backend(name: str | None, device) -> LocalEmbeddingBackend:
    return get_backend(name, device=str(resolve_device(device)))


def resolve_segments(segments: list[tuple[float, float]] | None = None,
                     transcript: str | Path | None = None,
                     speaker_label: str | None = None) -> list[tuple[float, float]] | None:
    """Segment source priority: explicit list > transcript+label > whole file."""
    if segments:
        return list(segments)
    if transcript and speaker_label:
        raise NotImplementedError("segments from a transcript need the transcripts module, "
                                  "which the port does not have yet; pass segments")
    return None


def enroll(speaker_id: str, audio_path: str | Path, backend_name: str | None = None,
           segments: list[tuple[float, float]] | None = None,
           transcript: str | Path | None = None, speaker_label: str | None = None,
           create_missing: bool = False, name: str | None = None,
           device: str | None = None) -> dict[str, Any]:
    """Enroll a speaker from (segments of) a recording; returns the new
    embedding record."""
    speaker_id = P.normalize_speaker_id(speaker_id)
    profile = P.load_speaker(speaker_id)
    if profile is None:
        if not create_missing:
            raise KeyError(f"speaker '{speaker_id}' not found (use create first)")
        P.save_speaker(P.create_speaker_profile(speaker_id, name or speaker_id))

    backend = _backend(backend_name, device)
    segs = resolve_segments(segments, transcript, speaker_label)
    result = backend.enroll_speaker(audio_path, segs)

    b3 = compute_b3sum(audio_path)
    rec = P.create_embedding_record(
        source_audio=str(Path(audio_path).resolve()),
        source_audio_b3sum=b3,
        source_segments=[{"start": s, "end": e} for s, e in (segs or [])],
        model_version=result.get("model_version", backend.model_version),
        samples=P.get_samples_by_source_audio(speaker_id, b3),
        external_id=result.get("external_id"),
        vector=result.get("vector"),
        all_identifiers=result.get("all_identifiers"),
    )
    profile = P.load_speaker(speaker_id)
    P.add_embedding(profile, backend.name, rec)
    P.save_speaker(profile)
    return rec


_TRUST_ORDER = {"high": 3, "medium": 2, "low": 1, "unknown": 0, "invalidated": -1}


def identify(audio_path: str | Path, backend_name: str | None = None,
             threshold: float = DEFAULT_THRESHOLD, tags: list[str] | None = None,
             segments: list[tuple[float, float]] | None = None,
             device: str | None = None) -> list[dict[str, Any]]:
    """Identify speaker(s) in audio against all enrolled profiles.  Rows:
    speaker_id, name, score, confidence, trust_level, embedding_id,
    backend; best first."""
    if not Path(audio_path).exists():
        raise FileNotFoundError(f"audio file not found: {audio_path}")
    backend = _backend(backend_name, device)
    speakers = P.list_all_speakers()
    if tags:
        speakers = P.filter_speakers_by_tags(speakers, tags, any_tag=False)
    candidates = [s for s in speakers if s.get("embeddings", {}).get(backend.name)]
    if not candidates:
        return []

    results = backend.identify_speaker(audio_path, candidates, threshold, segments)
    if config.debug_enabled():
        print("[SPEAKER_DETECTION_DEBUG] identify "
              f"backend={backend.name} candidates={len(candidates)} threshold={threshold}\n"
              + json.dumps(results, indent=2, default=str), file=sys.stderr)

    by_id = {s["id"]: s for s in candidates}
    out = []
    for r in results:
        profile = by_id.get(r["speaker_id"])
        confidence = r.get("confidence", r.get("similarity", 0.0))
        emb_id = r.get("embedding_id")
        trust = "unknown"
        if profile:
            records = profile.get("embeddings", {}).get(backend.name, [])
            if emb_id:
                trust = next((rec.get("trust_level", "unknown") for rec in records
                              if rec.get("id") == emb_id), "unknown")
            elif records:  # no embedding id from the backend: best trust
                best = max(records,
                           key=lambda e: _TRUST_ORDER.get(e.get("trust_level", "unknown"), 0))
                trust = best.get("trust_level", "unknown")
                emb_id = best.get("id")
        out.append({
            "speaker_id": r["speaker_id"],
            "name": profile["names"]["default"] if profile else r["speaker_id"],
            "score": confidence,
            "confidence": confidence,
            "trust_level": trust,
            "embedding_id": emb_id,
            "backend": backend.name,
        })
    return out


def verify(speaker_id: str, audio_path: str | Path, backend_name: str | None = None,
           threshold: float = DEFAULT_THRESHOLD,
           segments: list[tuple[float, float]] | None = None,
           device: str | None = None) -> dict[str, Any]:
    """Verify audio against one speaker; {match: bool, confidence: float}."""
    if not Path(audio_path).exists():
        raise FileNotFoundError(f"audio file not found: {audio_path}")
    speaker_id = P.normalize_speaker_id(speaker_id)
    profile = P.load_speaker(speaker_id)
    if profile is None:
        raise KeyError(f"speaker '{speaker_id}' not found")
    backend = _backend(backend_name, device)
    if not profile.get("embeddings", {}).get(backend.name):
        raise ValueError(f"speaker '{speaker_id}' has no {backend.name} embeddings")
    return backend.verify_speaker(audio_path, profile, threshold, segments)
