"""Multi-signal speaker assignment: label → profile fusion on the GPU.

The counterpart of ``sdtk_tpu/pipeline/assign.py``: the same signal
weights, trust multipliers, confidence thresholds, combination math,
method string and output, so the assignment files of both packages
compare.  The embedding signal is one ``pipeline.identify`` per
transcript label on that label's own segments, on ``device`` (default
CUDA): the log-mel kernel in every embedding, then the cosine kernel
(dense route) or the fused top-k kernel (large N) for the scores.

The collectors keep the JAX package's graceful degradation (a failing
identify leaves the label without that signal) for every failure except
:data:`~sdtk_tpu_torch.utils.device.DEVICE_ERRORS`: a kernel that does not
build or launch, or a CUDA error, propagates, so a run on the card never
ends in context-only assignments that hide a dead kernel.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from ..store import assignments as assignment_store
from ..store import catalog as catalog_store
from ..transcripts import get_available_speakers, get_speaker_segments, load_transcript
from ..utils.device import DEVICE_ERRORS, resolve_device
from ..utils.hashing import compute_b3sum
from . import identify as identify_engine

VERSION = "1.0.0"

SIGNAL_WEIGHTS = {
    "embedding_match": 0.4,
    "llm_name_detection": 0.3,
    "context_expected": 0.2,
    "cross_backend_agreement": 0.1,
}

TRUST_MULTIPLIERS = {
    "high": 1.0,
    "medium": 0.7,
    "low": 0.4,
    "invalidated": 0.0,
    "unknown": 0.5,
}

CONFIDENCE_THRESHOLDS = {"high": 0.7, "medium": 0.4, "low": 0.2}


@dataclass
class Signal:
    type: str
    speaker_id: str | None
    score: float
    evidence: dict = field(default_factory=dict)


@dataclass
class Assignment:
    speaker_label: str
    speaker_id: str | None
    confidence: str  # confirmed, high, medium, low, unassigned
    score: float
    signals: list[dict]
    candidates: list[dict] = field(default_factory=list)


def collect_embedding_signals(
    speaker_label: str,
    segments: list[dict],
    audio_path: Path,
    min_trust: str = "low",
    tags: list[str] | None = None,
    backend: str | None = None,
    device: str | None = None,
) -> list[Signal]:
    """Embedding matches for this label's own audio segments
    (reference speaker-assign:262-328, minus the subprocess)."""
    seg_tuples = [(s["start"], s["end"]) for s in segments] or None
    try:
        matches = identify_engine.identify(
            audio_path, backend_name=backend, tags=tags, segments=seg_tuples, device=device
        )
    except DEVICE_ERRORS:
        raise
    except Exception:
        return []  # graceful degradation (reference :325-326)

    signals = []
    trust_order = ["low", "medium", "high"]
    for match in matches:
        if not match.get("speaker_id"):
            continue
        trust = match.get("trust_level", "unknown")
        if min_trust in trust_order and trust in trust_order:
            if trust_order.index(trust) < trust_order.index(min_trust):
                continue
        signals.append(
            Signal(
                type="embedding_match",
                speaker_id=match["speaker_id"],
                score=match.get("score", 0.5),
                evidence={
                    "embedding_id": match.get("embedding_id"),
                    "trust_level": trust,
                    "backend": match.get("backend"),
                },
            )
        )
    return signals


def collect_cross_backend_signals(
    speaker_label: str,
    segments: list[dict],
    audio_path: Path,
    primary_matches: list[Signal],
    cross_backends: list[str],
    min_trust: str = "low",
    device: str | None = None,
) -> list[Signal]:
    """Cross-backend agreement: the reference DECLARES this signal type
    (weight 0.1, speaker-assign:53) but never emits it — its only compute
    backend was the cloud.  This framework has several local backends, so
    agreement is real: when a secondary backend's top match for the same
    segments names a speaker the primary also matched, emit the signal."""
    primary_ids = {s.speaker_id for s in primary_matches if s.speaker_id}
    if not primary_ids or not cross_backends:
        return []
    seg_tuples = [(s["start"], s["end"]) for s in segments] or None
    signals = []
    for backend_name in cross_backends:
        try:
            matches = identify_engine.identify(
                audio_path, backend_name=backend_name, segments=seg_tuples, device=device
            )
        except DEVICE_ERRORS:
            raise
        except Exception:
            continue  # graceful degradation, same as the other collectors
        if not matches:
            continue
        top = matches[0]
        if top.get("speaker_id") in primary_ids:
            signals.append(
                Signal(
                    type="cross_backend_agreement",
                    speaker_id=top["speaker_id"],
                    score=top.get("score", 0.5),
                    evidence={"backend": backend_name,
                              "agrees_with_primary": True},
                )
            )
    return signals


def collect_context_signals(
    speaker_label: str, context_name: str | None, expected_speakers: list[str]
) -> list[Signal]:
    """Flat 0.5-score signal per expected speaker (reference :331-353)."""
    return [
        Signal(
            type="context_expected",
            speaker_id=sid,
            score=0.5,
            evidence={"context": context_name, "reason": "in expected_speakers list"},
        )
        for sid in expected_speakers
    ]


def collect_llm_signals(
    speaker_label: str,
    transcript_path: Path,
    context_name: str | None = None,
) -> list[Signal]:
    """LLM name-detection signal (reference :356-400); tolerates the LLM
    layer being unavailable."""
    try:
        from .llm import ProviderUnavailableError, analyze_transcript

        try:
            analysis = analyze_transcript(transcript_path, context=context_name)
        except ProviderUnavailableError:
            # no cloud/local LLM configured → offline regex provider, so
            # the signal still fires air-gapped (capability beyond the
            # reference, which just drops the signal)
            analysis = analyze_transcript(
                transcript_path, provider="pattern", context=context_name
            )
    except Exception:
        return []
    signals = []
    for det in analysis.get("detections", []):
        if det.get("speaker_label") != speaker_label:
            continue
        name = det.get("detected_name")
        if not name:
            continue
        signals.append(
            Signal(
                type="llm_name_detection",
                speaker_id=name.lower().replace(" ", "-"),
                score=det.get("confidence", 0.5),
                evidence={
                    "detected_name": name,
                    "evidence": det.get("evidence", []),
                },
            )
        )
    return signals


def combine_signals(
    speaker_label: str, signals: list[Signal], threshold: float = 0.5
) -> Assignment:
    """Weighted fusion (reference :418-492, same math)."""
    scores: dict[str, float] = defaultdict(float)
    evidence: dict[str, list] = defaultdict(list)

    for signal in signals:
        if signal.speaker_id is None:
            continue
        weight = SIGNAL_WEIGHTS.get(signal.type, 0.1)
        if signal.type == "embedding_match":
            trust = signal.evidence.get("trust_level", "unknown")
            weight *= TRUST_MULTIPLIERS.get(trust, 0.5)
        scores[signal.speaker_id] += weight * signal.score
        evidence[signal.speaker_id].append(
            {"type": signal.type, "score": signal.score, **signal.evidence}
        )

    if not scores:
        return Assignment(speaker_label, None, "unassigned", 0.0, [], [])

    ranked = sorted(scores.items(), key=lambda x: x[1], reverse=True)
    best_id, best_score = ranked[0]

    if best_score >= CONFIDENCE_THRESHOLDS["high"]:
        confidence = "high"
    elif best_score >= CONFIDENCE_THRESHOLDS["medium"]:
        confidence = "medium"
    elif best_score >= CONFIDENCE_THRESHOLDS["low"]:
        confidence = "low"
    else:
        confidence = "unassigned"

    if best_score < threshold:
        return Assignment(
            speaker_label, None, "unassigned", best_score,
            evidence.get(best_id, []),
            [{"speaker_id": sid, "score": sc} for sid, sc in ranked[:3]],
        )
    return Assignment(
        speaker_label, best_id, confidence, best_score,
        evidence.get(best_id, []),
        [{"speaker_id": sid, "score": sc} for sid, sc in ranked[1:4]],
    )


def assign(
    audio_path: str | Path,
    transcript_path: str | Path,
    use_embeddings: bool = True,
    use_llm: bool = False,
    context: str | None = None,
    expected_speakers: list[str] | None = None,
    min_trust: str = "low",
    threshold: float = 0.5,
    tags: list[str] | None = None,
    backend: str | None = None,
    cross_backends: list[str] | None = None,
    save: bool = True,
    verbose: bool = False,
    quiet: bool = False,
    device: str | None = None,
) -> dict[str, Any]:
    """Full assignment flow (reference cmd_assign :499-649): parse labels,
    pull context from the catalog, fuse signals per label, write
    assignments/{b3sum}.yaml.  verbose/quiet reproduce the reference's
    stdout progress lines (:524,:549).  ``device`` is where identify
    embeds and scores (default CUDA; raises here without it)."""
    device = str(resolve_device(device))
    audio_path = Path(audio_path).resolve()
    transcript_path = Path(transcript_path).resolve()
    transcript_data = load_transcript(transcript_path)
    labels = get_available_speakers(transcript_data)
    if not labels:
        raise ValueError("No speakers found in transcript")
    if not quiet:
        print(f"Found {len(labels)} speakers: {', '.join(labels)}")

    b3sum = compute_b3sum(audio_path)
    entry = catalog_store.load_entry(b3sum)
    context_name = context
    expected = list(expected_speakers or [])
    if entry:
        ctx = entry.get("context", {})
        if not context_name:
            context_name = ctx.get("name")
        if not expected:
            expected = list(ctx.get("expected_speakers", []))

    mappings: dict[str, Any] = {}
    for label in labels:
        segments = get_speaker_segments(transcript_data, label)
        if verbose:
            print(f"\nProcessing speaker {label} ({len(segments)} segments)...")
        signals: list[Signal] = []
        if use_embeddings:
            emb_signals = collect_embedding_signals(
                label, segments, audio_path, min_trust, tags, backend, device
            )
            signals.extend(emb_signals)
            if cross_backends:
                signals.extend(
                    collect_cross_backend_signals(
                        label, segments, audio_path, emb_signals,
                        cross_backends, min_trust, device,
                    )
                )
        if expected:
            signals.extend(collect_context_signals(label, context_name, expected))
        if use_llm:
            signals.extend(collect_llm_signals(label, transcript_path, context_name))

        a = combine_signals(label, signals, threshold)
        mappings[label] = {
            "speaker_id": a.speaker_id,
            "confidence": a.confidence,
            "score": round(a.score, 3),
            "signals": a.signals,
        }
        if a.candidates:
            mappings[label]["candidates"] = a.candidates

    if save:
        return assignment_store.save_assignments(
            b3sum,
            transcript_path,
            mappings,
            method=f"speaker-assign-v{VERSION}",
            context=context_name,
            min_trust=min_trust,
            threshold=threshold,
        )
    return {
        "schema_version": assignment_store.SCHEMA_VERSION,
        "recording_b3sum": b3sum,
        "transcript_path": str(transcript_path),
        "method": f"speaker-assign-v{VERSION}",
        "context": context_name,
        "min_trust": min_trust,
        "threshold": threshold,
        "mappings": mappings,
    }
