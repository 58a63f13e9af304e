"""Health metrics + recommendations — the observability subsystem.

A copy of ``sdtk_tpu/pipeline/report.py`` (the same rows, statistics,
recommendations and formatted output).

Mirrors reference ``speaker-report`` (loaders :221-337, stats :344-412,
recommendations :415-462, formatters :469-853) including its exact text
and JSON output contract (pinned by the reference acceptance suite
``test_speaker_report.py``).

Profile loading reads **both** profile tiers:

- ``db/*.json`` — the profiles this framework (and the reference's
  ``speaker_detection``) actually writes; trust/sample stats are derived
  from embedding records and the sample store.
- ``db/*.yaml`` — the flat report-schema profiles the reference's
  ``speaker-report`` reads (speaker-report:283; a reference-internal
  inconsistency its acceptance tests bake in: speaker_id / display_name /
  trust_level / samples[{reviewed}]).
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict
from dataclasses import dataclass, field
from datetime import datetime, timezone
from pathlib import Path
from typing import Any

from .. import config
from ..store import catalog as catalog_store
from ..utils.ioutil import load_yaml

CONFIDENCE_MAP = {"high": 90, "medium": 70, "low": 40, "unassigned": 0}
DEFAULT_CONFIDENCE_THRESHOLD = 70
STALE_DAYS = 30
MIN_REVIEWED_SAMPLES = 3
TRUST_LEVELS = ["high", "medium", "low", "unverified"]
# kept for callers that used the old name
LOW_CONFIDENCE_CUTOFF = DEFAULT_CONFIDENCE_THRESHOLD


@dataclass
class CatalogRow:
    b3sum: str
    path: str
    status: str
    context_name: str | None
    expected_speakers: list[str]
    transcriptions: list[Any]
    review_status: str
    updated_at: str


@dataclass
class ProfileRow:
    speaker_id: str
    display_name: str | None
    trust_level: str
    sample_count: int
    embedding_count: int
    reviewed_samples: int
    last_updated: str | None


@dataclass
class AssignmentRow:
    b3sum: str
    mappings: dict[str, Any]


@dataclass
class SystemStats:
    total_recordings: int = 0
    processed: int = 0
    reviewed: int = 0
    pending: int = 0
    total_speakers: int = 0
    high_trust: int = 0
    medium_trust: int = 0
    low_trust: int = 0
    unverified: int = 0
    total_contexts: int = 0
    contexts: dict[str, dict[str, int]] = field(default_factory=dict)
    low_confidence_count: int = 0
    speakers_needing_samples: list[str] = field(default_factory=list)
    stale_recordings: int = 0
    recommendations: list[str] = field(default_factory=list)


def _days_since(iso_str: str | None) -> int | None:
    if not iso_str:
        return None
    try:
        dt = datetime.fromisoformat(iso_str.replace("Z", "+00:00"))
    except ValueError:
        return None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return (datetime.now(timezone.utc) - dt).days


# ---------------------------------------------------------------------------
# Loaders (tolerant: malformed files warn to stderr and are skipped,
# reference speaker-report:251-252)
# ---------------------------------------------------------------------------


def load_catalog_rows() -> list[CatalogRow]:
    rows: list[CatalogRow] = []
    cdir = config.catalog_dir()
    if not cdir.exists():
        return rows
    for f in sorted(cdir.glob("*.yaml")):
        try:
            data = load_yaml(f)
            if not isinstance(data, dict):
                raise ValueError("not a mapping")
            recording = data.get("recording", {})
            rows.append(
                CatalogRow(
                    b3sum=f.stem,
                    path=recording.get("path", ""),
                    status=catalog_store.compute_status(data),
                    context_name=data.get("context", {}).get("name"),
                    expected_speakers=data.get("context", {}).get("expected_speakers", []),
                    transcriptions=data.get("transcriptions", []),
                    review_status=data.get("review", {}).get("status", "none"),
                    updated_at=data.get("updated_at", ""),
                )
            )
        except Exception as e:  # noqa: BLE001 — tolerant loader
            print(f"Warning: Failed to load {f}: {e}", file=sys.stderr)
    return rows


def _profile_row_from_yaml(f: Path, data: dict[str, Any]) -> ProfileRow:
    """Reference speaker-report flat schema (speaker-report:276-312)."""
    speaker_id = f.stem
    samples_dir = config.samples_dir() / speaker_id
    sample_count = (
        len(list(samples_dir.glob("*.wav"))) + len(list(samples_dir.glob("*.mp3")))
        if samples_dir.exists()
        else 0
    )
    reviewed = sum(1 for s in data.get("samples", []) if s.get("reviewed"))
    return ProfileRow(
        speaker_id=speaker_id,
        display_name=data.get("display_name"),
        trust_level=data.get("trust_level", "unverified"),
        sample_count=sample_count,
        embedding_count=data.get("enrollment_count", 0),
        reviewed_samples=reviewed,
        last_updated=data.get("updated_at"),
    )


def _profile_row_from_json(f: Path, data: dict[str, Any]) -> ProfileRow:
    """This framework's real profile schema (store/profiles.py)."""
    from ..store import samples as sample_store

    speaker_id = data.get("id", f.stem)
    order = {"high": 3, "medium": 2, "low": 1}
    best = "unverified"
    n_emb = 0
    for recs in (data.get("embeddings") or {}).values():
        for rec in recs:
            n_emb += 1
            t = rec.get("trust_level", "unverified")
            if order.get(t, 0) > order.get(best, 0):
                best = t
    metas = sample_store.get_speaker_samples(speaker_id)
    reviewed = sum(1 for m in metas if m.get("review", {}).get("status") == "reviewed")
    return ProfileRow(
        speaker_id=speaker_id,
        display_name=(data.get("names") or {}).get("default"),
        trust_level=best,
        sample_count=len(metas),
        embedding_count=n_emb,
        reviewed_samples=reviewed,
        last_updated=data.get("updated_at"),
    )


def load_profile_rows() -> list[ProfileRow]:
    rows: list[ProfileRow] = []
    db = config.db_dir()
    if not db.exists():
        return rows
    for f in sorted(db.iterdir()):
        try:
            if f.suffix == ".yaml":
                rows.append(_profile_row_from_yaml(f, load_yaml(f)))
            elif f.suffix == ".json":
                with open(f, encoding="utf-8") as fh:
                    rows.append(_profile_row_from_json(f, json.load(fh)))
        except Exception as e:  # noqa: BLE001 — tolerant loader
            print(f"Warning: Failed to load {f}: {e}", file=sys.stderr)
    return rows


def load_assignment_rows() -> list[AssignmentRow]:
    rows: list[AssignmentRow] = []
    adir = config.assignments_dir()
    if not adir.exists():
        return rows
    for f in sorted(adir.glob("*.yaml")):
        try:
            data = load_yaml(f)
            rows.append(AssignmentRow(b3sum=f.stem, mappings=data.get("mappings", {})))
        except Exception as e:  # noqa: BLE001 — tolerant loader
            print(f"Warning: Failed to load {f}: {e}", file=sys.stderr)
    return rows


# ---------------------------------------------------------------------------
# Stats + recommendations (reference :344-462)
# ---------------------------------------------------------------------------


def compute_system_stats(
    entries: list[CatalogRow],
    profiles: list[ProfileRow],
    assignments: list[AssignmentRow],
    confidence_threshold: int = DEFAULT_CONFIDENCE_THRESHOLD,
    stale_days: int = STALE_DAYS,
) -> SystemStats:
    stats = SystemStats()
    stats.total_recordings = len(entries)
    for entry in entries:
        if entry.status == "unprocessed":
            stats.pending += 1
        elif entry.status in ("transcribed", "assigned"):
            stats.processed += 1
        elif entry.status in ("reviewed", "complete"):
            stats.reviewed += 1
            stats.processed += 1

    contexts: dict[str, dict[str, int]] = defaultdict(lambda: {"total": 0, "reviewed": 0})
    for entry in entries:
        ctx = entry.context_name or "(no context)"
        contexts[ctx]["total"] += 1
        if entry.status in ("reviewed", "complete"):
            contexts[ctx]["reviewed"] += 1
    stats.total_contexts = len([c for c in contexts if c != "(no context)"])
    stats.contexts = dict(contexts)

    stats.total_speakers = len(profiles)
    for p in profiles:
        if p.trust_level == "high":
            stats.high_trust += 1
        elif p.trust_level == "medium":
            stats.medium_trust += 1
        elif p.trust_level == "low":
            stats.low_trust += 1
        else:
            stats.unverified += 1

    for a in assignments:
        for m in a.mappings.values():
            conf = CONFIDENCE_MAP.get(m.get("confidence", "low"), 0)
            if conf < confidence_threshold:
                stats.low_confidence_count += 1

    stats.speakers_needing_samples = [
        p.speaker_id for p in profiles if p.reviewed_samples < MIN_REVIEWED_SAMPLES
    ]

    for entry in entries:
        if entry.status != "complete":
            age = _days_since(entry.updated_at)
            if age and age > stale_days:
                stats.stale_recordings += 1

    stats.recommendations = generate_recommendations(stats)
    return stats


def generate_recommendations(stats: SystemStats) -> list[str]:
    recs: list[str] = []
    if stats.low_confidence_count > 0:
        recs.append(f"{stats.low_confidence_count} recording(s) have low-confidence assignments")
    if stats.speakers_needing_samples:
        count = len(stats.speakers_needing_samples)
        if count <= 3:
            names = ", ".join(stats.speakers_needing_samples)
            recs.append(f"Speaker(s) {names} need more reviewed samples")
        else:
            recs.append(f"{count} speakers need more reviewed samples")
    if stats.pending > 0:
        recs.append(f"{stats.pending} recording(s) pending transcription")
    if stats.stale_recordings > 0:
        recs.append(f"{stats.stale_recordings} recording(s) have not been updated recently")
    unreviewed_ctx = [
        name
        for name, c in stats.contexts.items()
        if name != "(no context)" and c["reviewed"] == 0 and c["total"] > 0
    ]
    if unreviewed_ctx:
        if len(unreviewed_ctx) <= 2:
            recs.append(f"Context(s) '{', '.join(unreviewed_ctx)}' have no reviewed recordings")
        else:
            recs.append(f"{len(unreviewed_ctx)} contexts have no reviewed recordings")
    return recs


# ---------------------------------------------------------------------------
# Formatters — output strings are the acceptance contract
# (reference :469-853); do not restyle
# ---------------------------------------------------------------------------


def format_status_report(stats: SystemStats, format_type: str) -> str:
    if format_type == "json":
        return json.dumps(
            {
                "recordings": {
                    "total": stats.total_recordings,
                    "processed": stats.processed,
                    "reviewed": stats.reviewed,
                    "pending": stats.pending,
                },
                "speakers": {
                    "total": stats.total_speakers,
                    "high_trust": stats.high_trust,
                    "medium_trust": stats.medium_trust,
                    "low_trust": stats.low_trust,
                    "unverified": stats.unverified,
                },
                "contexts": {"total": stats.total_contexts, "details": stats.contexts},
                "issues": {
                    "low_confidence_count": stats.low_confidence_count,
                    "speakers_needing_samples": stats.speakers_needing_samples,
                    "stale_recordings": stats.stale_recordings,
                },
                "recommendations": stats.recommendations,
            },
            indent=2,
            ensure_ascii=False,
        )
    total = stats.total_recordings
    processed_pct = (stats.processed / total * 100) if total else 0
    reviewed_pct = (stats.reviewed / total * 100) if total else 0
    lines = [
        "Speaker Detection System Status",
        "=" * 32,
        f"Recordings:     {total} total",
        f"  - Processed:  {stats.processed} ({processed_pct:.0f}%)",
        f"  - Reviewed:   {stats.reviewed} ({reviewed_pct:.0f}%)",
        f"  - Pending:    {stats.pending}",
        "",
        f"Speakers:       {stats.total_speakers} enrolled",
        f"  - High trust: {stats.high_trust}",
        f"  - Medium:     {stats.medium_trust}",
        f"  - Low:        {stats.low_trust}",
    ]
    if stats.unverified > 0:
        lines.append(f"  - Unverified: {stats.unverified}")
    lines.append("")
    lines.append(f"Contexts:       {stats.total_contexts} defined")
    for ctx_name, c in sorted(stats.contexts.items()):
        if ctx_name != "(no context)":
            lines.append(f"  - {ctx_name}: {c['total']} recordings, {c['reviewed']} reviewed")
    lines.append("")
    if stats.recommendations:
        lines.append("Recommendations:")
        for rec in stats.recommendations:
            lines.append(f"  - {rec}")
    else:
        lines.append("No issues detected.")
    return "\n".join(lines)


def format_coverage_report(
    entries: list[CatalogRow], context_filter: str | None, format_type: str
) -> str:
    contexts: dict[str, dict[str, Any]] = defaultdict(
        lambda: {
            "total": 0,
            "unprocessed": 0,
            "transcribed": 0,
            "assigned": 0,
            "reviewed": 0,
            "complete": 0,
            "recordings": [],
        }
    )
    for entry in entries:
        ctx = entry.context_name or "(no context)"
        if context_filter and ctx != context_filter:
            continue
        contexts[ctx]["total"] += 1
        contexts[ctx][entry.status] += 1
        contexts[ctx]["recordings"].append(
            {"b3sum": entry.b3sum, "path": entry.path, "status": entry.status}
        )
    if format_type == "json":
        return json.dumps(dict(contexts), indent=2, ensure_ascii=False)
    lines = ["Coverage by Context", "=" * 20, ""]
    for ctx_name, c in sorted(contexts.items()):
        total = c["total"]
        pct = ((c["reviewed"] + c["complete"]) / total * 100) if total else 0
        lines += [
            f"Context: {ctx_name}",
            f"  Total:       {total}",
            f"  Unprocessed: {c['unprocessed']}",
            f"  Transcribed: {c['transcribed']}",
            f"  Assigned:    {c['assigned']}",
            f"  Reviewed:    {c['reviewed']}",
            f"  Complete:    {c['complete']}",
            f"  Coverage:    {pct:.0f}%",
            "",
        ]
    return "\n".join(lines)


def format_contexts_report(entries: list[CatalogRow], format_type: str) -> str:
    contexts: dict[str, dict[str, Any]] = {}
    for entry in entries:
        ctx = entry.context_name or "(no context)"
        c = contexts.setdefault(ctx, {"recordings": 0, "reviewed": 0, "speakers": set()})
        c["recordings"] += 1
        if entry.status in ("reviewed", "complete"):
            c["reviewed"] += 1
        for sp in entry.expected_speakers:
            c["speakers"].add(sp)
    if format_type == "json":
        return json.dumps(
            {
                "contexts": {
                    name: {
                        "recordings": c["recordings"],
                        "reviewed": c["reviewed"],
                        "speakers": sorted(c["speakers"]),
                    }
                    for name, c in sorted(contexts.items())
                }
            },
            indent=2,
            ensure_ascii=False,
        )
    lines = ["Contexts:"]
    if not contexts:
        lines.append("  (no contexts found)")
        return "\n".join(lines)
    width = max(max(len(c) for c in contexts), 12)
    for name, c in sorted(contexts.items()):
        speakers = sorted(c["speakers"])
        sp_str = f"{len(speakers)} speaker{'s' if len(speakers) != 1 else ''}"
        if speakers:
            sp_str += f": {', '.join(speakers)}"
        lines.append(
            f"  {name:<{width}}  {c['recordings']:3d} recordings "
            f"({c['reviewed']} reviewed), {sp_str}"
        )
    return "\n".join(lines)


def format_confidence_report(
    entries: list[CatalogRow],
    assignments: list[AssignmentRow],
    threshold: int,
    format_type: str,
) -> str:
    entry_map = {e.b3sum: e for e in entries}
    low_confidence = []
    for a in assignments:
        low_mappings = []
        for label, m in a.mappings.items():
            conf_str = m.get("confidence", "low")
            conf = CONFIDENCE_MAP.get(conf_str, 0)
            if conf < threshold:
                low_mappings.append(
                    {
                        "label": label,
                        "speaker_id": m.get("speaker_id"),
                        "confidence": conf_str,
                        "confidence_pct": conf,
                    }
                )
        if low_mappings:
            entry = entry_map.get(a.b3sum)
            low_confidence.append(
                {
                    "b3sum": a.b3sum,
                    "path": entry.path if entry else "",
                    "context": entry.context_name if entry else None,
                    "mappings": low_mappings,
                }
            )
    if format_type == "json":
        return json.dumps(
            {"threshold": threshold, "count": len(low_confidence), "recordings": low_confidence},
            indent=2,
            ensure_ascii=False,
        )
    lines = [f"Recordings Below {threshold}% Confidence", "=" * 40, ""]
    if not low_confidence:
        lines.append("No recordings below threshold.")
        return "\n".join(lines)
    lines += [f"Found {len(low_confidence)} recording(s):", ""]
    for rec in low_confidence:
        path_display = Path(rec["path"]).name if rec["path"] else rec["b3sum"][:8]
        lines.append(f"  {path_display}")
        lines.append(f"    B3SUM: {rec['b3sum'][:16]}...")
        if rec["context"]:
            lines.append(f"    Context: {rec['context']}")
        for m in rec["mappings"]:
            speaker = m["speaker_id"] or "(unassigned)"
            lines.append(f"    - {m['label']} -> {speaker} ({m['confidence']})")
        lines.append("")
    return "\n".join(lines)


def format_stale_report(entries: list[CatalogRow], days: int, format_type: str) -> str:
    stale = []
    for entry in entries:
        if entry.status == "complete":
            continue
        age = _days_since(entry.updated_at)
        if age and age > days:
            stale.append(
                {
                    "b3sum": entry.b3sum,
                    "path": entry.path,
                    "context": entry.context_name,
                    "status": entry.status,
                    "days_since_update": age,
                    "updated_at": entry.updated_at,
                }
            )
    stale.sort(key=lambda x: x["days_since_update"], reverse=True)
    if format_type == "json":
        return json.dumps(
            {"threshold_days": days, "count": len(stale), "recordings": stale},
            indent=2,
            ensure_ascii=False,
        )
    lines = [f"Recordings Not Updated in {days}+ Days", "=" * 40, ""]
    if not stale:
        lines.append("No stale recordings found.")
        return "\n".join(lines)
    lines += [f"Found {len(stale)} recording(s):", ""]
    for rec in stale:
        path_display = Path(rec["path"]).name if rec["path"] else rec["b3sum"][:8]
        lines += [
            f"  {path_display}",
            f"    Status: {rec['status']}",
            f"    Last updated: {rec['days_since_update']} days ago",
        ]
        if rec["context"]:
            lines.append(f"    Context: {rec['context']}")
        lines.append("")
    return "\n".join(lines)


def format_speakers_report(profiles: list[ProfileRow], format_type: str) -> str:
    if format_type == "json":
        return json.dumps(
            {
                "total": len(profiles),
                "speakers": [
                    {
                        "speaker_id": p.speaker_id,
                        "display_name": p.display_name,
                        "trust_level": p.trust_level,
                        "sample_count": p.sample_count,
                        "embedding_count": p.embedding_count,
                        "reviewed_samples": p.reviewed_samples,
                        "last_updated": p.last_updated,
                    }
                    for p in profiles
                ],
            },
            indent=2,
            ensure_ascii=False,
        )
    lines = [
        "Speaker Enrollment Summary",
        "=" * 26,
        "",
        f"Total speakers: {len(profiles)}",
        "",
    ]
    if not profiles:
        lines.append("No speakers enrolled.")
        return "\n".join(lines)
    lines.append(f"{'ID':<20} {'Name':<20} {'Trust':<10} {'Samples':<8} {'Reviewed':<8}")
    lines.append("-" * 70)
    for p in sorted(profiles, key=lambda x: x.speaker_id):
        name = (p.display_name or "-")[:20]
        lines.append(
            f"{p.speaker_id:<20} {name:<20} {p.trust_level:<10} "
            f"{p.sample_count:<8} {p.reviewed_samples:<8}"
        )
    lines.append("")
    trust_counts: dict[str, int] = defaultdict(int)
    for p in profiles:
        trust_counts[p.trust_level] += 1
    lines.append("By trust level:")
    for level in TRUST_LEVELS:
        if trust_counts[level] > 0:
            lines.append(f"  - {level}: {trust_counts[level]}")
    need = [p for p in profiles if p.reviewed_samples < MIN_REVIEWED_SAMPLES]
    if need:
        lines.append("")
        lines.append(f"Speakers needing more reviewed samples ({len(need)}):")
        for p in need[:5]:
            lines.append(f"  - {p.speaker_id} ({p.reviewed_samples} reviewed)")
        if len(need) > 5:
            lines.append(f"  - ... and {len(need) - 5} more")
    return "\n".join(lines)
