"""Recording catalog + processing-state machine + context registry: the
counterpart of ``sdtk_tpu/store/catalog.py``, writing the same
``catalog/{b3sum}.yaml`` entries and ``contexts.yaml`` bytes for the same
inputs and timestamps, so either package reads what the other wrote.

Mirrors reference ``speaker-catalog``: entry schema (:265-281), derived
status ``unprocessed → transcribed → assigned → reviewed → complete``
(:214-236), b3sum-prefix resolution (:164-179), transcript registration
(:470-547), contexts registry in ``contexts.yaml`` (:695-827).
"""

from __future__ import annotations

from datetime import datetime, timezone
from pathlib import Path
from typing import Any

from .. import config
from ..utils.hashing import compute_b3sum
from ..utils.ioutil import load_yaml_or, save_yaml

SCHEMA_VERSION = 1
STATUS_VALUES = ("unprocessed", "transcribed", "assigned", "reviewed", "complete")


def utc_now_iso() -> str:
    return datetime.now(timezone.utc).isoformat()


def entry_path(b3sum: str) -> Path:
    return config.catalog_dir() / f"{b3sum}.yaml"


def load_entry(b3sum: str) -> dict[str, Any] | None:
    return load_yaml_or(entry_path(b3sum))


def save_entry(entry: dict[str, Any]) -> None:
    entry["updated_at"] = utc_now_iso()
    save_yaml(entry_path(entry["recording"]["b3sum"]), entry)


def list_entries() -> list[dict[str, Any]]:
    cdir = config.catalog_dir()
    if not cdir.exists():
        return []
    out = []
    for p in sorted(cdir.glob("*.yaml")):
        e = load_yaml_or(p)
        if e:
            out.append(e)
    return out


def resolve_b3sum(ref: str) -> str | None:
    """Resolve an audio path or b3sum prefix to a full catalog key
    (reference speaker-catalog:164-179)."""
    cdir = config.catalog_dir()
    p = Path(ref)
    if p.exists():
        return compute_b3sum(p)
    if cdir.exists():
        matches = [f.stem for f in cdir.glob("*.yaml") if f.stem.startswith(ref)]
        if len(matches) == 1:
            return matches[0]
    return None


def find_by_path(audio_path: str | Path) -> tuple[str, dict[str, Any]] | None:
    resolved = str(Path(audio_path).resolve())
    cdir = config.catalog_dir()
    if not cdir.exists():
        return None
    for f in cdir.glob("*.yaml"):
        e = load_yaml_or(f)
        if e and e.get("recording", {}).get("path", "") == resolved:
            return f.stem, e
    return None


def compute_status(entry: dict[str, Any]) -> str:
    """Derived pipeline status (reference speaker-catalog:214-236)."""
    if not entry.get("transcriptions", []):
        return "unprocessed"
    b3sum = entry.get("recording", {}).get("b3sum", "")
    if not (config.assignments_dir() / f"{b3sum}.yaml").exists():
        return "transcribed"
    review_status = entry.get("review", {}).get("status", "none")
    if review_status == "complete":
        return "complete"
    if review_status == "partial":
        return "reviewed"
    return "assigned"


def add_recording(
    audio_path: str | Path,
    context: str | None = None,
    tags: list[str] | None = None,
    force: bool = False,
) -> dict[str, Any]:
    """Add a recording (reference cmd_add :243-294).  Raises FileExistsError
    if already cataloged and not force."""
    audio_path = Path(audio_path).resolve()
    if not audio_path.exists():
        raise FileNotFoundError(str(audio_path))
    b3sum = compute_b3sum(audio_path)
    config.ensure_layout()
    if entry_path(b3sum).exists() and not force:
        raise FileExistsError(b3sum)

    try:
        from ..utils.audio import probe

        duration = probe(audio_path).duration
    except Exception:  # noqa: BLE001 — unreadable audio is cataloged without a duration
        duration = None

    entry = {
        "schema_version": SCHEMA_VERSION,
        "recording": {
            "path": str(audio_path),
            "b3sum": b3sum,
            "duration_sec": duration,
            "discovered_at": utc_now_iso(),
        },
        "context": {
            "name": context or None,
            "expected_speakers": [],
            "tags": tags or [],
        },
        "transcriptions": [],
        "status": "unprocessed",
        "updated_at": utc_now_iso(),
    }
    # Pull expected speakers from the context registry if defined.
    if context:
        ctx = get_context(context)
        if ctx:
            entry["context"]["expected_speakers"] = list(ctx.get("expected_speakers", []))
    save_yaml(entry_path(b3sum), entry)
    return entry


def register_transcript(
    b3sum: str,
    transcript_path: str | Path,
    backend: str,
    force: bool = False,
    version: str | None = None,
    tool_version: str | None = None,
) -> dict[str, Any]:
    """Attach a transcript to a catalog entry (reference :470-547): counts
    speakers, per-backend dedupe unless force."""
    entry = load_entry(b3sum)
    if entry is None:
        raise KeyError(b3sum)
    transcript_path = Path(transcript_path).resolve()

    from ..transcripts import get_available_speakers, load_transcript

    data = load_transcript(transcript_path)
    speakers = get_available_speakers(data)

    transcriptions = entry.setdefault("transcriptions", [])
    existing = [t for t in transcriptions if t.get("backend") == backend]
    if existing and not force:
        raise FileExistsError(f"transcript for backend '{backend}' already registered")
    if existing:
        transcriptions[:] = [t for t in transcriptions if t.get("backend") != backend]
    record: dict[str, Any] = {
        "backend": backend,
        "path": str(transcript_path),
        "speaker_count": len(speakers),
        "speakers": speakers,
        "registered_at": utc_now_iso(),
    }
    if version:
        record["version"] = version
    if tool_version:
        record["tool_version"] = tool_version
    transcriptions.append(record)
    entry["status"] = compute_status(entry)
    save_entry(entry)
    return entry


def set_context(
    b3sum: str,
    context: str | None,
    expected_speakers: list[str] | None = None,
    add_tags: list[str] | None = None,
    remove_tags: list[str] | None = None,
) -> dict[str, Any]:
    entry = load_entry(b3sum)
    if entry is None:
        raise KeyError(b3sum)
    ctx_block = entry.setdefault("context", {})
    if context is not None:
        ctx_block["name"] = context
        if expected_speakers is None:
            ctx = get_context(context)
            if ctx:
                ctx_block["expected_speakers"] = list(ctx.get("expected_speakers", []))
    if expected_speakers is not None:
        ctx_block["expected_speakers"] = expected_speakers
    if add_tags or remove_tags:
        tags = list(ctx_block.get("tags", []))
        for t in add_tags or []:
            if t not in tags:
                tags.append(t)
        tags = [t for t in tags if t not in set(remove_tags or [])]
        ctx_block["tags"] = tags
    save_entry(entry)
    return entry


def set_review_status(b3sum: str, status: str) -> dict[str, Any]:
    """Review progression none → partial → complete."""
    if status not in ("none", "partial", "complete"):
        raise ValueError(status)
    entry = load_entry(b3sum)
    if entry is None:
        raise KeyError(b3sum)
    entry.setdefault("review", {})["status"] = status
    entry["review"]["updated_at"] = utc_now_iso()
    entry["status"] = compute_status(entry)
    save_entry(entry)
    return entry


def remove_recording(b3sum: str, remove_assignments: bool = True) -> bool:
    """Remove a catalog entry (+ its assignments, reference :601-652)."""
    p = entry_path(b3sum)
    if not p.exists():
        return False
    p.unlink()
    if remove_assignments:
        ap = config.assignments_dir() / f"{b3sum}.yaml"
        if ap.exists():
            ap.unlink()
    return True


# ---------------------------------------------------------------------------
# Context registry (contexts.yaml)
# ---------------------------------------------------------------------------


def load_contexts() -> dict[str, Any]:
    return load_yaml_or(config.contexts_path(), {}) or {}


def save_contexts(contexts: dict[str, Any]) -> None:
    config.ensure_layout()
    save_yaml(config.contexts_path(), contexts)


def get_context(name: str) -> dict[str, Any] | None:
    return load_contexts().get(name)


def create_context(
    name: str,
    speakers: list[str] | None = None,
    description: str | None = None,
    force: bool = False,
) -> dict[str, Any]:
    contexts = load_contexts()
    if name in contexts and not force:
        raise FileExistsError(name)
    ctx: dict[str, Any] = {
        "expected_speakers": speakers or [],
        "created_at": utc_now_iso(),
        "updated_at": utc_now_iso(),
    }
    if description:
        ctx["description"] = description
    contexts[name] = ctx
    save_contexts(contexts)
    return ctx


def context_add_speaker(name: str, speaker_id: str) -> dict[str, Any]:
    contexts = load_contexts()
    if name not in contexts:
        raise KeyError(name)
    ctx = contexts[name]
    if speaker_id not in ctx.setdefault("expected_speakers", []):
        ctx["expected_speakers"].append(speaker_id)
        ctx["updated_at"] = utc_now_iso()
        save_contexts(contexts)
    return ctx
