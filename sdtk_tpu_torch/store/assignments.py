"""Assignment file store: label → speaker-id mapping per recording (the
counterpart of ``sdtk_tpu/store/assignments.py``: same schema version and
YAML layout).

Schema parity with reference ``speaker-assign`` output
(assignments/{b3sum}.yaml, :597-629): schema_version, recording_b3sum,
transcript_path, assigned_at, method, context, min_trust, threshold,
mappings{label: {speaker_id, confidence, score, signals[], candidates[]}}.
"""

from __future__ import annotations

from datetime import datetime, timezone
from pathlib import Path
from typing import Any

from .. import config
from ..utils.ioutil import load_yaml_or, save_yaml

SCHEMA_VERSION = 1


def assignment_path(b3sum: str) -> Path:
    return config.assignments_dir() / f"{b3sum}.yaml"


def load_assignments(b3sum: str) -> dict[str, Any] | None:
    return load_yaml_or(assignment_path(b3sum))


def save_assignments(
    b3sum: str,
    transcript_path: str | Path,
    mappings: dict[str, Any],
    method: str,
    context: str | None = None,
    min_trust: str = "low",
    threshold: float = 0.5,
) -> dict[str, Any]:
    config.ensure_layout()
    output = {
        "schema_version": SCHEMA_VERSION,
        "recording_b3sum": b3sum,
        "transcript_path": str(transcript_path),
        "assigned_at": datetime.now(timezone.utc).isoformat(),
        "method": method,
        "context": context,
        "min_trust": min_trust,
        "threshold": threshold,
        "mappings": mappings,
    }
    save_yaml(assignment_path(b3sum), output)
    return output


def clear_assignments(b3sum: str) -> bool:
    p = assignment_path(b3sum)
    if p.exists():
        p.unlink()
        return True
    return False


def list_assignments() -> list[dict[str, Any]]:
    adir = config.assignments_dir()
    if not adir.exists():
        return []
    out = []
    for p in sorted(adir.glob("*.yaml")):
        a = load_yaml_or(p)
        if a:
            out.append(a)
    return out
