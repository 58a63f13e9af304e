"""Recursive speaker-label mapping in arbitrary transcript JSON (a copy of
``sdtk_tpu/transcripts/mapper.py``; names come from the port's profile
store).

The reference ships unit tests for an external
``stt_assemblyai_speaker_mapper.py`` (the script itself is absent from its
repo — test_stt_assemblyai_speaker_mapper.py:1-120 defines the contract);
this module provides the capability first-party: detect every ``speaker``
key anywhere in a JSON document and rewrite labels to display names —
e.g. applying a speaker-assign result back onto the raw STT transcript.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any


def detect_speakers_in_json(obj: Any) -> set[str]:
    """All values of ``speaker`` keys anywhere in the structure."""
    speakers: set[str] = set()

    def walk(node: Any) -> None:
        if isinstance(node, dict):
            v = node.get("speaker")
            if isinstance(v, str):
                speakers.add(v)
            for value in node.values():
                walk(value)
        elif isinstance(node, list):
            for item in node:
                walk(item)

    walk(obj)
    return speakers


def replace_speakers_recursive(obj: Any, speaker_map: dict[str, str]) -> Any:
    """Deep copy with every ``speaker`` value mapped (unknown labels kept)."""
    out = copy.deepcopy(obj)

    def walk(node: Any) -> None:
        if isinstance(node, dict):
            v = node.get("speaker")
            if isinstance(v, str) and v in speaker_map:
                node["speaker"] = speaker_map[v]
            for value in node.values():
                walk(value)
        elif isinstance(node, list):
            for item in node:
                walk(item)

    walk(out)
    return out


def mapping_from_assignments(
    assignments: dict[str, Any], use_names: bool = True
) -> dict[str, str]:
    """label → display-name (or speaker-id) map from an assignment file."""
    from ..store.profiles import load_speaker

    mapping: dict[str, str] = {}
    for label, m in (assignments.get("mappings") or {}).items():
        sid = m.get("speaker_id")
        if not sid:
            continue
        if use_names:
            profile = load_speaker(sid)
            mapping[label] = (
                profile["names"]["default"] if profile else sid
            )
        else:
            mapping[label] = sid
    return mapping


def apply_assignments_to_transcript(
    transcript_path: str | Path,
    assignments: dict[str, Any],
    output_path: str | Path | None = None,
    use_names: bool = True,
) -> dict[str, Any]:
    """Rewrite a transcript's anonymous labels using an assignment result;
    optionally write the mapped document."""
    import json

    from ..utils.ioutil import atomic_write_text

    with open(transcript_path, "r", encoding="utf-8") as f:
        data = json.load(f)
    mapped = replace_speakers_recursive(data, mapping_from_assignments(assignments, use_names))
    if output_path:
        atomic_write_text(output_path, json.dumps(mapped, indent=2, ensure_ascii=False) + "\n")
    return mapped
