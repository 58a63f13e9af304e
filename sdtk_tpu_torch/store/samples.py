"""The read side of the audio sample store: sample metadata and review
state (a copy of that part of ``sdtk_tpu/store/samples.py``).

Metadata lives in ``samples/{speaker}/*.meta.yaml``; YAML is parsed only
when such files exist.  Extracting and reviewing samples (the write side)
is later work.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

from .. import config
from ..utils.ioutil import load_yaml


def speaker_samples_dir(speaker_id: str) -> Path:
    return config.samples_dir() / speaker_id


def load_sample_metadata(meta_path: Path) -> dict[str, Any] | None:
    if not meta_path.exists():
        return None
    return load_yaml(meta_path)


def get_speaker_samples(speaker_id: str) -> list[dict[str, Any]]:
    sdir = speaker_samples_dir(speaker_id)
    if not sdir.exists():
        return []
    out = []
    for meta_path in sorted(sdir.glob("*.meta.yaml")):
        meta = load_sample_metadata(meta_path)
        if meta:
            out.append(meta)
    return out


def get_samples_by_source_audio(speaker_id: str, audio_b3sum: str) -> dict[str, list[str]]:
    """Sample b3sums bucketed by review status for one source recording."""
    result: dict[str, list[str]] = {"reviewed": [], "unreviewed": [], "rejected": []}
    for sample in get_speaker_samples(speaker_id):
        if sample.get("source", {}).get("audio_b3sum") != audio_b3sum:
            continue
        b3 = sample.get("b3sum")
        if not b3:
            continue
        status = sample.get("review", {}).get("status", "pending")
        if status == "reviewed":
            result["reviewed"].append(b3)
        elif status == "rejected":
            result["rejected"].append(b3)
        else:
            result["unreviewed"].append(b3)
    return result
