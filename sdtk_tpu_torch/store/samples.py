"""Audio sample store with provenance metadata and review state.

A copy of ``sdtk_tpu/store/samples.py``: the same ``samples/{speaker}/``
layout, ``sample-NNN`` numbering and v2 ``*.meta.yaml`` files (the
extraction tool's name included, so either package reads and extends a
store the other wrote).  It mirrors the reference ``speaker_samples``
(extraction :403-504, metadata v2 :349-396, review :843-921), slicing
audio in-process (``utils/audio.slice_segments``, no ffmpeg) and writing
MP3 by ``utils/audio.save_mp3`` (Layer III through libmp3lame where the
host has it, else the first-party Layer II encoder) or WAV.
"""

from __future__ import annotations

from datetime import datetime, timezone
from pathlib import Path
from typing import Any

from .. import config
from ..utils.hashing import compute_b3sum
from ..utils.ioutil import load_yaml, save_yaml
from .migrations import SAMPLE_METADATA_VERSION, migrate_sample_metadata

EXTRACTION_TOOL = "sdtk_tpu.samples"
EXTRACTION_TOOL_VERSION = "0.1.0"


def speaker_samples_dir(speaker_id: str) -> Path:
    return config.samples_dir() / speaker_id


def get_next_sample_id(speaker_dir: Path) -> str:
    """sample-NNN numbering (reference speaker_samples:329-346)."""
    existing = []
    for pattern in ("sample-*.wav", "sample-*.mp3"):
        for f in speaker_dir.glob(pattern):
            try:
                existing.append(int(f.stem.split("-")[1]))
            except (ValueError, IndexError):
                continue
    return f"sample-{max(existing, default=0) + 1:03d}"


def load_sample_metadata(meta_path: Path, auto_migrate: bool = False) -> dict[str, Any] | None:
    if not meta_path.exists():
        return None
    meta = load_yaml(meta_path)
    if meta and auto_migrate and meta.get("version", 0) < SAMPLE_METADATA_VERSION:
        meta = migrate_sample_metadata(meta)
        save_yaml(meta_path, meta)
    return meta


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
    """Sample b3sums bucketed by review status for one source recording
    (reference speaker_detection:325-356)."""
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


def write_metadata(
    meta_path: Path,
    sample_id: str,
    sample_b3sum: str,
    audio_path: Path,
    audio_b3sum: str,
    transcript_path: Path | None,
    segment: dict[str, Any],
    speaker_label: str,
) -> dict[str, Any]:
    """v2 metadata file (reference speaker_samples:349-396 field layout)."""
    meta: dict[str, Any] = {
        "version": SAMPLE_METADATA_VERSION,
        "sample_id": sample_id,
        "b3sum": sample_b3sum,
        "source": {
            "audio_file": str(Path(audio_path).resolve()),
            "audio_b3sum": audio_b3sum,
        },
        "segment": {
            "speaker_label": speaker_label,
            "start_sec": segment["start"],
            "end_sec": segment["end"],
            "duration_sec": round(segment["end"] - segment["start"], 3),
            "text": segment.get("text", ""),
        },
        "extraction": {
            "tool": EXTRACTION_TOOL,
            "tool_version": EXTRACTION_TOOL_VERSION,
            "extracted_at": datetime.now(timezone.utc).isoformat(),
        },
        "review": {"status": "pending", "reviewed_at": None, "notes": None},
    }
    if transcript_path:
        meta["source"]["transcript_file"] = str(Path(transcript_path).resolve())
    save_yaml(meta_path, meta)
    return meta


def extract_samples(
    speaker_id: str,
    audio_path: str | Path,
    segments: list[dict[str, Any]],
    speaker_label: str = "",
    transcript_path: str | Path | None = None,
    max_segments: int | None = None,
    max_duration: float | None = None,
    sr: int = 16000,
    output_format: str = "mp3",
) -> list[dict[str, Any]]:
    """Slice segments out of a recording into the sample store
    (reference cmd_extract :403-504 incl. --max-segments/--max-duration caps).

    Returns the metadata dicts of the written samples.
    """
    import numpy as np

    from ..utils import audio as audio_util

    audio_path = Path(audio_path)
    wav, sr = audio_util.load_audio(audio_path, target_sr=sr)
    audio_b3 = compute_b3sum(audio_path)

    sdir = speaker_samples_dir(speaker_id)
    sdir.mkdir(parents=True, exist_ok=True)

    chosen = segments[:max_segments] if max_segments else list(segments)
    written: list[dict[str, Any]] = []
    total = 0.0
    for seg in chosen:
        dur = seg["end"] - seg["start"]
        if max_duration is not None and total + dur > max_duration:
            break
        total += dur
        sample_id = get_next_sample_id(sdir)
        out_path = sdir / f"{sample_id}.{output_format}"
        clip = audio_util.slice_segments(wav, sr, [(seg["start"], seg["end"])])
        if len(clip) == 0:
            clip = np.zeros(1, dtype=np.float32)
        if output_format == "mp3":
            # reference default: mp3 samples (speaker_samples:480)
            audio_util.save_mp3(out_path, clip, sr)
        else:
            audio_util.save_wav(out_path, clip, sr)
        meta = write_metadata(
            sdir / f"{sample_id}.meta.yaml",
            sample_id,
            compute_b3sum(out_path),
            audio_path,
            audio_b3,
            Path(transcript_path) if transcript_path else None,
            seg,
            speaker_label,
        )
        written.append(meta)
    return written


def set_review_status(
    speaker_id: str,
    sample_id: str | None = None,
    source_b3sum: str | None = None,
    status: str = "reviewed",
    notes: str | None = None,
) -> list[dict[str, Any]]:
    """Approve/reject samples by id or by source recording
    (reference cmd_review :843-921).  Returns updated metadata dicts."""
    if status not in ("pending", "reviewed", "rejected"):
        raise ValueError(f"invalid review status: {status}")
    sdir = speaker_samples_dir(speaker_id)
    updated = []
    for meta_path in sorted(sdir.glob("*.meta.yaml")) if sdir.exists() else []:
        meta = load_sample_metadata(meta_path)
        if not meta:
            continue
        if sample_id and meta.get("sample_id") != sample_id:
            continue
        if source_b3sum and meta.get("source", {}).get("audio_b3sum") != source_b3sum:
            continue
        meta.setdefault("review", {})
        old_status = meta["review"].get("status", "pending")
        meta["review"]["status"] = status
        meta["review"]["reviewed_at"] = datetime.now(timezone.utc).isoformat()
        if notes is not None:
            meta["review"]["notes"] = notes
        if meta.get("version", 1) < SAMPLE_METADATA_VERSION:
            meta["version"] = SAMPLE_METADATA_VERSION
        save_yaml(meta_path, meta)
        meta = dict(meta)
        meta["previous_status"] = old_status  # not persisted; for CLI output
        updated.append(meta)
    return updated


def list_samples(
    speaker_id: str | None = None, review_status: str | None = None
) -> list[dict[str, Any]]:
    """Flat sample listing with optional review-status filter
    (reference cmd_list :550-677)."""
    root = config.samples_dir()
    if not root.exists():
        return []
    speaker_ids = [speaker_id] if speaker_id else sorted(p.name for p in root.iterdir() if p.is_dir())
    out = []
    for sid in speaker_ids:
        for meta in get_speaker_samples(sid):
            if review_status and meta.get("review", {}).get("status", "pending") != review_status:
                continue
            meta = dict(meta)
            meta["speaker_id"] = sid
            out.append(meta)
    return out
