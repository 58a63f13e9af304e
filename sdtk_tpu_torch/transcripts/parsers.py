"""Unified transcript parsing (AssemblyAI / Speechmatics): a copy of
``sdtk_tpu/transcripts/parsers.py``.

Same behavioral surface as the reference transcript layer
(``speaker_detection_backends/transcript.py:25-305`` and the private copy in
``speaker-assign:169-246``):

- AssemblyAI: top-level ``utterances`` array, times in **milliseconds**.
- Speechmatics: top-level ``results`` array of word/punctuation items, times
  in seconds, speaker on the item or inside ``alternatives``.
- Unknown speakers get the ``UU`` label.
- Segment extraction run-length groups consecutive words per speaker, then
  optionally merges segments whose gap ≤ ``max_gap`` and drops segments
  shorter than ``min_duration``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np

UNKNOWN_LABEL = "UU"


def load_transcript(path: str | Path) -> dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def detect_transcript_format(data: dict[str, Any]) -> str:
    """'assemblyai' | 'speechmatics' | 'unknown'
    (reference transcript.py:25-53)."""
    if "utterances" in data:
        return "assemblyai"
    results = data.get("results")
    if isinstance(results, list) and results:
        first = results[0]
        if (
            "alternatives" in first
            or "start_time" in first
            or first.get("type") in ("word", "punctuation")
        ):
            return "speechmatics"
    return "unknown"


def _word_speaker(item: dict[str, Any]) -> str | None:
    """Speaker of a Speechmatics word item: top-level wins, else
    alternatives[0] (reference transcript.py:157-163)."""
    speaker = item.get("speaker")
    if not speaker:
        alts = item.get("alternatives", [])
        if alts:
            speaker = alts[0].get("speaker")
    return speaker


def _word_content(item: dict[str, Any]) -> str:
    alts = item.get("alternatives", [])
    return alts[0].get("content", "") if alts else ""


def get_available_speakers(data: dict[str, Any]) -> list[str]:
    """Sorted unique speaker labels (reference transcript.py:56-88)."""
    fmt = detect_transcript_format(data)
    speakers: set[str] = set()
    if fmt == "assemblyai":
        for utt in data.get("utterances", []):
            if "speaker" in utt:
                speakers.add(utt["speaker"])
    elif fmt == "speechmatics":
        for item in data.get("results", []):
            # items without a "type" field count as words (the reference's
            # own speaker-assign:187-194 applies no type filter; its test
            # mocks omit "type")
            if item.get("type", "word") != "word":
                continue
            if "speaker" in item:
                speakers.add(item["speaker"])
            for alt in item.get("alternatives", []):
                if "speaker" in alt:
                    speakers.add(alt["speaker"])
    return sorted(speakers)


def _runlength_segments(
    data: dict[str, Any], speaker_label: str, with_text: bool
) -> list[dict[str, Any]]:
    """Run-length group consecutive same-speaker words into raw segments."""
    segments: list[dict[str, Any]] = []
    fmt = detect_transcript_format(data)

    if fmt == "assemblyai":
        for utt in data.get("utterances", []):
            if utt.get("speaker") == speaker_label:
                segments.append(
                    {
                        "start": utt.get("start", 0) / 1000.0,  # ms → s
                        "end": utt.get("end", 0) / 1000.0,
                        "text": utt.get("text", "") if with_text else "",
                    }
                )
        return segments

    if fmt != "speechmatics":
        return segments

    cur: dict[str, Any] | None = None
    cur_text: list[str] = []
    prev_speaker: str | None = None
    for item in data.get("results", []):
        if item.get("type", "word") != "word":
            continue
        speaker = _word_speaker(item) or UNKNOWN_LABEL
        start = item.get("start_time", 0)
        end = item.get("end_time", 0)
        if speaker == speaker_label:
            if prev_speaker != speaker_label:
                if cur is not None:
                    cur["text"] = " ".join(cur_text)
                    segments.append(cur)
                cur = {"start": start, "end": end, "text": ""}
                cur_text = []
            else:
                assert cur is not None
                cur["end"] = end
            if with_text:
                content = _word_content(item)
                if content:
                    cur_text.append(content)
        prev_speaker = speaker
    if cur is not None:
        cur["text"] = " ".join(cur_text)
        segments.append(cur)
    return segments


def extract_segments_as_tuples(
    data: dict[str, Any], speaker_label: str
) -> list[tuple[float, float]]:
    """(start, end) tuples, unmerged (reference transcript.py:123-188)."""
    return [
        (s["start"], s["end"])
        for s in _runlength_segments(data, speaker_label, with_text=False)
    ]


def _merge_and_filter(
    segments: list[dict[str, Any]], min_duration: float, max_gap: float
) -> list[dict[str, Any]]:
    """Drop segments shorter than ``min_duration``; merge survivors whose gap
    ≤ ``max_gap`` (reference transcript.py:266-286 — filter happens before
    the merge decision, per-segment)."""
    merged: list[dict[str, Any]] = []
    for seg in segments:
        if seg["end"] - seg["start"] < min_duration:
            continue
        if merged and (seg["start"] - merged[-1]["end"]) <= max_gap:
            merged[-1]["end"] = seg["end"]
            if seg["text"]:
                merged[-1]["text"] = (merged[-1]["text"] + " " + seg["text"]).strip()
        else:
            merged.append(dict(seg))
    return merged


def extract_segments_from_transcript(
    data: dict[str, Any],
    speaker_label: str,
    min_duration: float = 0.5,
    max_gap: float = 1.0,
) -> list[dict[str, Any]]:
    """Merged/filtered {start, end, text} segments
    (reference transcript.py:91-120)."""
    raw = _runlength_segments(data, speaker_label, with_text=True)
    return _merge_and_filter(raw, min_duration, max_gap)


def get_speaker_segments(data: dict[str, Any], speaker_label: str) -> list[dict[str, Any]]:
    """Unmerged {start, end, text} segments — the variant speaker-assign uses
    for its per-label hot loop (reference speaker-assign:199-246)."""
    return _runlength_segments(data, speaker_label, with_text=True)


def merge_segments_by_gap(
    segments: list[tuple[float, float]], max_gap: float
) -> list[tuple[float, float]]:
    """Merge consecutive tuples with gap ≤ max_gap
    (reference speaker_segments:38-71)."""
    if not segments or max_gap <= 0:
        return segments
    merged: list[tuple[float, float]] = []
    cur_start, cur_end = segments[0]
    for start, end in segments[1:]:
        if start - cur_end <= max_gap:
            cur_end = end
        else:
            merged.append((cur_start, cur_end))
            cur_start, cur_end = start, end
    merged.append((cur_start, cur_end))
    return merged


def segments_to_array(segments: list[tuple[float, float]] | list[dict[str, Any]]) -> np.ndarray:
    """(N, 2) float32 [start, end] array for vectorized device feeds."""
    if not segments:
        return np.zeros((0, 2), dtype=np.float32)
    if isinstance(segments[0], dict):
        rows = [(s["start"], s["end"]) for s in segments]  # type: ignore[index]
    else:
        rows = list(segments)  # type: ignore[assignment]
    return np.asarray(rows, dtype=np.float32)
