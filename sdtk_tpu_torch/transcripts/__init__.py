"""Transcript parsing for AssemblyAI and Speechmatics STT formats: a copy
of ``sdtk_tpu/transcripts`` (same exports, same segments).

Behavioral parity with the reference's
``speaker_detection_backends/transcript.py`` (format detection, ms→s
conversion, ``UU`` unknown label, merge/filter semantics).
"""

from .parsers import (
    detect_transcript_format,
    extract_segments_as_tuples,
    extract_segments_from_transcript,
    get_available_speakers,
    get_speaker_segments,
    load_transcript,
    merge_segments_by_gap,
    segments_to_array,
)

__all__ = [
    "detect_transcript_format",
    "extract_segments_as_tuples",
    "extract_segments_from_transcript",
    "get_available_speakers",
    "get_speaker_segments",
    "load_transcript",
    "merge_segments_by_gap",
    "segments_to_array",
]
