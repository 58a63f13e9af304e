"""Review session core: human-in-the-loop confirmation of assignments.

The headless engine behind reference ``speaker-review``: session state
persisted after every decision and resumable (:232-307), segments built
from assignments + transcript (:314-397), approve extracts a sample for
the assigned speaker (:556-599) which later feeds trust recomputation,
reject/skip bookkeeping (:602-624), next-needing-review scan (:843-877).
The interactive TUI shell lives in sdtk_tpu_torch.cli.review.  A copy of
``sdtk_tpu/pipeline/review.py``: the same session file and samples.
"""

from __future__ import annotations

import shutil
import subprocess
from dataclasses import asdict, dataclass, field
from datetime import datetime, timezone
from pathlib import Path
from typing import Any

from .. import config
from ..store import assignments as assignment_store
from ..store import catalog as catalog_store
from ..store import samples as sample_store
from ..transcripts import extract_segments_from_transcript, load_transcript
from ..utils.ioutil import load_yaml_or, save_yaml


@dataclass
class ReviewSegment:
    index: int
    speaker_label: str
    speaker_id: str | None
    confidence: str
    score: float
    start: float
    end: float
    text: str
    decision: str | None = None  # approved | rejected | skipped


@dataclass
class ReviewSession:
    recording_b3sum: str
    audio_path: str
    transcript_path: str
    segments: list[ReviewSegment] = field(default_factory=list)
    position: int = 0
    context: str | None = None  # name-resolution context (reference :834-840)
    started_at: str = ""
    updated_at: str = ""

    def to_dict(self) -> dict[str, Any]:
        d = asdict(self)
        # reference session-field alias (speaker-review:232-258)
        d["current_index"] = self.position
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ReviewSession":
        d = dict(d)
        # tolerate the reference's session schema: current_index for
        # position, decisions as an index-keyed dict
        if "current_index" in d and "position" not in d:
            d["position"] = d["current_index"]
        decisions = d.pop("decisions", None)
        segs = [ReviewSegment(**s) for s in d.pop("segments", [])]
        if decisions and segs:
            for key, dec in decisions.items():
                try:
                    i = int(key)
                except (TypeError, ValueError):
                    continue
                if 0 <= i < len(segs) and isinstance(dec, dict):
                    segs[i].decision = dec.get("action")
        return cls(
            segments=segs,
            **{
                k: v
                for k, v in d.items()
                if k in cls.__dataclass_fields__ and k != "segments"
            },
        )


def session_path() -> Path:
    return config.review_session_dir() / "session.yaml"


def save_session(session: ReviewSession) -> None:
    session.updated_at = datetime.now(timezone.utc).isoformat()
    save_yaml(session_path(), session.to_dict())


def load_session() -> ReviewSession | None:
    data = load_yaml_or(session_path())
    return ReviewSession.from_dict(data) if data else None


def clear_session() -> None:
    p = session_path()
    if p.exists():
        p.unlink()


def build_session(b3sum: str, max_segments_per_label: int = 3) -> ReviewSession:
    """Segments to review from assignments + transcript
    (reference :314-397)."""
    assignments = assignment_store.load_assignments(b3sum)
    if not assignments:
        raise KeyError(f"no assignments for {b3sum}")
    entry = catalog_store.load_entry(b3sum)
    audio_path = entry.get("recording", {}).get("path", "") if entry else ""
    context = entry.get("context", {}).get("name") if entry else None
    transcript_path = assignments.get("transcript_path", "")
    data = load_transcript(transcript_path)

    segments: list[ReviewSegment] = []
    idx = 0
    for label, mapping in (assignments.get("mappings") or {}).items():
        label_segments = extract_segments_from_transcript(
            data, label, min_duration=0.0
        )
        # Longest segments first: most audio to judge by.
        label_segments.sort(key=lambda s: s["end"] - s["start"], reverse=True)
        for seg in label_segments[:max_segments_per_label]:
            segments.append(
                ReviewSegment(
                    index=idx,
                    speaker_label=label,
                    speaker_id=mapping.get("speaker_id"),
                    confidence=mapping.get("confidence", "?"),
                    score=mapping.get("score", 0.0),
                    start=seg["start"],
                    end=seg["end"],
                    text=seg.get("text", ""),
                )
            )
            idx += 1

    now = datetime.now(timezone.utc).isoformat()
    session = ReviewSession(
        recording_b3sum=b3sum,
        audio_path=audio_path,
        transcript_path=str(transcript_path),
        segments=segments,
        context=context,
        started_at=now,
        updated_at=now,
    )
    save_session(session)
    return session


def approve_segment(session: ReviewSession, index: int) -> dict[str, Any] | None:
    """Approve: extract ONE sample for the assigned speaker from this
    segment (reference action_approve :556-599) and mark it reviewed —
    approval by a human IS the review."""
    seg = session.segments[index]
    seg.decision = "approved"
    save_session(session)
    if not seg.speaker_id:
        return None
    written = sample_store.extract_samples(
        seg.speaker_id,
        session.audio_path,
        [{"start": seg.start, "end": seg.end, "text": seg.text}],
        speaker_label=seg.speaker_label,
        transcript_path=session.transcript_path or None,
        max_segments=1,
    )
    if written:
        sample_store.set_review_status(
            seg.speaker_id, sample_id=written[0]["sample_id"], status="reviewed"
        )
        from ..store.profiles import refresh_trust_levels

        refresh_trust_levels(seg.speaker_id)
        return written[0]
    return None


def reject_segment(session: ReviewSession, index: int) -> None:
    session.segments[index].decision = "rejected"
    save_session(session)


def skip_segment(session: ReviewSession, index: int) -> None:
    session.segments[index].decision = "skipped"
    save_session(session)


def finish_review(session: ReviewSession) -> str:
    """Update the catalog review state from decisions: complete if every
    segment decided and none rejected, else partial."""
    decided = [s for s in session.segments if s.decision]
    if not decided:
        return "none"
    status = "complete" if len(decided) == len(session.segments) else "partial"
    try:
        catalog_store.set_review_status(session.recording_b3sum, status)
    except KeyError:
        pass
    return status


def next_needing_review() -> str | None:
    """First catalog entry in 'assigned' status (reference :843-877)."""
    for entry in catalog_store.list_entries():
        if catalog_store.compute_status(entry) == "assigned":
            return entry.get("recording", {}).get("b3sum")
    return None


def play_segment(audio_path: str | Path, start: float, end: float) -> bool:
    """Playback via $SPEAKER_REVIEW_PLAYER, mpv, or ffplay — whichever
    exists (reference :404-444).  Returns False when no player found."""
    import os

    candidates = []
    custom = os.environ.get("SPEAKER_REVIEW_PLAYER")
    if custom:
        candidates.append(custom)
    candidates += ["mpv", "ffplay"]
    for player in candidates:
        exe = shutil.which(player)
        if not exe:
            continue
        if "mpv" in player:
            cmd = [exe, f"--start={start}", f"--end={end}", "--really-quiet", str(audio_path)]
        else:
            cmd = [exe, "-ss", str(start), "-t", str(end - start), "-autoexit",
                   "-nodisp", "-loglevel", "quiet", str(audio_path)]
        try:
            subprocess.run(cmd, check=False)
            return True
        except OSError:
            continue
    return False
