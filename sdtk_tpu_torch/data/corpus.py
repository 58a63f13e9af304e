"""Real-corpus manifest loading: WAV + RTTM pairs (AMI/DIHARD layout).

A copy of ``sdtk_tpu/data/corpus.py`` over the port's ``cluster/der.py``.

SURVEY.md's eval convention is synthetic (the reference benchmarks
against an espeak-ng corpus it builds itself,
evals/speaker_detection/Makefile:29-93); this module is the seam for the
moment a REAL diarization corpus is mounted: point
``python -m sdtk_tpu_torch.evals.der --corpus DIR`` at a directory of recordings and
their reference RTTMs and the same DER matrix runs unchanged.

Layout: any directory containing ``<id>.wav`` + ``<id>.rttm`` pairs
(searched recursively; AMI's official release and DIHARD's ``flac→wav``
conversions both reduce to this).  A recording without a reference RTTM
is skipped with a warning rather than failing the run.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

from ..cluster.der import Segment


class CorpusEntry(NamedTuple):
    recording_id: str
    wav: Path
    rttm: Path


def parse_rttm(path: str | Path) -> list[Segment]:
    """RTTM SPEAKER lines → [(start, end, label)].

    NIST RTTM fields: TYPE FILE CHAN TBEG TDUR ORTHO STYPE NAME CONF
    [SLAT].  Only SPEAKER rows carry diarization reference; other row
    types (LEXEME, NON-SPEECH, ...) are ignored.
    """
    segments: list[Segment] = []
    for lineno, raw in enumerate(Path(path).read_text().splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith((";;", "#")):
            continue
        parts = line.split()
        if parts[0].upper() != "SPEAKER":
            continue
        if len(parts) < 8:
            raise ValueError(f"{path}:{lineno}: malformed RTTM row: {raw!r}")
        try:
            tbeg, tdur = float(parts[3]), float(parts[4])
        except ValueError as e:
            raise ValueError(f"{path}:{lineno}: bad tbeg/tdur: {raw!r}") from e
        if tdur <= 0:
            continue
        segments.append((tbeg, tbeg + tdur, parts[7]))
    segments.sort()
    return segments


def scan_corpus(root: str | Path) -> list[CorpusEntry]:
    """Recursively pair ``<id>.wav`` with ``<id>.rttm`` under ``root``.

    The RTTM may sit next to the wav or anywhere else under the root
    (AMI ships audio/ and rttm/ trees); pairing is by stem.  Entries are
    sorted by recording id for deterministic eval order.
    """
    root = Path(root)
    if not root.is_dir():
        raise FileNotFoundError(f"corpus root is not a directory: {root}")
    rttms: dict[str, Path] = {}
    for p in sorted(root.rglob("*.rttm")):
        rttms.setdefault(p.stem, p)
    entries: list[CorpusEntry] = []
    skipped: list[str] = []
    for wav in sorted(root.rglob("*.wav")):
        rttm = rttms.get(wav.stem)
        if rttm is None:
            skipped.append(wav.stem)
            continue
        entries.append(CorpusEntry(wav.stem, wav, rttm))
    if skipped:
        import sys

        print(
            f"Warning: {len(skipped)} wav(s) without a matching .rttm "
            f"skipped: {', '.join(skipped[:5])}"
            + ("..." if len(skipped) > 5 else ""),
            file=sys.stderr,
        )
    return entries
