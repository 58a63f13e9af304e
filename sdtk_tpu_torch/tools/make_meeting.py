"""Write a synthetic same-family meeting and its reference RTTM.

``python -m sdtk_tpu_torch.tools.make_meeting OUT_DIR --id 7 --turns 1200``
writes ``OUT_DIR/meeting.wav`` (16 kHz, 16-bit) and ``OUT_DIR/meeting.rttm``
(recording id ``meeting``) from ``data/synth.py:build_meeting``: the same
audio and reference for the same arguments, so either package's
``speaker-diarize --eval-rttm`` can score itself on it.  1 200 turns of
3 s make about an hour.  Prints one JSON line: the files and the audio's
length.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..data.synth import build_meeting
from ..pipeline.diarize import to_rttm
from ..utils.audio import save_wav


def write_meeting(out_dir: str | Path, meeting_id: int = 0, n_speakers: int = 3,
                  n_turns: int = 20, turn_s: float = 3.0, name: str = "meeting"
                  ) -> tuple[Path, Path, float]:
    """(WAV path, RTTM path, audio seconds) of the meeting written."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    wav, ref = build_meeting(meeting_id, n_speakers, n_turns, turn_s)
    wav_path, rttm_path = out_dir / f"{name}.wav", out_dir / f"{name}.rttm"
    save_wav(wav_path, wav)
    rttm_path.write_text(to_rttm({"segments": ref}, recording_id=name))
    return wav_path, rttm_path, len(wav) / 16000


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="sdtk_tpu_torch.tools.make_meeting", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("out_dir")
    p.add_argument("--id", type=int, default=0, help="meeting id (the synthesis seed)")
    p.add_argument("--speakers", type=int, default=3)
    p.add_argument("--turns", type=int, default=20)
    p.add_argument("--turn-seconds", type=float, default=3.0)
    p.add_argument("--name", default="meeting")
    args = p.parse_args(argv)
    wav, rttm, seconds = write_meeting(args.out_dir, args.id, args.speakers, args.turns,
                                       args.turn_seconds, args.name)
    print(json.dumps({"wav": str(wav), "rttm": str(rttm), "audio_seconds": seconds}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
