"""Diarization error rate on synthetic meetings, or on a WAV + RTTM corpus.

The counterpart of ``evals/benchmark_der.py``: K-speaker meetings with a
known reference (the training-family generator, or with ``--heldout``
the held-out family of ``data/synth_heldout.py`` under a channel tier),
or with ``--corpus DIR`` every ``<id>.wav`` + ``<id>.rttm`` pair under DIR
(``data/corpus.py``), through the port's ``Diarizer`` on ``--device``
(default cuda); DER at every collar of ``--collars``.

Usage: python -m sdtk_tpu_torch.evals.der [--backend fake|gpu] [--meetings 3]
       [--heldout] [--tier clean] [--corpus DIR] [--device cuda]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def build_meeting(meeting_id: int, n_speakers: int, n_turns: int, turn_s: float,
                  heldout: bool = False, tier: str = "clean",
                  snr_db: float = 15.0, overlap_frac: float = 0.0,
                  gap_frac: float = 0.0, sr: int = 16000):
    """(waveform, reference segments) of a synthetic meeting.  ``heldout``
    draws the voices from the held-out family and applies ``tier`` to the
    whole meeting.  ``overlap_frac``: the chance that a turn starts
    0.4-1.2 s before the previous one ends (the reference keeps both
    intervals); ``gap_frac``: the chance of a 1-3 s gap before a turn."""
    from ..data.synth import synth_utterance
    from ..data.synth_heldout import apply_tier, heldout_utterance

    make = heldout_utterance if heldout else synth_utterance
    rng = np.random.default_rng(500 + meeting_id)
    placed = []  # (t_start, waveform)
    ref = []
    t = 0.0
    prev = -1
    for turn in range(n_turns):
        spk = int(rng.integers(n_speakers))
        if spk == prev:
            spk = (spk + 1) % n_speakers
        prev = spk
        dur = float(rng.uniform(turn_s * 0.7, turn_s * 1.3))
        start = t
        if turn > 0 and gap_frac > 0 and rng.uniform() < gap_frac:
            start = t + float(rng.uniform(1.0, 3.0))
        if turn > 0 and overlap_frac > 0 and rng.uniform() < overlap_frac:
            start = max(0.0, t - float(rng.uniform(0.4, 1.2)))
        piece = make(spk, 1000 * meeting_id + turn, dur)
        placed.append((start, piece))
        ref.append((start, start + dur, f"SPK{spk}"))
        t = start + dur
    wav = np.zeros(int(np.ceil(t * sr)) + 1, dtype=np.float64)
    for start, piece in placed:
        a = int(start * sr)
        wav[a : a + len(piece)] += piece
    peak = np.max(np.abs(wav)) + 1e-9
    wav = (0.5 * wav / peak).astype(np.float32)
    if heldout and tier != "clean":
        wav = apply_tier(wav, tier, seed=meeting_id, snr_db=snr_db)
    return wav, ref


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="sdtk_tpu_torch.evals.der")
    p.add_argument("--backend", default="fake")
    p.add_argument("--meetings", type=int, default=3)
    p.add_argument("--speakers", type=int, default=3)
    p.add_argument("--turns", type=int, default=10)
    p.add_argument("--turn-seconds", type=float, default=3.0)
    p.add_argument("--collar", type=float, default=0.75, help="Primary collar (headline fields)")
    p.add_argument("--collars", default="0.75,0.25",
                   help="Comma-separated collars, all scored from one diarization pass")
    p.add_argument("--no-boundary-refine", action="store_true",
                   help="Disable sub-window boundary localization (cluster/boundary.py)")
    p.add_argument("--window", type=float, default=1.0)
    p.add_argument("--hop", type=float, default=0.375)
    p.add_argument("--known-k", action="store_true",
                   help="give the diarizer the true speaker count")
    p.add_argument("--heldout", action="store_true",
                   help="held-out generator family (non-circular eval)")
    p.add_argument("--tier", default="clean",
                   choices=["clean", "noise", "reverb", "telephone", "music"])
    p.add_argument("--gap-frac", type=float, default=0.0,
                   help="Probability of a 1-3 s silence gap before a turn")
    p.add_argument("--vad", default="auto", choices=["auto", "energy", "trained"],
                   help="Diarizer speech gate (DiarizeConfig.vad)")
    p.add_argument("--snr-db", type=float, default=15.0)
    p.add_argument("--overlap-frac", type=float, default=0.0,
                   help="Probability a turn overlaps the previous one (0.4-1.2 s)")
    p.add_argument("--detect-overlap", action="store_true",
                   help="Run the secondary-speaker detector and score its overlap "
                        "segments as hypothesis speech")
    p.add_argument("--corpus", default=None, metavar="DIR",
                   help="Score a directory of <id>.wav + <id>.rttm pairs instead of "
                        "synthetic meetings (data/corpus.py)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)

    from ..cluster.der import diarization_error_rate
    from ..pipeline.diarize import DiarizeConfig, Diarizer

    cfg = DiarizeConfig(n_speakers=args.speakers if args.known_k else None,
                        max_speakers=max(8, args.speakers),
                        window_seconds=args.window, hop_seconds=args.hop,
                        detect_overlap=args.detect_overlap, vad=args.vad,
                        boundary_refine=not args.no_boundary_refine)
    d = Diarizer(args.backend, cfg, device=args.device)

    if args.corpus:
        from ..data.corpus import parse_rttm, scan_corpus

        entries = scan_corpus(args.corpus)
        if not entries:
            print(json.dumps({"error": f"no wav+rttm pairs under {args.corpus}"}))
            return 1
        meetings = [(e.recording_id, None, parse_rttm(e.rttm), e.wav) for e in entries]
    else:
        meetings = []
        for m in range(args.meetings):
            wav, ref = build_meeting(
                m, args.speakers, args.turns, args.turn_seconds,
                heldout=args.heldout, tier=args.tier, snr_db=args.snr_db,
                overlap_frac=args.overlap_frac, gap_frac=args.gap_frac)
            meetings.append((f"synth-{m}", wav, ref, None))

    collars = sorted({float(c) for c in args.collars.split(",") if c} | {args.collar},
                     reverse=True)
    by_collar: dict[float, dict[str, list]] = {
        c: {"der": [], "miss": [], "fa": [], "conf": []} for c in collars}
    per_recording = {}
    audio_seconds = 0.0
    t0 = time.time()
    for rec_id, wav, ref, wav_path in meetings:
        if wav is None:
            result = d.diarize_file(wav_path)
            audio_seconds += result["duration"]
        else:
            audio_seconds += len(wav) / 16000
            result = d.diarize_waveform(wav)
        hyp = list(result["segments"])
        if args.detect_overlap:
            hyp += list(result.get("overlap_segments", []))
        for c in collars:
            metrics = diarization_error_rate(ref, hyp, collar=c)
            acc = by_collar[c]
            acc["der"].append(metrics["der"])
            acc["miss"].append(metrics["miss"])
            acc["fa"].append(metrics["false_alarm"])
            acc["conf"].append(metrics["confusion"])
            if c == args.collar:
                per_recording[rec_id] = round(metrics["der"], 4)
    wall = time.time() - t0
    head = by_collar[args.collar]

    out = {
        "benchmark": "der",
        "backend": args.backend,
        "generator": (f"corpus:{args.corpus}" if args.corpus
                      else "heldout" if args.heldout else "train-family"),
        "tier": args.tier if args.heldout else "clean",
        "meetings": len(meetings),
        "speakers": args.speakers,
        "overlap_frac": args.overlap_frac,
        "gap_frac": args.gap_frac,
        "vad": args.vad,
        "detect_overlap": bool(args.detect_overlap),
        "mean_der": round(float(np.mean(head["der"])), 4),
        "max_der": round(float(np.max(head["der"])), 4),
        "mean_miss": round(float(np.mean(head["miss"])), 4),
        "mean_false_alarm": round(float(np.mean(head["fa"])), 4),
        "mean_confusion": round(float(np.mean(head["conf"])), 4),
        "collar": args.collar,
        "boundary_refine": not args.no_boundary_refine,
        "by_collar": {
            str(c): {
                "mean_der": round(float(np.mean(acc["der"])), 4),
                "max_der": round(float(np.max(acc["der"])), 4),
                "mean_miss": round(float(np.mean(acc["miss"])), 4),
                "mean_false_alarm": round(float(np.mean(acc["fa"])), 4),
                "mean_confusion": round(float(np.mean(acc["conf"])), 4),
            }
            for c, acc in by_collar.items()
        },
        "audio_seconds": round(audio_seconds, 1),
        "wall_seconds": round(wall, 2),
        "audio_s_per_s": round(audio_seconds / wall, 1),
    }
    if args.corpus:
        out["per_recording_der"] = per_recording
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
