"""``speaker_samples`` CLI: sample extraction + review state
(reference speaker_samples: extract, segments, list, info, remove,
speakers, review).  A copy of ``sdtk_tpu/cli/samples.py`` over the port's
sample store."""

from __future__ import annotations

import argparse
import json

from ..store import samples as S
from ..transcripts import extract_segments_from_transcript, get_available_speakers, load_transcript
from .common import add_quiet, add_verbose_version, emit_json, err, info, status, table


def _resolve_extract_target(args) -> tuple[str | None, str | None]:
    """Both calling conventions: ours ``extract <speaker_id> <audio>`` and
    the reference's ``extract <audio> -s <speaker_id>``
    (speaker_samples:940-951)."""
    if args.arg2 is not None:
        return args.arg1, args.arg2
    return args.speaker_id_opt, args.arg1


def cmd_extract(args) -> int:
    """Extract voice samples; flow and messages mirror reference
    cmd_extract (speaker_samples:403-504): existence checks, 'Found N
    segments' stderr line, per-sample verbose stdout lines with b3sum,
    'Extracted N samples to <dir>' summary."""
    from pathlib import Path

    from ..transcripts import detect_transcript_format

    speaker_id, audio = _resolve_extract_target(args)
    if not speaker_id:
        err("speaker id required (positional or -s/--speaker-id)")
        return 1
    audio_path = Path(audio)
    if not audio_path.exists():
        err(f"Error: Audio file not found: {audio_path}")
        return 1
    transcript_path = Path(args.transcript)
    if not transcript_path.exists():
        err(f"Error: Transcript file not found: {transcript_path}")
        return 1
    data = load_transcript(transcript_path)
    if detect_transcript_format(data) == "unknown":
        err("Error: Unknown transcript format. Supports AssemblyAI and Speechmatics.")
        return 1
    available = get_available_speakers(data)
    label = args.speaker_label
    if not label:
        err(f"Error: --speaker-label required. Available speakers: {', '.join(available)}")
        return 1
    if label not in available:
        status(f"Warning: Speaker '{label}' not found. Available: {', '.join(available)}")
    segments = extract_segments_from_transcript(
        data, label, min_duration=args.min_duration, max_gap=args.max_gap
    )
    if not segments:
        err(f"No segments found for speaker '{label}'")
        return 1
    total = sum(s["end"] - s["start"] for s in segments)
    status(f"Found {len(segments)} segments for '{label}' ({total:.1f}s total)")

    if args.dry_run:
        n = 0
        total = 0.0
        for seg in segments:
            dur = seg["end"] - seg["start"]
            if args.max_segments and n >= args.max_segments:
                break
            if args.max_duration and total + dur > args.max_duration:
                break
            total += dur
            n += 1
            print(f"Would extract: sample ({seg['start']:.2f}-{seg['end']:.2f}s)")
        return 0
    written = S.extract_samples(
        speaker_id,
        audio,
        segments,
        speaker_label=label,
        transcript_path=args.transcript,
        max_segments=args.max_segments,
        max_duration=args.max_duration,
        output_format=args.format,
    )
    if args.verbose:
        for meta in written:
            seg = meta["segment"]
            print(
                f"Extracted: {meta['sample_id']} "
                f"({seg['start_sec']:.2f}-{seg['end_sec']:.2f}s) "
                f"b3sum:{meta['b3sum'][:8]}"
            )
    print(f"Extracted {len(written)} samples to {S.speaker_samples_dir(speaker_id)}")
    return 0


def cmd_segments(args) -> int:
    transcript = args.transcript_opt or args.transcript
    if not transcript:
        err("transcript required (positional or -t/--transcript)")
        return 1
    data = load_transcript(transcript)
    labels = args.speaker_labels or (
        [args.speaker_label] if args.speaker_label else None
    )
    if labels:
        # Reference JSONL record shape (speaker_samples:536-545)
        for label in labels:
            for seg in extract_segments_from_transcript(
                data, label, min_duration=args.min_duration, max_gap=args.max_gap
            ):
                print(json.dumps({
                    "speaker_id": args.speaker_id_opt or "unknown",
                    "audio": args.audio,
                    "speaker": label,
                    "start": seg["start"],
                    "end": seg["end"],
                    "text": seg.get("text", ""),
                }))
        return 0
    for label in get_available_speakers(data):
        for seg in extract_segments_from_transcript(
            data, label, min_duration=args.min_duration, max_gap=args.max_gap
        ):
            print(json.dumps({"speaker": label, **seg}))
    return 0


def cmd_list(args) -> int:
    metas = S.list_samples(args.speaker_id, review_status=args.review_status)
    if args.offset:
        metas = metas[args.offset :]
    if args.limit:
        metas = metas[: args.limit]
    if args.format == "json":
        emit_json(metas)
        return 0
    rows = [
        [
            m.get("speaker_id", "?"),
            m.get("sample_id", "?"),
            f"{m.get('segment', {}).get('duration_sec', 0):.1f}s",
            m.get("review", {}).get("status", "pending"),
            (m.get("b3sum") or "")[:8],
        ]
        for m in metas
    ]
    print(table(rows, ["SPEAKER", "SAMPLE", "DUR", "REVIEW", "B3SUM"]))
    return 0


def cmd_info(args) -> int:
    for meta in S.get_speaker_samples(args.speaker_id):
        if meta.get("sample_id") == args.sample_id:
            if args.format == "yaml":
                import yaml

                print(yaml.safe_dump(meta, sort_keys=False), end="")
            else:
                emit_json(meta)
            return 0
    err(f"sample '{args.sample_id}' not found for '{args.speaker_id}'")
    return 1


def _remove_one(sdir, sample_id: str, dry_run: bool) -> int:
    removed = 0
    for suffix in (".wav", ".mp3", ".meta.yaml"):
        p = sdir / f"{sample_id}{suffix}"
        if p.exists():
            if not dry_run:
                p.unlink()
            removed += 1
    return removed


def cmd_remove(args) -> int:
    sdir = S.speaker_samples_dir(args.speaker_id)
    if args.sample_id:
        targets = [args.sample_id]
    elif args.all or args.source:
        metas = S.get_speaker_samples(args.speaker_id)
        if args.source:
            metas = [m for m in metas
                     if args.source in str(m.get("source", {}).get("audio_file", ""))]
        targets = [m["sample_id"] for m in metas if m.get("sample_id")]
        if targets and not (args.force or args.dry_run):
            import sys as _sys

            if _sys.stdin.isatty():
                reply = input(f"Remove {len(targets)} sample(s)? [y/N] ")
                if reply.strip().lower() not in ("y", "yes"):
                    info(args, "Aborted")
                    return 1
    else:
        err("sample id, --all, or --source required")
        return 1
    removed = 0
    for sid in targets:
        n = _remove_one(sdir, sid, args.dry_run)
        if n and args.dry_run:
            print(sid)
        removed += 1 if n else 0
    if not removed:
        err("no matching samples")
        return 1
    info(args, f"{'[dry-run] would remove' if args.dry_run else 'Removed'} "
               f"{removed} sample(s)")
    return 0


def cmd_speakers(args) -> int:
    if args.transcript:
        # Reference behavior: list the speakers present in a transcript
        # (speaker_samples:801-815).
        from ..transcripts import detect_transcript_format

        data = load_transcript(args.transcript)
        speakers = get_available_speakers(data)
        print(f"Format: {detect_transcript_format(data)}")
        print(f"Speakers: {', '.join(speakers) if speakers else 'none'}")
        return 0
    from .. import config

    root = config.samples_dir()
    if not root.exists():
        return 0
    for d in sorted(p for p in root.iterdir() if p.is_dir()):
        n = len(list(d.glob("*.meta.yaml")))
        print(f"{d.name}\t{n}")
    return 0


def cmd_review(args) -> int:
    """Approve/reject; output mirrors reference cmd_review
    (speaker_samples:843-921): single sample -> '<id>: <old> -> <new>',
    multiple -> \"Updated N samples to '<status>'\"."""
    status = "reviewed" if args.approve else "rejected" if args.reject else None
    if not status:
        err("Error: Specify --approve or --reject")
        return 1
    sample_id = args.sample_id or args.sample_id_pos
    if not sample_id and not args.source_b3sum:
        err("Error: Specify sample_id or --source-b3sum")
        return 1
    sdir = S.speaker_samples_dir(args.speaker_id)
    if not sdir.exists():
        err(f"Error: No samples found for speaker '{args.speaker_id}'")
        return 1
    updated = S.set_review_status(
        args.speaker_id,
        sample_id=sample_id,
        source_b3sum=args.source_b3sum,
        status=status,
        notes=args.notes,
    )
    if not updated:
        if sample_id:
            err(f"Error: Sample '{sample_id}' not found")
        else:
            err(f"Error: No samples found from source b3sum '{args.source_b3sum}'")
        return 1
    # Review state feeds embedding trust (the feedback loop).
    from ..store.profiles import refresh_trust_levels

    refresh_trust_levels(args.speaker_id)
    if len(updated) == 1 or args.verbose:
        for meta in updated:
            print(f"{meta['sample_id']}: {meta['previous_status']} -> {status}")
    if len(updated) > 1 and not args.verbose:
        print(f"Updated {len(updated)} samples to '{status}'")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="speaker_samples",
                                     description="Audio sample extraction and review")
    add_quiet(parser)
    add_verbose_version(parser)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("extract", help="Extract samples from audio")
    # Dual convention: `extract <speaker_id> <audio>` (ours) or the
    # reference's `extract <audio> -s <speaker_id>` (speaker_samples:940-951)
    p.add_argument("arg1", metavar="audio|speaker_id")
    p.add_argument("arg2", nargs="?", metavar="audio")
    p.add_argument("-s", "--speaker-id", dest="speaker_id_opt",
                   help="Target speaker ID for storage")
    p.add_argument("--transcript", "-t", required=True, help="Transcript JSON file")
    p.add_argument("--speaker-label", "-l", help="Speaker label in transcript")
    p.add_argument("--format", choices=["mp3", "wav"], default="mp3",
                   help="Output format (mp3: Layer III through libmp3lame where the "
                        "host has it, else the first-party Layer II encoder)")
    p.add_argument("--max-segments", type=int, help="Maximum segments to extract")
    p.add_argument("--max-duration", type=float, help="Maximum total duration (sec)")
    p.add_argument("--min-duration", type=float, default=0.5,
                   help="Minimum segment duration (sec)")
    p.add_argument("--max-gap", type=float, default=1.0,
                   help="Max gap to merge segments (sec)")
    p.add_argument("-n", "--dry-run", action="store_true",
                   help="Show what would be extracted")
    p.set_defaults(func=cmd_extract)

    p = sub.add_parser("segments", help="Output segment times as JSONL")
    p.add_argument("transcript", nargs="?")
    p.add_argument("speaker_labels", nargs="*")
    p.add_argument("--transcript", "-t", dest="transcript_opt",
                   help="Transcript JSON file (flag form)")
    p.add_argument("--speaker-label", "-l", help="Speaker label")
    p.add_argument("--speaker-id", "-s", dest="speaker_id_opt",
                   help="Speaker ID for output")
    p.add_argument("--audio", "-a", help="Audio file path (for output)")
    p.add_argument("--min-duration", type=float, default=0.5)
    p.add_argument("--max-gap", type=float, default=1.0)
    p.set_defaults(func=cmd_segments)

    p = sub.add_parser("list", help="List stored samples")
    p.add_argument("speaker_id", nargs="?")
    p.add_argument("--status", "--review-status", dest="review_status",
                   choices=["pending", "reviewed", "rejected"],
                   help="Filter by review status")
    p.add_argument("--show-review", action="store_true",
                   help="Show review status (always shown; kept for parity)")
    p.add_argument("--format", choices=["table", "json"], default="table")
    p.add_argument("--limit", type=int)
    p.add_argument("--offset", type=int, default=0)
    p.set_defaults(func=cmd_list)

    p = sub.add_parser("info", help="Show sample metadata")
    p.add_argument("speaker_id")
    p.add_argument("sample_id")
    p.add_argument("--format", choices=["yaml", "json"], default="yaml",
                   help="Output format (reference default: yaml)")
    p.set_defaults(func=cmd_info)

    p = sub.add_parser("remove", help="Remove samples")
    p.add_argument("speaker_id")
    p.add_argument("sample_id", nargs="?")
    p.add_argument("--all", action="store_true", help="Remove all samples")
    p.add_argument("--source", help="Remove samples from matching source path")
    p.add_argument("-f", "--force", action="store_true", help="Skip confirmation")
    p.add_argument("-n", "--dry-run", action="store_true",
                   help="Show what would be removed")
    p.set_defaults(func=cmd_remove)

    p = sub.add_parser("speakers",
                       help="List speakers in a transcript (or with stored samples)")
    p.add_argument("transcript", nargs="?",
                   help="Transcript JSON file; omit to list stored-sample speakers")
    p.set_defaults(func=cmd_speakers)

    p = sub.add_parser("review", help="Review samples (approve/reject)")
    p.add_argument("speaker_id")
    p.add_argument("sample_id_pos", nargs="?", metavar="sample_id")
    p.add_argument("--sample-id")
    p.add_argument("--source-b3sum",
                   help="Review all samples from source with this b3sum prefix")
    p.add_argument("--approve", action="store_true", help="Mark as reviewed/approved")
    p.add_argument("--reject", action="store_true", help="Mark as rejected")
    p.add_argument("--notes", help="Review notes")
    p.set_defaults(func=cmd_review)

    return parser


def main(argv: list[str] | None = None) -> int:
    from .common import parse_cli

    args = parse_cli(build_parser(), argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
