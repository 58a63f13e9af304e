"""``speaker_segments`` CLI: per-speaker (start, end) extraction
(reference speaker_segments:93-209; json/tuples/csv output, gap merge).
A copy of ``sdtk_tpu/cli/segments.py``."""

from __future__ import annotations

import argparse
import json
import sys

from ..transcripts import (
    extract_segments_as_tuples,
    get_available_speakers,
    load_transcript,
    merge_segments_by_gap,
)


def format_json(segments) -> str:
    return json.dumps([{"start": s, "end": e} for s, e in segments], indent=2)


def format_tuples(segments) -> str:
    return repr(list(segments))


def format_csv(segments) -> str:
    return "\n".join(["start,end"] + [f"{s},{e}" for s, e in segments])


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="speaker_segments",
        description="Extract speaker segment timestamps from transcript JSON files.",
    )
    parser.add_argument("transcript")
    parser.add_argument("speaker", nargs="?")
    parser.add_argument("--format", "-f", choices=["json", "tuples", "csv"], default="json")
    parser.add_argument("--merge-gap", type=float, default=0.0)
    parser.add_argument("--list-speakers", action="store_true")
    args = parser.parse_args(argv)

    try:
        data = load_transcript(args.transcript)
    except FileNotFoundError:
        print(f"Error: transcript not found: {args.transcript}", file=sys.stderr)
        return 1
    except json.JSONDecodeError as e:
        print(f"Error: invalid JSON: {e}", file=sys.stderr)
        return 1

    speakers = get_available_speakers(data)
    if args.list_speakers or not args.speaker:
        for s in speakers:
            print(s)
        return 0

    if args.speaker not in speakers and args.speaker != "UU":
        print(
            f"Error: Speaker '{args.speaker}' not found in transcript "
            f"(available: {', '.join(speakers)})",
            file=sys.stderr,
        )
        return 1

    segments = extract_segments_as_tuples(data, args.speaker)
    if args.merge_gap > 0:
        segments = merge_segments_by_gap(segments, args.merge_gap)

    formatter = {"json": format_json, "tuples": format_tuples, "csv": format_csv}[args.format]
    print(formatter(segments))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
