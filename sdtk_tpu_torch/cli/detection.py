"""``python -m sdtk_tpu_torch.cli.detection`` — speaker profiles and
enroll / identify / verify on the GPU.

The counterpart of ``sdtk_tpu/cli/detection.py`` for the subcommands
``add``, ``list``, ``show``, ``enroll``, ``embeddings``, ``identify`` and
``verify``: same messages and return codes, plus ``--device`` on the
commands that embed audio (default cuda; ``cpu`` runs the plain
versions).  The other subcommands are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .. import config
from ..backends.base import DEFAULT_THRESHOLD
from ..store import profiles as P
from .common import (add_device, add_quiet, emit_json, err, info, parse_kv,
                     parse_segments_arg, status, table)


def cmd_add(args) -> int:
    sid = P.normalize_speaker_id(args.id)
    if not P.validate_speaker_id(sid):
        err(f"invalid speaker id '{args.id}'")
        return 1
    if P.load_speaker(sid):
        err(f"speaker '{sid}' already exists")
        return 1
    P.save_speaker(P.create_speaker_profile(
        sid, args.name, name_contexts=parse_kv(args.name_context), nicknames=args.nickname,
        description=args.description, metadata=parse_kv(args.metadata), tags=args.tag))
    info(args, f"Created speaker '{sid}'")
    return 0


def cmd_list(args) -> int:
    speakers = P.list_all_speakers()
    if args.tags:
        speakers = P.filter_speakers_by_tags(speakers, [t.strip() for t in args.tags.split(",")])
    if args.any_tag:
        speakers = P.filter_speakers_by_tags(
            speakers, [t.strip() for t in args.any_tag.split(",")], any_tag=True)
    if args.offset:
        speakers = speakers[args.offset :]
    if args.limit:
        speakers = speakers[: args.limit]
    if args.format == "json":
        emit_json(speakers)
    elif args.format == "ids":
        for s in speakers:
            print(s["id"])
    else:
        rows = []
        for s in speakers:
            names = s.get("names", {})
            name = (names.get(args.context) if args.context else None) or names.get("default", "")
            n_emb = sum(len(v) for v in s.get("embeddings", {}).values())
            rows.append([s["id"], name, ",".join(s.get("tags", [])), n_emb])
        print(table(rows, ["ID", "NAME", "TAGS", "EMBEDDINGS"]))
    return 0


def cmd_show(args) -> int:
    profile = P.load_speaker(P.normalize_speaker_id(args.id))
    if not profile:
        err(f"speaker '{args.id}' not found")
        return 1
    if args.format == "yaml":
        import yaml

        print(yaml.safe_dump(profile, default_flow_style=False, allow_unicode=True))
    else:
        emit_json(profile)
    return 0


def _read_stdin_segments() -> list[tuple[float, float]]:
    """JSONL lines with "start" and "end" fields."""
    segments = []
    for line in sys.stdin:
        line = line.strip()
        if line:
            d = json.loads(line)
            if d.get("start") is not None and d.get("end") is not None:
                segments.append((float(d["start"]), float(d["end"])))
    return segments


def cmd_enroll(args) -> int:
    from ..pipeline import identify as engine

    sid = P.normalize_speaker_id(args.id)
    if not P.load_speaker(sid):
        err(f"Error: Speaker '{sid}' not found. Use 'add' first.")
        return 1
    audio_path = Path(args.audio)
    if not audio_path.exists():
        err(f"Error: Audio file not found: {audio_path}")
        return 1
    backend_name = args.backend or config.default_backend()

    segments = None
    if args.segments:
        try:
            segments = parse_segments_arg(args.segments)
        except ValueError as e:
            err(f"Error: {e}")
            return 1
    elif args.from_transcript:
        transcript_path = Path(args.from_transcript)
        if not transcript_path.exists():
            err(f"Error: Transcript file not found: {transcript_path}")
            return 1
        if not args.speaker_label:
            err("Error: --speaker-label required with --from-transcript")
            return 1
        from ..transcripts import extract_segments_as_tuples, load_transcript

        try:
            segments = extract_segments_as_tuples(load_transcript(transcript_path),
                                                  args.speaker_label)
        except Exception as e:  # noqa: BLE001 — CLI boundary
            err(f"Error extracting segments: {e}")
            return 1
        if not segments:
            err(f"Error: No segments found for speaker '{args.speaker_label}' in transcript.")
            return 1
        total = sum(e - s for s, e in segments)
        status(f"Found {len(segments)} segments for speaker "
               f"'{args.speaker_label}' ({total:.1f}s total)")
    elif args.from_stdin:
        try:
            segments = _read_stdin_segments()
        except json.JSONDecodeError as e:
            err(f"Error parsing JSONL from stdin: {e}")
            return 1
        if not segments:
            err("Error: No segments read from stdin. Provide JSONL with 'start' and 'end' fields.")
            return 1
        total = sum(e - s for s, e in segments)
        status(f"Read {len(segments)} segments from stdin ({total:.1f}s total)")

    if args.dry_run:
        print(f"Would enroll speaker: {sid}")
        print(f"  Audio: {audio_path}")
        print(f"  Backend: {backend_name}")
        if segments:
            total = sum(e - s for s, e in segments)
            print(f"  Segments: {len(segments)} ({total:.1f}s total)")
            for i, (s, e) in enumerate(segments[:5]):
                print(f"    {i + 1}. {s:.2f}s - {e:.2f}s ({e - s:.2f}s)")
            if len(segments) > 5:
                print(f"    ... and {len(segments) - 5} more")
        return 0

    try:
        rec = engine.enroll(args.id, args.audio, backend_name=args.backend, segments=segments,
                            device=args.device)
    except (KeyError, ValueError, FileNotFoundError) as e:
        err(e.args[0] if e.args else str(e))
        return 1
    if args.trust_level:
        profile = P.load_speaker(sid)
        for recs in profile.get("embeddings", {}).values():
            for r in recs:
                if r["id"] == rec["id"]:
                    r["trust_level"] = args.trust_level
        P.save_speaker(profile)
    info(args, f"Enrolled '{args.id}': embedding {rec['id']} (trust: {rec['trust_level']})")
    return 0


def cmd_embeddings(args) -> int:
    profile = P.load_speaker(P.normalize_speaker_id(args.id))
    if not profile:
        err(f"Error: Speaker '{args.id}' not found.")
        return 1
    embeddings = profile.get("embeddings", {})
    if args.backend:
        embeddings = {args.backend: embeddings[args.backend]} if args.backend in embeddings else {}
    if not embeddings:
        print("No embeddings found.")
        return 0
    for backend, recs in embeddings.items():
        print(f"\n{backend}:")
        for r in recs:
            created = (r.get("created_at") or "unknown")[:19]
            source = r.get("source_audio") or "unknown"
            if len(source) > 50:
                source = "..." + source[-47:]
            line = f"  {r['id']}  {created}  {source}"
            if args.show_trust:
                samples = r.get("samples", {}) or {}
                line += (f"  [{r.get('trust_level', 'unknown')}]"
                         f" ({len(samples.get('reviewed', []))}r"
                         f"/{len(samples.get('unreviewed', []))}u"
                         f"/{len(samples.get('rejected', []))}x)")
            print(line)
    return 0


def cmd_identify(args) -> int:
    from ..pipeline import identify as engine

    audio_path = Path(args.audio)
    if not audio_path.exists():
        err(f"Error: Audio file not found: {audio_path}")
        return 1
    backend_name = args.backend or config.default_backend()
    speakers = P.list_all_speakers()
    tags = [t.strip() for t in args.tags.split(",")] if args.tags else None
    if tags:
        speakers = P.filter_speakers_by_tags(speakers, tags, any_tag=False)
    if not speakers:
        err("No speakers to match against.")
        return 1
    candidates = [s for s in speakers if s.get("embeddings", {}).get(backend_name)]
    if not candidates:
        err(f"No speakers with {backend_name} embeddings.")
        return 1
    status(f"Identifying speaker in {audio_path.name} against {len(candidates)} candidates...")
    try:
        results = engine.identify(args.audio, backend_name=args.backend,
                                  threshold=args.threshold, tags=tags, device=args.device)
    except Exception as e:  # noqa: BLE001 — CLI boundary
        err(f"Error during identification: {e}")
        return 1
    if not results:
        print("[]" if args.format == "json" else "No matching speakers found.")
        return 0
    if args.format == "json":
        emit_json(results)
    else:
        print("\nMatches:")
        for item in results:
            print(f"  {item['speaker_id']}: {item['name']} (confidence: {item['score']:.2f})")
    return 0


def cmd_verify(args) -> int:
    from ..pipeline import identify as engine

    try:
        result = engine.verify(args.id, args.audio, backend_name=args.backend,
                               threshold=args.threshold, device=args.device)
    except (KeyError, ValueError) as e:
        err(e.args[0] if e.args else str(e))
        return 1
    if result["match"]:
        print(f"MATCH: Speaker '{args.id}' verified (confidence: {result['confidence']:.2f})")
        return 0
    print(f"NO MATCH: Audio does not match speaker '{args.id}'")
    return 1


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="sdtk_tpu_torch.cli.detection",
        description="Speaker profile management and identification on the GPU")
    add_quiet(parser)
    sub = parser.add_subparsers(dest="command", required=True)

    def command(name: str, help_text: str, func) -> argparse.ArgumentParser:
        p = sub.add_parser(name, help=help_text)
        # -q after the subcommand too; SUPPRESS keeps one given before it
        p.add_argument("-q", "--quiet", action="store_true", default=argparse.SUPPRESS,
                       help=argparse.SUPPRESS)
        p.set_defaults(func=func)
        return p

    p = command("add", "Add a new speaker", cmd_add)
    p.add_argument("id")
    p.add_argument("--name", required=True)
    p.add_argument("--name-context", action="append", metavar="CTX=NAME")
    p.add_argument("--nickname", action="append")
    p.add_argument("--description")
    p.add_argument("--tag", action="append")
    p.add_argument("--metadata", action="append", metavar="KEY=VALUE")

    p = command("list", "List speakers", cmd_list)
    p.add_argument("--tags")
    p.add_argument("--any-tag")
    p.add_argument("--format", choices=["table", "json", "ids"], default="table")
    p.add_argument("--context")
    p.add_argument("--limit", type=int)
    p.add_argument("--offset", type=int, default=0)

    p = command("show", "Show speaker details", cmd_show)
    p.add_argument("id")
    p.add_argument("--format", choices=["json", "yaml"], default="json")

    p = command("enroll", "Enroll speaker from audio", cmd_enroll)
    p.add_argument("id")
    p.add_argument("audio")
    p.add_argument("--backend", "-b")
    p.add_argument("--segments", "-s", help='Time ranges, e.g. "0-5,10.5-15"')
    p.add_argument("--from-transcript", "-t", metavar="JSON",
                   help="Transcript JSON (AssemblyAI or Speechmatics) to take segments from")
    p.add_argument("--speaker-label", "-l")
    p.add_argument("--from-stdin", action="store_true")
    p.add_argument("-n", "--dry-run", action="store_true")
    p.add_argument("--trust-level", choices=["high", "medium", "low"])
    add_device(p)

    p = command("embeddings", "List speaker embeddings", cmd_embeddings)
    p.add_argument("id")
    p.add_argument("--backend", "-b")
    p.add_argument("--show-trust", action="store_true")

    p = command("identify", "Identify speaker in audio", cmd_identify)
    p.add_argument("audio")
    p.add_argument("--backend", "-b")
    p.add_argument("--tags")
    p.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD)
    p.add_argument("--format", "-f", choices=["text", "json"], default="text")
    add_device(p)

    p = command("verify", "Verify speaker in audio", cmd_verify)
    p.add_argument("id")
    p.add_argument("audio")
    p.add_argument("--backend", "-b")
    p.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD)
    add_device(p)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
