"""``speaker-catalog`` CLI: recording inventory + contexts
(reference speaker-catalog command tree).  A copy of
``sdtk_tpu/cli/catalog.py`` over the port's store and jqlite."""

from __future__ import annotations

import argparse
import json

from ..store import catalog as C
from .common import add_quiet, add_verbose_version, emit_json, err, info, table


def _resolve(ref: str) -> str | None:
    return C.resolve_b3sum(ref)


def cmd_add(args) -> int:
    try:
        entry = C.add_recording(
            args.audio,
            context=args.context,
            tags=args.tags.split(",") if args.tags else None,
            force=args.force,
        )
    except FileNotFoundError:
        err(f"audio file not found: {args.audio}")
        return 1
    except FileExistsError as e:
        err(f"recording already in catalog (b3sum: {e}); use --force to update")
        return 1
    rec = entry["recording"]
    if not args.quiet:
        # stdout confirmation block (reference speaker-catalog:287-294)
        from pathlib import Path as _P

        print(f"Added: {_P(rec['path']).name}")
        print(f"  b3sum: {rec['b3sum']}")
        if rec.get("duration_sec"):
            print(f"  duration: {rec['duration_sec']:.1f}s")
        if args.context:
            print(f"  context: {args.context}")
    return 0


def cmd_list(args) -> int:
    entries = C.list_entries()
    if args.status:
        entries = [e for e in entries if C.compute_status(e) == args.status]
    if args.context:
        entries = [e for e in entries if e.get("context", {}).get("name") == args.context]
    if args.needs_review:
        # Anything mid-pipeline needs attention (reference :317-319)
        entries = [
            e for e in entries
            if C.compute_status(e) not in ("complete", "unprocessed")
        ]
    if args.offset:
        entries = entries[args.offset:]
    if args.limit:
        entries = entries[: args.limit]
    # flat row shape (reference cmd_list :320-328): b3sum, path, status,
    # context (name string), transcriptions (count), duration_sec
    rows = [
        {
            "b3sum": e["recording"]["b3sum"],
            "path": e["recording"].get("path", ""),
            "status": C.compute_status(e),
            "context": e.get("context", {}).get("name"),
            "transcriptions": len(e.get("transcriptions", [])),
            "duration_sec": e["recording"].get("duration_sec"),
        }
        for e in entries
    ]
    if args.format == "json":
        emit_json(rows)
    elif args.format == "ids":
        for r in rows:
            print(r["b3sum"])
    elif args.format == "paths":
        for r in rows:
            print(r["path"])
    else:
        if not rows:
            print("No recordings in catalog")
            return 0
        from pathlib import Path as _P

        out = [
            [
                r["b3sum"][:8],
                r["status"],
                r["context"] or "-",
                str(r["transcriptions"]),
                _P(r["path"]).name if r["path"] else "-",
            ]
            for r in rows
        ]
        print(table(out, ["B3SUM", "Status", "Context", "Trans", "Path"]))
        print(f"\nTotal: {len(rows)} recording(s)")
    return 0


def cmd_show(args) -> int:
    b3 = _resolve(args.audio)
    entry = C.load_entry(b3) if b3 else None
    if not entry:
        err(f"not in catalog: {args.audio}")
        return 1
    entry["status"] = C.compute_status(entry)
    if args.format == "yaml":
        import yaml

        print(yaml.safe_dump(entry, sort_keys=False, allow_unicode=True), end="")
    elif args.format == "text":
        # Human-readable form (reference :405-439)
        rec = entry.get("recording", {})
        ctx = entry.get("context", {})
        from pathlib import Path as _P

        print(f"Recording: {_P(rec.get('path', '')).name}")
        print(f"  Path: {rec.get('path', '-')}")
        print(f"  B3SUM: {rec.get('b3sum', '-')}")
        if rec.get("duration_sec"):
            d = rec["duration_sec"]
            print(f"  Duration: {int(d // 60)}m {int(d % 60)}s ({d:.1f}s)")
        print(f"  Status: {entry['status']}")
        if ctx.get("name"):
            print(f"  Context: {ctx['name']}")
        if ctx.get("expected_speakers"):
            print(f"  Expected speakers: {', '.join(ctx['expected_speakers'])}")
        if ctx.get("tags"):
            print(f"  Tags: {', '.join(ctx['tags'])}")
        for t in entry.get("transcriptions", []):
            print(f"  Transcript [{t.get('backend')}]: {t.get('path')} "
                  f"({t.get('speaker_count', '?')} speakers)")
    else:
        emit_json(entry)
    return 0


def cmd_status(args) -> int:
    b3 = _resolve(args.audio)
    entry = C.load_entry(b3) if b3 else None
    if not entry:
        err(f"not in catalog: {args.audio}")
        return 1
    status = C.compute_status(entry)
    if args.format == "json":
        print(json.dumps({"status": status}))
    else:
        print(status)
    return 0


def cmd_register_transcript(args) -> int:
    transcript = args.transcript or args.transcript_opt
    if not transcript:
        err("transcript required (positional or -t/--transcript)")
        return 1
    b3 = _resolve(args.audio)
    if not b3:
        err(f"not in catalog: {args.audio}")
        return 1
    try:
        entry = C.register_transcript(
            b3, transcript, args.backend, force=args.force,
            version=args.version, tool_version=args.tool_version,
        )
    except KeyError:
        err(f"not in catalog: {args.audio}")
        return 1
    except FileExistsError as e:
        err(f"{e}; use --force to replace")
        return 1
    t = entry["transcriptions"][-1]
    if not args.quiet:
        # stdout confirmation (reference cmd_register_transcript :536-546)
        from pathlib import Path as _P

        print(f"Registered transcript: {_P(str(transcript)).name}")
        print(f"  Backend: {args.backend}")
        print(f"  Speakers detected: {t['speaker_count']}")
    return 0


def cmd_set_context(args) -> int:
    b3 = _resolve(args.audio)
    if not b3:
        err(f"not in catalog: {args.audio}")
        return 1
    context = args.context if args.context is not None else args.context_opt
    expected = args.expected_speakers.split(",") if args.expected_speakers else None
    add_tags = [t.strip() for t in args.tags.split(",")] if args.tags else None
    remove_tags = (
        [t.strip() for t in args.remove_tags.split(",")] if args.remove_tags else None
    )
    if context is None and not (expected or add_tags or remove_tags):
        err("nothing to set (need a context, --expected-speakers, or tags)")
        return 1
    C.set_context(b3, context, expected, add_tags=add_tags, remove_tags=remove_tags)
    if not args.quiet:
        # stdout confirmation (reference cmd_set_context :592-597)
        from pathlib import Path as _P

        entry = C.load_entry(b3)
        name = _P(entry["recording"].get("path", b3)).name if entry else b3
        print(f"Updated context for: {name}")
        if context:
            print(f"  Context: {context}")
        if args.expected_speakers:
            print(f"  Expected speakers: {args.expected_speakers}")
    return 0


def cmd_remove(args) -> int:
    """Remove; confirmation prompt + messages mirror reference cmd_remove
    (speaker-catalog:601-652)."""
    import sys as _sys
    from pathlib import Path as _P

    b3 = _resolve(args.audio)
    entry = C.load_entry(b3) if b3 else None
    if not entry:
        err(f"Error: Recording not in catalog: {args.audio}")
        return 1
    if not args.force and _sys.stdin.isatty():
        rec_path = entry.get("recording", {}).get("path", "")
        print(f"Remove from catalog: {_P(rec_path).name}?")
        print(f"  B3SUM: {b3}")
        if input("Confirm [y/N]: ").lower() != "y":
            print("Cancelled")
            return 0
    from ..store import assignments as assignment_store

    had_assignments = assignment_store.load_assignments(b3) is not None
    C.remove_recording(b3)
    if not args.quiet:
        if had_assignments:
            print("Also removed associated assignments")
        print(f"Removed: {b3}")
    return 0


def cmd_query(args) -> int:
    entries = C.list_entries()
    for e in entries:
        e["status"] = C.compute_status(e)
    from ..utils.jqlite import JqError, query_lines

    try:
        out = query_lines(args.expression, entries)
    except JqError as e:
        err(str(e))
        return 1
    if out:
        print(out)
    return 0


def cmd_create_context(args) -> int:
    try:
        ctx = C.create_context(
            args.name,
            speakers=[s.strip() for s in args.speakers.split(",")] if args.speakers else None,
            description=args.description,
            force=args.force,
        )
    except FileExistsError:
        err(f"context '{args.name}' already exists; use --force to overwrite")
        return 1
    n = len(ctx["expected_speakers"])
    info(args, f"Created context '{args.name}'" + (f" with {n} expected speaker(s)" if n else ""))
    return 0


def cmd_list_contexts(args) -> int:
    contexts = C.load_contexts()
    if args.format == "json":
        emit_json(contexts)
        return 0
    if not contexts:
        print("No contexts defined.")
        return 0
    print("Contexts:")
    for name, ctx in sorted(contexts.items()):
        speakers = ctx.get("expected_speakers", [])
        desc = f"{len(speakers)} speaker(s)"
        if speakers:
            desc += ": " + ", ".join(speakers)
        print(f"  {name:<16} {desc}")
    return 0


def cmd_show_context(args) -> int:
    ctx = C.get_context(args.name)
    if not ctx:
        err(f"context '{args.name}' not found")
        return 1
    if args.format == "json":
        emit_json({args.name: ctx})
        return 0
    print(f"Context: {args.name}")
    if ctx.get("description"):
        print(f"  Description: {ctx['description']}")
    speakers = ctx.get("expected_speakers", [])
    print(f"  Expected speakers: {', '.join(speakers) if speakers else 'none'}")
    return 0


def cmd_context_add_speaker(args) -> int:
    try:
        C.context_add_speaker(args.name, args.speaker_id)
    except KeyError:
        err(f"context '{args.name}' not found")
        return 1
    info(args, f"Added '{args.speaker_id}' to context '{args.name}'")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="speaker-catalog",
                                     description="Recording inventory and processing state")
    add_quiet(parser)
    add_verbose_version(parser)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("add", help="Add a recording")
    p.add_argument("audio")
    p.add_argument("--context", "-c")
    p.add_argument("--tags", "-t", help="Comma-separated tags")
    p.add_argument("--force", "-f", action="store_true")
    p.set_defaults(func=cmd_add)

    p = sub.add_parser("list", help="List recordings")
    p.add_argument("--status", "-s", choices=C.STATUS_VALUES)
    p.add_argument("--context", "-c")
    p.add_argument("--needs-review", "-r", action="store_true",
                   help="Show only recordings needing review")
    p.add_argument("--format", "-f", choices=["table", "json", "ids", "paths"],
                   default="table")
    p.add_argument("--limit", type=int, help="Maximum results to show")
    p.add_argument("--offset", type=int, default=0, help="Skip first N results")
    p.set_defaults(func=cmd_list)

    p = sub.add_parser("show", help="Show catalog entry")
    p.add_argument("audio", help="Audio path or b3sum prefix")
    p.add_argument("--format", "-f", choices=["text", "json", "yaml"],
                   default="text")
    p.set_defaults(func=cmd_show)

    p = sub.add_parser("status", help="Show processing status")
    p.add_argument("audio")
    p.add_argument("--format", "-f", choices=["text", "json"], default="text")
    p.set_defaults(func=cmd_status)

    p = sub.add_parser("register-transcript", help="Attach a transcript")
    p.add_argument("audio")
    p.add_argument("transcript", nargs="?",
                   help="Transcript file (or use -t/--transcript)")
    p.add_argument("--transcript", "-t", dest="transcript_opt",
                   help="Path to transcript JSON file (reference flag form)")
    p.add_argument("--backend", "-b", required=True)
    p.add_argument("--version", help="Backend version string")
    p.add_argument("--tool-version", help="Tool version that created transcript")
    p.add_argument("--force", "-f", action="store_true")
    p.set_defaults(func=cmd_register_transcript)

    p = sub.add_parser("set-context", help="Set recording context")
    p.add_argument("audio")
    p.add_argument("context", nargs="?",
                   help="Context name (or use -c/--context)")
    p.add_argument("--context", "-c", dest="context_opt",
                   help="Context name (reference flag form)")
    p.add_argument("--expected-speakers", "-e",
                   help="Comma-separated expected speaker IDs")
    p.add_argument("--tags", "-t", help="Comma-separated tags to add")
    p.add_argument("--remove-tags", help="Comma-separated tags to remove")
    p.set_defaults(func=cmd_set_context)

    p = sub.add_parser("remove", help="Remove a recording")
    p.add_argument("audio")
    p.add_argument("--force", "-f", action="store_true")
    p.set_defaults(func=cmd_remove)

    p = sub.add_parser("query", help="Query entries with jq")
    p.add_argument("expression")
    p.set_defaults(func=cmd_query)

    p = sub.add_parser("create-context", help="Create a context")
    p.add_argument("name")
    p.add_argument("--speakers", "-s", help="Comma-separated expected speaker IDs")
    p.add_argument("--description", "-d")
    p.add_argument("--force", "-f", action="store_true")
    p.set_defaults(func=cmd_create_context)

    p = sub.add_parser("list-contexts", help="List contexts")
    p.add_argument("--format", "-f", choices=["text", "table", "json"],
                   default="text")
    p.set_defaults(func=cmd_list_contexts)

    p = sub.add_parser("show-context", help="Show a context")
    p.add_argument("name")
    p.add_argument("--format", "-f", choices=["text", "json"], default="text")
    p.set_defaults(func=cmd_show_context)

    p = sub.add_parser("context-add-speaker", help="Add expected speaker to context")
    p.add_argument("name")
    p.add_argument("speaker_id")
    p.set_defaults(func=cmd_context_add_speaker)

    return parser


def main(argv: list[str] | None = None) -> int:
    from .common import parse_cli

    args = parse_cli(build_parser(), argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
