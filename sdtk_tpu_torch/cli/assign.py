"""``speaker-assign-gpu`` — ``python -m sdtk_tpu_torch.cli.assign``:
assign / show / apply / clear.

The counterpart of ``sdtk_tpu/cli/assign.py`` (reference
speaker-assign:735-781): the same flags, output and return codes, plus
``--device`` on ``assign`` (default cuda; ``cpu`` runs the plain
versions).  Assignment files are the JAX package's, so ``show``,
``apply`` and ``clear`` read what either package wrote."""

from __future__ import annotations

import argparse

from ..store import assignments as assignment_store
from ..store import catalog as catalog_store
from ..pipeline import assign as engine
from .common import add_device, add_quiet, add_verbose_version, emit_json, err, info, parse_cli


def cmd_assign(args) -> int:
    """Assign; flow/messages mirror reference cmd_assign
    (speaker-assign:499-649): existence checks, 'Found N speakers' line,
    'Processing speaker' verbose lines, dry-run banner, 'Assignments
    saved' summary, optional --output copy."""
    from pathlib import Path

    audio_path = Path(args.audio)
    if not audio_path.exists():
        err(f"Error: Audio file not found: {audio_path.resolve()}")
        return 1
    transcript_path = Path(args.transcript)
    if not transcript_path.exists():
        err(f"Error: Transcript file not found: {transcript_path.resolve()}")
        return 1
    try:
        output = engine.assign(
            args.audio,
            args.transcript,
            use_embeddings=args.use_embeddings,
            use_llm=args.use_llm,
            context=args.context,
            expected_speakers=args.expected_speakers.split(",") if args.expected_speakers else None,
            min_trust=args.min_trust,
            threshold=args.threshold,
            tags=args.tags.split(",") if args.tags else None,
            backend=args.backend,
            cross_backends=(
                args.cross_backends.split(",") if args.cross_backends else None
            ),
            save=not args.dry_run,
            verbose=args.verbose,
            quiet=args.quiet or args.format == "json",
            device=args.device,
        )
    except (FileNotFoundError, ValueError) as e:
        err(e.args[0] if e.args else str(e))
        return 1

    if args.output:
        from ..utils.ioutil import save_yaml

        save_yaml(Path(args.output), output)

    mappings = output["mappings"]

    def _rows() -> None:
        for label, m in mappings.items():
            speaker = m.get("speaker_id") or "(unassigned)"
            print(
                f"  {label} -> {speaker} "
                f"({m.get('confidence', '?')}, score: {m.get('score', 0):.2f})"
            )
            if m.get("candidates"):
                cands = ", ".join(c["speaker_id"] for c in m["candidates"])
                print(f"       candidates: {cands}")

    if args.dry_run:
        print("\n=== DRY RUN - No changes saved ===")
        if args.format == "json":
            emit_json(output)
        else:
            print(f"\nAssignments for: {audio_path.name}")
            print("-" * 50)
            _rows()
        return 0

    if args.format == "json":
        emit_json(output)
    elif not args.quiet:
        print(f"\nAssignments saved: {output['recording_b3sum']}.yaml")
        print("-" * 50)
        assigned = sum(1 for m in mappings.values() if m.get("speaker_id"))
        print(f"Assigned: {assigned}/{len(mappings)}")
        _rows()
    return 0


def cmd_show(args) -> int:
    """Show assignments; output mirrors reference cmd_show
    (speaker-assign:652-700)."""
    b3 = catalog_store.resolve_b3sum(args.audio)
    data = assignment_store.load_assignments(b3) if b3 else None
    if not data:
        err("Error: No assignments found for this recording")
        return 1
    fmt = getattr(args, "format", "text")
    if fmt == "yaml":
        import yaml

        print(yaml.safe_dump(data, sort_keys=False), end="")
    elif fmt == "json":
        emit_json(data)
    else:
        print(f"Assignments for: {b3[:8]}...")
        print(f"Context: {data.get('context') or '-'}")
        print(f"Method: {data.get('method', '-')}")
        print(f"Assigned at: {data.get('assigned_at', '-')}")
        print(f"Threshold: {data.get('threshold', '-')}")
        print(f"Min trust: {data.get('min_trust', '-')}")
        print()
        mappings = data.get("mappings", {})
        if not mappings:
            print("No mappings found")
            return 0
        print("Mappings:")
        for label, m in mappings.items():
            sid = m.get("speaker_id") or "(unassigned)"
            print(f"  {label} -> {sid}")
            print(
                f"       confidence: {m.get('confidence', '?')}, "
                f"score: {m.get('score', 0):.3f}"
            )
            if m.get("signals"):
                print(f"       signals: {len(m['signals'])}")
                for sig in m["signals"][:3]:
                    print(f"         - {sig.get('type', '?')}: {sig.get('score', 0):.2f}")
            if m.get("candidates"):
                cands = ", ".join(
                    f"{c['speaker_id']}({c['score']:.2f})" for c in m["candidates"]
                )
                print(f"       candidates: {cands}")
    return 0


def cmd_apply(args) -> int:
    """Rewrite a transcript's labels using stored assignments (the
    stt_assemblyai_speaker_mapper capability, first-party)."""
    import json

    from ..transcripts.mapper import apply_assignments_to_transcript

    b3 = catalog_store.resolve_b3sum(args.audio)
    data = assignment_store.load_assignments(b3) if b3 else None
    if not data:
        err(f"no assignments for: {args.audio}")
        return 1
    transcript = args.transcript or data.get("transcript_path")
    mapped = apply_assignments_to_transcript(
        transcript, data, output_path=args.output, use_names=not args.ids
    )
    if args.output:
        info(args, f"Wrote mapped transcript: {args.output}")
    else:
        print(json.dumps(mapped, indent=2, ensure_ascii=False))
    return 0


def cmd_clear(args) -> int:
    """Clear assignments; graceful no-op when none exist
    (reference cmd_clear speaker-assign:703-728: rc 0 + stderr notice)."""
    import sys as _sys

    b3 = catalog_store.resolve_b3sum(args.audio)
    if not b3 or not assignment_store.load_assignments(b3):
        print("No assignments found for this recording", file=_sys.stderr)
        return 0
    if not args.force:
        if _sys.stdin.isatty():
            print(f"Clear assignments for: {b3[:8]}...?")
            reply = input("Confirm [y/N]: ")
            if reply.strip().lower() != "y":
                print("Cancelled")
                return 0
    assignment_store.clear_assignments(b3)
    if not args.quiet:
        print(f"Cleared assignments: {b3[:8]}...")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="speaker-assign-gpu",
                                     description="Multi-signal speaker assignment on the GPU")
    add_quiet(parser)
    add_verbose_version(parser)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("assign", help="Assign speaker names to transcript labels")
    p.add_argument("audio")
    p.add_argument("--transcript", "-t", required=True)
    p.add_argument("--use-embeddings", "-e", action="store_true", default=True)
    p.add_argument("--no-embeddings", dest="use_embeddings", action="store_false")
    p.add_argument("--use-llm", "-l", action="store_true")
    p.add_argument("--context", "-c")
    p.add_argument("--expected-speakers")
    p.add_argument("--min-trust", choices=["low", "medium", "high"], default="low")
    # reference speaker-assign:756 defaults the CLI threshold to 0.3
    p.add_argument("--threshold", type=float, default=0.3)
    p.add_argument("--cross-backends",
                   help="Comma list of secondary backends whose agreement "
                        "adds the cross_backend_agreement signal")
    p.add_argument("--tags")
    p.add_argument("--backend", "-b")
    p.add_argument("-n", "--dry-run", action="store_true")
    p.add_argument("--format", "-f", choices=["text", "json"], default="text")
    p.add_argument("-o", "--output")
    add_device(p)
    p.set_defaults(func=cmd_assign)

    p = sub.add_parser("show", help="Show assignments for a recording")
    p.add_argument("audio")
    p.add_argument("--format", "-f", choices=["text", "json", "yaml"],
                   default="text")
    p.set_defaults(func=cmd_show)

    p = sub.add_parser("apply", help="Rewrite transcript labels from assignments")
    p.add_argument("audio")
    p.add_argument("--transcript", "-t", help="Default: path stored in the assignment file")
    p.add_argument("-o", "--output")
    p.add_argument("--ids", action="store_true", help="Map to speaker ids instead of names")
    p.set_defaults(func=cmd_apply)

    p = sub.add_parser("clear", help="Clear assignments for a recording")
    p.add_argument("audio")
    p.add_argument("--force", "-f", action="store_true", help="Skip confirmation")
    p.set_defaults(func=cmd_clear)

    return parser


def main(argv: list[str] | None = None) -> int:
    args = parse_cli(build_parser(), argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
