"""``speaker-process-gpu`` — ``python -m sdtk_tpu_torch.cli.process``:
process / queue / run / status / clear-queue.

The counterpart of ``sdtk_tpu/cli/process.py`` (reference
speaker-process:866-938): the same flags, output and return codes and the
same ``process_queue.yaml``, plus ``--device`` on ``process`` and ``run``
(default cuda; ``cpu`` runs the plain versions)."""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..pipeline import process as proc
from ..store.queue import DEFAULT_BACKENDS, VALID_STATES, ProcessingQueue
from .common import add_device, add_quiet, add_verbose_version, err, parse_cli


def _backends(args) -> list[str]:
    spec = args.backend or getattr(args, "stt_backends", None)
    return [b.strip() for b in spec.split(",")] if spec else list(DEFAULT_BACKENDS)


def _gather(args) -> list | None:
    """Resolve the path operand; error messages are the reference's
    (speaker-process:666-685).  None means an error was printed."""
    input_path = Path(args.path).resolve()
    if not input_path.exists():
        err(f"Error: Path not found: {input_path}")
        return None
    if input_path.is_file():
        if not proc.is_audio_file(input_path):
            err(f"Error: Not an audio file: {input_path}")
            return None
        return [input_path]
    files = proc.find_audio_files(input_path, recursive=args.recursive)
    if not files:
        err(f"Error: No audio files found in: {input_path}")
        return None
    return files


def _summary(results, quiet: bool) -> int:
    if not quiet:
        succeeded = sum(1 for r in results if r.success)
        failed = sum(1 for r in results if not r.success)
        print(f"\n{'=' * 40}")
        print(f"Summary: {succeeded} succeeded, {failed} failed")
    return 0 if all(r.success for r in results) else 1


def cmd_process(args) -> int:
    files = _gather(args)
    if files is None:
        return 1
    if not args.quiet:
        print(f"Found {len(files)} audio file(s)")
        if args.dry_run:
            print("=== DRY RUN - No changes will be made ===")
    queue = ProcessingQueue()
    items = []
    for p in files:
        item = queue.add(p, context=args.context, backends=_backends(args))
        if item:
            items.append(item)
    results = proc.process_batch(
        items,
        queue=queue,
        parallel=args.parallel,
        output_dir=args.output_dir,
        skip_existing=args.skip_existing,
        dry_run=args.dry_run,
        quiet=args.quiet,
        use_llm=args.use_llm,
        embed_backend=args.embed_backend,
        device=args.device,
    )
    return _summary(results, args.quiet)


def cmd_queue(args) -> int:
    files = _gather(args)
    if files is None:
        return 1
    queue = ProcessingQueue()
    added = 0
    for p in files:
        item = queue.add(p, context=args.context, backends=_backends(args))
        if item:
            added += 1
            if not args.quiet:
                print(f"Queued: {p.name} ({item['b3sum'][:8]}...)")
    if not args.quiet:
        print(f"\nAdded {added} item(s) to queue")
    return 0


def cmd_status(args) -> int:
    queue = ProcessingQueue()
    stats = queue.get_stats()
    if args.format == "json":
        print(json.dumps({"stats": stats, "items": queue.items()},
                         indent=2, ensure_ascii=False))
        return 0
    print("Processing Queue Status")
    print("=" * 40)
    print(f"  Total items:  {stats['total']}")
    print(f"  Pending:      {stats['pending']}")
    print(f"  Processing:   {stats['processing']}")
    print(f"  Completed:    {stats['completed']}")
    print(f"  Failed:       {stats['failed']}")
    print(f"  Skipped:      {stats['skipped']}")
    items = queue.items()
    if args.verbose and items:
        print("\nQueue Items:")
        for item in items:
            print(f"\n  {Path(item['audio_path']).name}")
            print(f"    b3sum: {item['b3sum'][:8]}...")
            print(f"    status: {item['status']}")
            print(f"    backends: {', '.join(item.get('backends') or [])}")
            if item.get("context"):
                print(f"    context: {item['context']}")
            if item.get("error"):
                print(f"    error: {item['error'][:100]}")
            if item.get("results"):
                print(f"    results: {json.dumps(item['results'], indent=6)}")
    return 0


def cmd_run(args) -> int:
    queue = ProcessingQueue()
    pending = queue.get_pending(limit=args.limit)
    if not pending:
        if not args.quiet:
            print("No pending items in queue")
        return 0
    if not args.quiet:
        print(f"Processing {len(pending)} queued item(s)")
        if args.dry_run:
            print("=== DRY RUN - No changes will be made ===")
    results = proc.process_batch(
        pending,
        queue=queue,
        parallel=args.parallel,
        output_dir=args.output_dir,
        skip_existing=args.skip_existing,
        dry_run=args.dry_run,
        quiet=args.quiet,
        use_llm=args.use_llm,
        embed_backend=args.embed_backend,
        device=args.device,
    )
    return _summary(results, args.quiet)


def cmd_clear_queue(args) -> int:
    queue = ProcessingQueue()
    if not args.force:
        import sys as _sys

        stats = queue.get_stats()
        print(f"Clear {stats['total']} item(s) from queue?")
        if args.status:
            print(f"  (filtering by status: {args.status})")
        if _sys.stdin.isatty():
            response = input("Confirm [y/N]: ")
            if response.lower() != "y":
                print("Cancelled")
                return 0
    cleared = queue.clear(status=args.status)
    if not args.quiet:
        print(f"Cleared {cleared} item(s) from queue")
    return 0


def _add_pipeline_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--parallel", "-p", type=int, default=proc.DEFAULT_PARALLEL,
                   help="Number of parallel jobs (default: 4)")
    p.add_argument("--output-dir", "-o", help="Output directory for transcripts")
    p.add_argument("--skip-existing", "-s", action="store_true",
                   help="Skip already processed recordings")
    p.add_argument("--dry-run", "-n", action="store_true",
                   help="Show what would run without executing")
    p.add_argument("--use-llm", action="store_true",
                   help="Add the LLM name signal during assignment")
    p.add_argument("--embed-backend", help="Embedding backend for assignment")
    add_device(p)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="speaker-process-gpu", description="Batch recording processing orchestrator on the GPU")
    add_quiet(parser)
    add_verbose_version(parser)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("process", help="Process recording(s) immediately")
    p.add_argument("path", help="Path to audio file or directory")
    p.add_argument("--backend", "-b",
                   help=f"Comma-separated STT backends (default: {','.join(DEFAULT_BACKENDS)})")
    p.add_argument("--stt-backends", help=argparse.SUPPRESS)  # legacy alias
    p.add_argument("--context", "-c", help="Context name for new recordings")
    p.add_argument("--recursive", "-r", action="store_true",
                   help="Recursively scan directories")
    _add_pipeline_flags(p)
    p.set_defaults(func=cmd_process)

    p = sub.add_parser("queue", help="Add recording(s) to processing queue")
    p.add_argument("path", help="Path to audio file or directory")
    p.add_argument("--backend", "-b",
                   help=f"Comma-separated STT backends (default: {','.join(DEFAULT_BACKENDS)})")
    p.add_argument("--stt-backends", help=argparse.SUPPRESS)
    p.add_argument("--context", "-c", help="Context name for new recordings")
    p.add_argument("--recursive", "-r", action="store_true",
                   help="Recursively scan directories")
    p.set_defaults(func=cmd_queue)

    p = sub.add_parser("status", help="Show processing queue status")
    p.add_argument("--format", "-f", choices=["text", "json"], default="text")
    p.set_defaults(func=cmd_status)

    p = sub.add_parser("run", help="Run processing on queued items")
    p.add_argument("--limit", "-l", type=int,
                   help="Maximum number of items to process")
    p.add_argument("--backend", "-b", help=argparse.SUPPRESS)
    p.add_argument("--stt-backends", help=argparse.SUPPRESS)
    _add_pipeline_flags(p)
    p.set_defaults(func=cmd_run)

    p = sub.add_parser("clear-queue", help="Clear the processing queue")
    p.add_argument("--status", "-s", choices=list(VALID_STATES),
                   help="Only clear items with this status")
    p.add_argument("--force", "-f", action="store_true", help="Skip confirmation")
    p.set_defaults(func=cmd_clear_queue)

    return parser


def main(argv: list[str] | None = None) -> int:
    args = parse_cli(build_parser(), argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
