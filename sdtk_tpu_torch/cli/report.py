"""``speaker-report`` CLI: status / coverage / confidence / stale /
speakers / contexts (reference speaker-report:921-997; same argparse
tree: top-level -f/--format, status is the default subcommand).  A copy of
``sdtk_tpu/cli/report.py``."""

from __future__ import annotations

import argparse

from ..pipeline import report as R


def cmd_status(args) -> int:
    stats = R.compute_system_stats(
        R.load_catalog_rows(),
        R.load_profile_rows(),
        R.load_assignment_rows(),
        confidence_threshold=args.confidence_threshold,
        stale_days=args.stale_days,
    )
    print(R.format_status_report(stats, args.format))
    return 0


def cmd_coverage(args) -> int:
    print(R.format_coverage_report(R.load_catalog_rows(), args.context, args.format))
    return 0


def cmd_confidence(args) -> int:
    print(
        R.format_confidence_report(
            R.load_catalog_rows(), R.load_assignment_rows(), args.below, args.format
        )
    )
    return 0


def cmd_stale(args) -> int:
    print(R.format_stale_report(R.load_catalog_rows(), args.days, args.format))
    return 0


def cmd_speakers(args) -> int:
    print(R.format_speakers_report(R.load_profile_rows(), args.format))
    return 0


def cmd_contexts(args) -> int:
    print(R.format_contexts_report(R.load_catalog_rows(), args.format))
    return 0


def build_parser() -> argparse.ArgumentParser:
    from .. import __version__

    parser = argparse.ArgumentParser(
        prog="speaker-report",
        description="Quality metrics and recommendations for speaker detection system",
    )
    parser.add_argument(
        "-V", "--version", action="version", version=f"speaker-report {__version__}"
    )
    parser.add_argument(
        "-f", "--format", choices=["text", "json"], default="text",
        help="Output format (default: text)",
    )
    sub = parser.add_subparsers(dest="command")

    _add_parser = sub.add_parser

    def add_parser(*a, **k):
        # also accept --format after the subcommand (our convention);
        # SUPPRESS default so it never clobbers the top-level -f value
        p = _add_parser(*a, **k)
        p.add_argument("-f", "--format", choices=["text", "json"],
                       default=argparse.SUPPRESS, help=argparse.SUPPRESS)
        return p

    sub.add_parser = add_parser  # type: ignore[method-assign]

    p = sub.add_parser("status", help="Overall system status")
    p.add_argument("--confidence-threshold", type=int,
                   default=R.DEFAULT_CONFIDENCE_THRESHOLD)
    p.add_argument("--stale-days", type=int, default=R.STALE_DAYS)
    p.set_defaults(func=cmd_status)

    p = sub.add_parser("coverage", help="Review coverage by context")
    p.add_argument("-c", "--context", help="Filter by specific context name")
    p.set_defaults(func=cmd_coverage)

    p = sub.add_parser("confidence", help="Recordings below confidence threshold")
    p.add_argument("-b", "--below", type=int, default=R.DEFAULT_CONFIDENCE_THRESHOLD)
    p.set_defaults(func=cmd_confidence)

    p = sub.add_parser("stale", help="Recordings with old processing")
    p.add_argument("-d", "--days", type=int, default=R.STALE_DAYS)
    p.set_defaults(func=cmd_stale)

    p = sub.add_parser("speakers", help="Speaker enrollment summary")
    p.set_defaults(func=cmd_speakers)

    p = sub.add_parser("contexts", help="List available contexts")
    p.set_defaults(func=cmd_contexts)

    return parser


def main(argv: list[str] | None = None) -> int:
    import sys

    parser = build_parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    if not getattr(args, "command", None):
        # default subcommand: status (reference speaker-report:990-997)
        args = parser.parse_args([*argv, "status"])
    if not hasattr(args, "quiet"):
        args.quiet = False
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
