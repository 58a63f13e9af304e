"""Shared CLI plumbing (the part of ``sdtk_tpu/cli/common.py`` the port's
tools use: same messages, same segment syntax)."""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any


def info(args: argparse.Namespace, msg: str) -> None:
    """Status to stderr unless -q (data stays on stdout)."""
    if not getattr(args, "quiet", False):
        print(msg, file=sys.stderr)


def err(msg: str) -> None:
    print(msg if msg.startswith(("Error:", "Warning:")) else f"Error: {msg}", file=sys.stderr)


def status(msg: str) -> None:
    """Unconditional progress line to stderr."""
    print(msg, file=sys.stderr)


def emit_json(obj: Any) -> None:
    print(json.dumps(obj, indent=2, ensure_ascii=False))


def parse_kv(items: list[str] | None) -> dict[str, str]:
    out: dict[str, str] = {}
    for item in items or []:
        key, _, val = item.partition("=")
        out[key] = val
    return out


def parse_segments_arg(spec: str) -> list[tuple[float, float]]:
    """"0:5,10:15" (or "0-5,10-15") → [(0, 5), (10, 15)]."""
    segments = []
    for part in spec.split(","):
        part = part.strip()
        sep = ":" if ":" in part else "-"
        if sep not in part:
            raise ValueError(f"Invalid segment format '{part}'. Use 'start:end'.")
        a, _, b = part.partition(sep)
        try:
            start, end = float(a), float(b)
        except ValueError:
            raise ValueError(f"Invalid segment times '{part}'. Must be numeric.") from None
        if start >= end:
            raise ValueError(f"Invalid segment '{part}'. Start must be < end.")
        segments.append((start, end))
    return segments


def table(rows: list[list[str]], headers: list[str]) -> str:
    widths = [len(h) for h in headers]
    for row in rows:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(str(cell)))
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    lines = [fmt.format(*headers), fmt.format(*["-" * w for w in widths])]
    lines += [fmt.format(*[str(c) for c in row]) for row in rows]
    return "\n".join(lines)


def add_quiet(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("-q", "--quiet", action="store_true", help="Suppress status output")


def add_verbose_version(parser: argparse.ArgumentParser) -> None:
    """-v/--verbose and -V/--version, as every JAX package tool has them."""
    from .. import __version__

    parser.add_argument("-v", "--verbose", action="store_true", help="Verbose output")
    parser.add_argument("-V", "--version", action="version",
                        version=f"{parser.prog} (sdtk-tpu {__version__})")


def add_subcommand_flags(parser: argparse.ArgumentParser) -> None:
    """Give every subcommand its own -q/-v, so a flag after the subcommand
    parses; SUPPRESS keeps an absent one from clobbering a flag given
    before the subcommand."""
    for action in parser._actions:  # noqa: SLF001 — argparse introspection
        if isinstance(action, argparse._SubParsersAction):  # noqa: SLF001
            for sp in action.choices.values():
                opts = {o for a in sp._actions for o in a.option_strings}  # noqa: SLF001
                for flags in (("-q", "--quiet"), ("-v", "--verbose")):
                    if not opts & set(flags):
                        sp.add_argument(*flags, action="store_true",
                                        default=argparse.SUPPRESS, help=argparse.SUPPRESS)


def parse_cli(parser: argparse.ArgumentParser, argv: list[str] | None) -> argparse.Namespace:
    """Parse with -q/-v accepted after the subcommand too (a flag given
    before it is kept), and both defaulted to False."""
    add_subcommand_flags(parser)
    args = parser.parse_args(argv)
    args.quiet = getattr(args, "quiet", False)
    args.verbose = getattr(args, "verbose", False)
    return args


def add_device(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs the plain versions)")
