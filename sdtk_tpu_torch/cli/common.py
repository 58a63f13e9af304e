"""Shared CLI plumbing (the part of ``sdtk_tpu/cli/common.py`` the
diarize tool uses)."""

from __future__ import annotations

import argparse
import sys


def info(args: argparse.Namespace, msg: str) -> None:
    """Status to stderr unless -q (data stays on stdout)."""
    if not getattr(args, "quiet", False):
        print(msg, file=sys.stderr)


def err(msg: str) -> None:
    print(msg if msg.startswith(("Error:", "Warning:")) else f"Error: {msg}", file=sys.stderr)


def add_quiet(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("-q", "--quiet", action="store_true", help="Suppress status output")
