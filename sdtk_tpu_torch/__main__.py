"""Umbrella dispatcher: ``python -m sdtk_tpu_torch <tool> [...]``.

Tools: detection, catalog, samples, segments, assign, report, process,
review, llm, diarize, train — the JAX package's.
"""

from __future__ import annotations

import importlib
import sys

TOOLS = {
    "detection": "sdtk_tpu_torch.cli.detection",
    "catalog": "sdtk_tpu_torch.cli.catalog",
    "samples": "sdtk_tpu_torch.cli.samples",
    "segments": "sdtk_tpu_torch.cli.segments",
    "assign": "sdtk_tpu_torch.cli.assign",
    "report": "sdtk_tpu_torch.cli.report",
    "process": "sdtk_tpu_torch.cli.process",
    "review": "sdtk_tpu_torch.cli.review",
    "llm": "sdtk_tpu_torch.cli.llm",
    "diarize": "sdtk_tpu_torch.cli.diarize",
    "train": "sdtk_tpu_torch.training",
}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m sdtk_tpu_torch <tool> [args...]", file=sys.stderr)
        print(f"tools: {', '.join(sorted(TOOLS))}", file=sys.stderr)
        return 0 if argv else 2
    tool = argv[0]
    if tool not in TOOLS:
        print(f"unknown tool '{tool}' (available: {', '.join(sorted(TOOLS))})", file=sys.stderr)
        return 2
    return importlib.import_module(TOOLS[tool]).main(argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
