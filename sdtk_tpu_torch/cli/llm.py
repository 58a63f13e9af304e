"""``speaker-llm`` CLI: analyze / detect-names / providers / clear-cache
(reference speaker-llm:566-768).  A copy of ``sdtk_tpu/cli/llm.py`` over
the port's ``pipeline/llm.py``."""

from __future__ import annotations

import argparse
import json

from ..pipeline import llm as L
from .common import add_quiet, add_verbose_version, emit_json, err, info


def cmd_analyze(args) -> int:
    try:
        result = L.analyze_transcript(
            args.transcript,
            provider=args.provider,
            model=args.model,
            context=args.context,
            use_cache=not args.no_cache,
        )
    except FileNotFoundError:
        err(f"Error: Transcript not found: {args.transcript}")
        return 1
    except json.JSONDecodeError as e:
        err(f"Error: Invalid JSON in transcript file: {e}")
        return 1
    except (L.ProviderUnavailableError, ValueError) as e:
        err(f"Error: {e}")
        return 1
    if args.format == "text":
        # Human-readable form (reference speaker-llm:620-650)
        print("Speaker Name Detection Results")
        print("=" * 40)
        print(f"Provider: {result.get('provider', 'unknown')}")
        print(f"Model: {result.get('model', 'unknown')}")
        if result.get("cached"):
            print("(from cache)")
        detections = result.get("detections", [])
        if detections:
            print("Detections:")
            for d in detections:
                label = d.get("speaker_label", "?")
                name = d.get("detected_name") or "(not detected)"
                conf = d.get("confidence", 0)
                print(f"  {label} -> {name} (confidence: {conf:.2f})")
        else:
            print("No speaker names detected")
        return 0
    emit_json(result)
    return 0


def cmd_detect_names(args) -> int:
    try:
        names = L.detect_names(
            args.transcript, provider=args.provider, model=args.model,
            use_cache=not args.no_cache,
        )
    except FileNotFoundError:
        err(f"Error: Transcript not found: {args.transcript}")
        return 1
    except json.JSONDecodeError as e:
        err(f"Error: Invalid JSON in transcript file: {e}")
        return 1
    except (L.ProviderUnavailableError, ValueError) as e:
        err(f"Error: {e}")
        return 1
    if args.format == "text":
        if names:
            for label, name in names.items():
                print(f"{label}: {name or '-'}")
        else:
            print("No names detected")
        return 0
    emit_json(names)
    return 0


def cmd_providers(args) -> int:
    for p in L.list_providers():
        status = "available" if p["available"] else "unavailable"
        print(f"{p['name']:<12} {status:<12} model={p['default_model']}  env={p['env_var'] or '-'}")
    return 0


def cmd_clear_cache(args) -> int:
    n = L.clear_cache()
    if n == 0:
        print("Cache is empty")
    else:
        print(f"Cleared {n} cached file(s)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="speaker-llm",
                                     description="LLM speaker-name detection")
    add_quiet(parser)
    add_verbose_version(parser)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("analyze", help="Full name analysis of a transcript")
    p.add_argument("transcript")
    p.add_argument("--provider", "-p",
                   choices=["anthropic", "openai", "ollama", "pattern"])
    p.add_argument("--model", "-m")
    p.add_argument("--context", "-c")
    p.add_argument("--format", "-f", choices=["text", "json"], default="json")
    p.add_argument("--no-cache", action="store_true")
    p.set_defaults(func=cmd_analyze)

    p = sub.add_parser("detect-names", help="Quick label→name map")
    p.add_argument("transcript")
    p.add_argument("--provider", "-p",
                   choices=["anthropic", "openai", "ollama", "pattern"])
    p.add_argument("--model", "-m")
    p.add_argument("--format", "-f", choices=["text", "json"], default="json")
    p.add_argument("--no-cache", action="store_true")
    p.set_defaults(func=cmd_detect_names)

    p = sub.add_parser("providers", help="List providers and availability")
    p.set_defaults(func=cmd_providers)

    p = sub.add_parser("clear-cache", help="Clear the response cache")
    p.add_argument("--force", "-f", action="store_true", help="Skip confirmation")
    p.set_defaults(func=cmd_clear_cache)

    return parser


def main(argv: list[str] | None = None) -> int:
    from .common import parse_cli

    args = parse_cli(build_parser(), argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
