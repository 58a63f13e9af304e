"""``speaker-review`` CLI: interactive assignment review TUI
(reference speaker-review: review/status/clear; keys p/a/r/s/n/q
:71-84; raw-tty loop with input() fallback :683-786).  A copy of
``sdtk_tpu/cli/review.py``; ``rich`` is imported only on a tty, and the
plain renderer is used without it."""

from __future__ import annotations

import argparse
import sys

from ..pipeline import review as RV
from ..store import catalog as catalog_store
from .common import add_quiet, add_verbose_version, emit_json, err, info

KEYHELP = "[p]lay  [a]pprove  [r]eject  [s]kip  [n]ext  [q]uit"


def _getch() -> str:
    """Single keypress; falls back to line input when not a tty."""
    if not sys.stdin.isatty():
        line = sys.stdin.readline()
        if not line:
            return "q"
        return (line.strip() or " ")[0]
    try:
        import termios
        import tty

        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        try:
            tty.setraw(fd)
            ch = sys.stdin.read(1)
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
        return ch
    except Exception:
        return (input("> ").strip() or " ")[0]


def _render_plain(session: RV.ReviewSession, idx: int) -> None:
    seg = session.segments[idx]
    total = len(session.segments)
    print()
    print(f"─── segment {idx + 1}/{total} ── {session.recording_b3sum[:8]}… ───")
    print(f"  label   : {seg.speaker_label}")
    print(f"  assigned: {seg.speaker_id or '(unassigned)'} "
          f"({seg.confidence}, score {seg.score:.2f})")
    print(f"  time    : {seg.start:.1f}s – {seg.end:.1f}s")
    if seg.text:
        print(f"  text    : {seg.text[:160]}")
    if seg.decision:
        print(f"  decision: {seg.decision}")
    print(f"  {KEYHELP}")


def _render(session: RV.ReviewSession, idx: int) -> None:
    """rich Panel rendering on a tty (reference speaker-review:451-549),
    plain text everywhere else (pipes, tests, dumb terminals)."""
    if not sys.stdout.isatty():
        return _render_plain(session, idx)
    try:
        from rich.console import Console
        from rich.panel import Panel
        from rich.table import Table
        from rich.text import Text
    except ImportError:
        return _render_plain(session, idx)

    seg = session.segments[idx]
    total = len(session.segments)
    table = Table.grid(padding=(0, 1))
    table.add_column(style="bold cyan", justify="right")
    table.add_column()
    table.add_row("label", seg.speaker_label)
    conf_style = {"confirmed": "green", "high": "green", "medium": "yellow",
                  "low": "red"}.get(seg.confidence, "dim")
    table.add_row(
        "assigned",
        f"{seg.speaker_id or '(unassigned)'} "
        f"[{conf_style}]({seg.confidence}, score {seg.score:.2f})[/]",
    )
    table.add_row("time", f"{seg.start:.1f}s – {seg.end:.1f}s")
    if seg.text:
        table.add_row("text", seg.text[:200])
    if seg.decision:
        table.add_row("decision", f"[bold]{seg.decision}[/]")
    Console().print(
        Panel(
            table,
            title=f"segment {idx + 1}/{total} · {session.recording_b3sum[:8]}…",
            subtitle=Text(KEYHELP),  # plain Text: [p] is a key hint, not markup
            border_style="blue",
        )
    )


def cmd_review(args) -> int:
    if args.cont:
        session = RV.load_session()
        if not session:
            print("No saved session found. Start a new review.")
            return 1
    else:
        b3 = None
        if args.audio:
            b3 = catalog_store.resolve_b3sum(args.audio)
            if not b3:
                print(f"Could not resolve audio: {args.audio}")
                err(f"Error: Audio not found: {args.audio}")
                return 1
        else:
            b3 = RV.next_needing_review()
            if not b3:
                print("No assignments found to review. Run speaker-assign first.")
                return 0
        try:
            session = RV.build_session(b3)
        except KeyError:
            print("No assignments found for this recording. Run speaker-assign first.")
            return 1
        if getattr(args, "context", None):
            session.context = args.context
        if getattr(args, "speaker", None):
            session.segments = [
                s for s in session.segments if s.speaker_id == args.speaker
            ]
            if not session.segments:
                info(args, f"No segments assigned to '{args.speaker}'.")
                return 0

    def read_key() -> str:
        if getattr(args, "simple", False):
            # Reference --simple: plain line prompts, no raw terminal
            # (speaker-review:887)
            try:
                return (input("> ").strip() or " ")[0]
            except EOFError:
                return "q"
        return _getch()

    idx = session.position
    while idx < len(session.segments):
        _render(session, idx)
        raw = read_key()
        if raw == "N":  # previous (case-sensitive, reference :78)
            idx = max(0, idx - 1)
            session.position = idx
            continue
        key = raw.lower()
        if key == "q":
            break
        if key == "?":
            print(KEYHELP + "  [e]dit-name  [N]=prev  [c]ontext  [?]help")
            continue
        if key == "p":
            seg = session.segments[idx]
            if not RV.play_segment(session.audio_path, seg.start, seg.end):
                print("  (no audio player available: set $SPEAKER_REVIEW_PLAYER)")
            continue
        if key == "e":
            # edit the assigned speaker's display name (reference :641-667)
            seg = session.segments[idx]
            if not seg.speaker_id:
                print("  (no speaker assigned to edit)")
                continue
            new_name = input(f"  new display name for {seg.speaker_id}: ").strip()
            if new_name:
                from ..store import profiles as P

                prof = P.load_speaker(seg.speaker_id)
                if prof:
                    prof["names"]["default"] = new_name
                    P.save_speaker(prof)
                    print(f"  updated {seg.speaker_id} → {new_name}")
                else:
                    print(f"  (profile '{seg.speaker_id}' not found)")
            continue
        if key == "c":
            ctx = input("  context name for this recording: ").strip()
            if ctx:
                try:
                    catalog_store.set_context(session.recording_b3sum, ctx)
                    print(f"  context set: {ctx}")
                except KeyError as e:
                    print(f"  ({e.args[0] if e.args else e})")
            continue
        if key == "a":
            RV.approve_segment(session, idx)
            print("  approved ✓ (sample extracted)")
        elif key == "r":
            RV.reject_segment(session, idx)
            print("  rejected ✗")
        elif key == "s":
            RV.skip_segment(session, idx)
            print("  skipped")
        elif key != "n":
            continue
        idx += 1
        session.position = idx
        RV.save_session(session)

    status = RV.finish_review(session)
    info(args, f"Review state: {status}")
    return 0


def cmd_status(args) -> int:
    session = RV.load_session()
    if not session:
        print("No active session.")
        return 0
    decided = sum(1 for s in session.segments if s.decision)
    if getattr(args, "format", "text") == "json":
        emit_json(
            {
                "recording_b3sum": session.recording_b3sum,
                "position": session.position,
                "segments": len(session.segments),
                "decided": decided,
                "updated_at": session.updated_at,
            }
        )
        return 0
    # text output (reference cmd_status shape)
    print("Active Session")
    print(f"  Recording: {session.recording_b3sum[:8]}...")
    print(f"  Audio: {session.audio_path}")
    if session.context:
        print(f"  Context: {session.context}")
    print(f"  Progress: {session.position}/{len(session.segments)} segments")
    print(f"  Decided: {decided}")
    if session.updated_at:
        print(f"  Updated: {session.updated_at}")
    return 0


def cmd_clear(args) -> int:
    RV.clear_session()
    print("Session cleared")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="speaker-review",
        description="Interactive assignment review",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="""keybindings (review loop):
  p   play segment audio        a   approve assignment
  r   reject assignment         s   skip segment
  n   next segment              N   previous segment
  e   edit speaker name         c   set recording context
  q   quit (session saved)      ?   help
""",
    )
    add_quiet(parser)
    add_verbose_version(parser)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("review", help="Review assignments for a recording")
    p.add_argument("audio", nargs="?", help="Audio path / b3sum prefix (default: next needing review)")
    p.add_argument("--continue", "-c", dest="cont", action="store_true",
                   help="Continue previous session")
    p.add_argument("--context", help="Context override for name resolution")
    p.add_argument("--speaker", help="Only review segments assigned to this speaker")
    p.add_argument("--simple", "-s", action="store_true",
                   help="Simple prompt mode (no raw terminal)")
    p.set_defaults(func=cmd_review)

    p = sub.add_parser("status", help="Show session status")
    p.add_argument("--format", "-f", choices=["text", "json"], default="text")
    p.set_defaults(func=cmd_status)

    p = sub.add_parser("clear", help="Clear saved session")
    p.set_defaults(func=cmd_clear)

    return parser


def main(argv: list[str] | None = None) -> int:
    from .common import parse_cli

    args = parse_cli(build_parser(), argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
