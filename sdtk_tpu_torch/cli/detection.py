"""``python -m sdtk_tpu_torch.cli.detection`` — speaker profiles and
enroll / identify / verify on the GPU.

The counterpart of ``sdtk_tpu/cli/detection.py``, with its seventeen
subcommands (add, list, show, update, delete, tag, export, query, enroll,
embeddings, remove-embedding, update-embedding, identify, verify,
check-validity, validate, backends), their arguments, messages, output
and return codes, plus ``--device`` on the commands that build an
embedding backend (default cuda; ``cpu`` runs the plain versions).
``query`` evaluates its jq expression with ``utils/jqlite.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .. import config
from ..backends.base import DEFAULT_THRESHOLD, get_backend, list_backends
from ..store import profiles as P
from ..store import schemas
from .common import (add_device, add_quiet, add_verbose_version, emit_json, err, info,
                     parse_cli, parse_kv, parse_segments_arg, status, table)


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


def cmd_update(args) -> int:
    sid = P.normalize_speaker_id(args.id)
    profile = P.load_speaker(sid)
    if not profile:
        err(f"speaker '{sid}' not found")
        return 1
    if args.name:
        profile.setdefault("names", {})["default"] = args.name
    for ctx, name in parse_kv(args.name_context).items():
        profile.setdefault("names", {})[ctx] = name
    if args.description is not None:
        profile["description"] = args.description
    for nick in args.nickname or []:
        if nick not in profile.setdefault("nicknames", []):
            profile["nicknames"].append(nick)
    for nick in args.remove_nickname or []:
        if nick in profile.get("nicknames", []):
            profile["nicknames"].remove(nick)
    for tag in args.tag or []:
        if tag not in profile.setdefault("tags", []):
            profile["tags"].append(tag)
    for tag in args.remove_tag or []:
        if tag in profile.get("tags", []):
            profile["tags"].remove(tag)
    profile.setdefault("metadata", {}).update(parse_kv(args.metadata))
    P.save_speaker(profile)
    info(args, f"Updated speaker '{sid}'")
    return 0


def cmd_delete(args) -> int:
    sid = P.normalize_speaker_id(args.id)
    if not P.load_speaker(sid):
        err(f"speaker '{sid}' not found")
        return 1
    if args.dry_run:
        print(f"Would delete speaker '{sid}'")
        return 0
    if not args.force:
        err("refusing to delete without --force")
        return 1
    P.delete_speaker(sid)
    info(args, f"Deleted speaker '{sid}'")
    return 0


def cmd_tag(args) -> int:
    sid = P.normalize_speaker_id(args.id)
    profile = P.load_speaker(sid)
    if not profile:
        err(f"speaker '{sid}' not found")
        return 1
    if args.add and args.add not in profile.setdefault("tags", []):
        profile["tags"].append(args.add)
    if args.remove and args.remove in profile.get("tags", []):
        profile["tags"].remove(args.remove)
    P.save_speaker(profile)
    print(",".join(profile.get("tags", [])))
    return 0


def cmd_export(args) -> int:
    """Speakers for an STT service: ``json`` wraps records in {"speakers",
    "context", "exported_at"}; ``speechmatics`` is {"speakers": [{"id",
    "name"}]}."""
    speakers = P.list_all_speakers()
    if args.tags:
        speakers = P.filter_speakers_by_tags(speakers, [t.strip() for t in args.tags.split(",")])
    context = args.context or "default"

    def _name(s):
        names = s.get("names", {})
        return names.get(context, names.get("default", s["id"]))

    if args.format == "speechmatics":
        out = {"speakers": [{"id": s["id"], "name": _name(s)} for s in speakers]}
    else:
        out = {
            "speakers": [{"id": s["id"], "name": _name(s), "nicknames": s.get("nicknames", []),
                          "tags": s.get("tags", []),
                          "embeddings": {backend: len(embs)
                                         for backend, embs in s.get("embeddings", {}).items()}}
                         for s in speakers],
            "context": context,
            "exported_at": P.utc_now_iso(),
        }
    text = json.dumps(out, indent=2, ensure_ascii=False)
    if args.output:
        from ..utils.ioutil import atomic_write_text

        atomic_write_text(args.output, text + "\n")
        info(args, f"Exported {len(speakers)} speakers to {args.output}")
    else:
        print(text)
    return 0


def cmd_query(args) -> int:
    """A jq expression over every speaker profile (``utils/jqlite.py``)."""
    from ..utils.jqlite import JqError, query_lines

    try:
        out = query_lines(args.expression, P.list_all_speakers())
    except JqError as e:
        err(str(e))
        return 1
    if out:
        print(out)
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


def cmd_remove_embedding(args) -> int:
    sid = P.normalize_speaker_id(args.id)
    profile = P.load_speaker(sid)
    if not profile:
        err(f"speaker '{sid}' not found")
        return 1
    removed = False
    for backend, recs in profile.get("embeddings", {}).items():
        keep = [r for r in recs if r.get("id") != args.embedding_id]
        if len(keep) != len(recs):
            profile["embeddings"][backend] = keep
            removed = True
    if not removed:
        err(f"embedding '{args.embedding_id}' not found")
        return 1
    P.save_speaker(profile)
    info(args, f"Removed embedding {args.embedding_id}")
    return 0


def cmd_update_embedding(args) -> int:
    sid = P.normalize_speaker_id(args.id)
    profile = P.load_speaker(sid)
    if not profile:
        err(f"speaker '{sid}' not found")
        return 1
    for recs in profile.get("embeddings", {}).values():
        for r in recs:
            if r.get("id") == args.embedding_id:
                if args.trust_level:
                    r["trust_level"] = args.trust_level
                P.save_speaker(profile)
                info(args, f"Updated embedding {args.embedding_id}")
                return 0
    err(f"embedding '{args.embedding_id}' not found")
    return 1


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


def cmd_check_validity(args) -> int:
    """Each stored embedding's model-version compatibility with its backend
    (built on ``--device``), then its trust level recomputed from its
    samples' review states (saved with ``--fix``)."""
    speakers = ([P.load_speaker(P.normalize_speaker_id(args.speaker_id))] if args.speaker_id
                else P.list_all_speakers())
    speakers = [s for s in speakers if s]
    if not speakers:
        print("No speakers found.")
        return 0
    issues = checked = 0
    for profile in speakers:
        for backend_name, recs in (profile.get("embeddings") or {}).items():
            try:
                backend = get_backend(backend_name, device=args.device)
            except ValueError:
                continue
            for rec in recs:
                compat = backend.check_embedding_compatibility(rec)
                if not compat["compatible"]:
                    print(f"INCOMPATIBLE: {profile['id']}/{backend_name}/"
                          f"{rec.get('id')} — {compat['warning']}")
        for res in P.refresh_trust_levels(profile["id"], save=args.fix):
            checked += 1
            where = f"{profile['id']}/{res['backend']}/{res['id']}"
            if res["new_trust"] == "invalidated":
                issues += 1
                print(f"INVALIDATED: {where}")
                if res["newly_rejected"]:
                    print(f"  Newly rejected samples: {', '.join(res['newly_rejected'][:3])}")
            elif res["changed"] and args.verbose:
                print(f"CHANGED: {where} ({res['old_trust']} -> {res['new_trust']})")
            elif args.verbose:
                print(f"OK: {where} (trust: {res['old_trust']})")
    print(f"\nChecked {checked} embeddings across {len(speakers)} speakers")
    if issues:
        print(f"  {issues} INVALIDATED (re-enrollment needed)")
    return 1 if issues else 0


def cmd_validate(args) -> int:
    issues = schemas.validate_all()
    if args.speaker_id:  # that speaker's profile and sample files
        sid = args.speaker_id
        issues = {p: w for p, w in issues.items()
                  if f"/{sid}." in f"/{p}" or f"/{sid}/" in f"/{p}"}
    if not issues:
        print("All files valid.")
        return 0
    for path, warnings in issues.items():
        print(f"{path}:")
        for w in warnings:
            print(f"  - {w}")
    return 1 if args.strict else 0


def cmd_backends(args) -> int:
    for name in list_backends():
        line = name
        if args.verbose:
            try:
                b = get_backend(name, device=args.device)
                line += f"  (dim={b.embedding_dim}, model={b.model_version})"
            except Exception as e:  # noqa: BLE001 — reported, as the JAX tool does
                line += f"  (unavailable: {e})"
        print(line)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="sdtk_tpu_torch.cli.detection",
        description="Speaker profile management and identification on the GPU")
    add_quiet(parser)
    add_verbose_version(parser)
    sub = parser.add_subparsers(dest="command", required=True)

    def command(name: str, help_text: str, func) -> argparse.ArgumentParser:
        p = sub.add_parser(name, help=help_text)
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

    p = command("update", "Update speaker", cmd_update)
    p.add_argument("id")
    p.add_argument("--name")
    p.add_argument("--name-context", action="append", metavar="CTX=NAME")
    p.add_argument("--description")
    p.add_argument("--nickname", action="append")
    p.add_argument("--remove-nickname", action="append")
    p.add_argument("--tag", action="append")
    p.add_argument("--remove-tag", action="append")
    p.add_argument("--metadata", action="append", metavar="KEY=VALUE")

    p = command("delete", "Delete speaker", cmd_delete)
    p.add_argument("id")
    p.add_argument("--force", "-f", action="store_true")
    p.add_argument("-n", "--dry-run", action="store_true")

    p = command("tag", "Manage speaker tags", cmd_tag)
    p.add_argument("id")
    p.add_argument("--add")
    p.add_argument("--remove")

    p = command("export", "Export speakers for STT", cmd_export)
    p.add_argument("--tags")
    p.add_argument("--context")
    p.add_argument("--format", choices=["json", "speechmatics"], default="json")
    p.add_argument("-o", "--output")

    p = command("query", "Query with jq expression", cmd_query)
    p.add_argument("expression")

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

    p = command("remove-embedding", "Remove an embedding", cmd_remove_embedding)
    p.add_argument("id")
    p.add_argument("embedding_id")

    p = command("update-embedding", "Update embedding properties", cmd_update_embedding)
    p.add_argument("id")
    p.add_argument("embedding_id")
    p.add_argument("--trust-level", choices=["high", "medium", "low"])

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

    p = command("check-validity", "Re-check embedding trust from sample states",
                cmd_check_validity)
    p.add_argument("speaker_id", nargs="?")
    p.add_argument("--fix", action="store_true", help="Persist recomputed trust levels")
    add_device(p)

    p = command("validate", "Validate all DB files", cmd_validate)
    p.add_argument("speaker_id", nargs="?", help="Only validate this speaker's files")
    p.add_argument("--strict", action="store_true")

    p = command("backends", "List available backends", cmd_backends)
    add_device(p)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = parse_cli(build_parser(), argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
