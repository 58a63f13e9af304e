"""Speaker-identification pass rate.

The counterpart of ``evals/benchmark_identify.py``: N synthetic speakers
(``data/synth.py``) enroll from utterance 0 each, then are identified in
held-out utterances (single-speaker cases: the best row must be the
speaker) and in conversations of two speakers, i and i + 1 (both must be
among the identified).  Enrollment and identification go through the
port's ``pipeline/identify.py`` into a store in a temporary directory, on
``--device`` (default cuda): K1 featurizes each file, and the store's size
picks the scoring route (the host below 2**24 products, then K3, then K2
from 8 192 rows).

Usage: python -m sdtk_tpu_torch.evals.identify [--backend fake|gpu] [--speakers 4]
       [--utterances 3] [--threshold 0.354] [--seconds 4.0] [--device cuda]
       [--cases FILE]
Prints one JSON line with the pass rates; ``--cases`` writes each case's
expected and identified speakers, with their scores, as JSON.  Exits 1
unless every single-speaker case passes.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np

_ENV = ("SPEAKERS_EMBEDDINGS_DIR", "SPEAKER_DETECTION_BACKEND")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="sdtk_tpu_torch.evals.identify")
    p.add_argument("--backend", default="fake")
    p.add_argument("--speakers", type=int, default=4)
    p.add_argument("--utterances", type=int, default=3, help="held-out utts per speaker")
    p.add_argument("--threshold", type=float, default=0.354)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain versions)")
    p.add_argument("--cases", help="write each case's expected and identified speakers here")
    args = p.parse_args(argv)

    saved = {k: os.environ.get(k) for k in _ENV}
    with tempfile.TemporaryDirectory(prefix="sdtk_eval_") as tmp:
        workdir = Path(tmp)
        os.environ["SPEAKERS_EMBEDDINGS_DIR"] = str(workdir / "db")
        os.environ["SPEAKER_DETECTION_BACKEND"] = args.backend
        try:
            out, cases, all_single_pass = _run(args, workdir)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    if args.cases:
        Path(args.cases).write_text(json.dumps(cases, indent=1))
    print(json.dumps(out))
    return 0 if all_single_pass else 1


def _run(args, workdir: Path) -> tuple[dict, list[dict], bool]:
    from ..data.synth import SR, synth_utterance
    from ..pipeline import identify as ID
    from ..utils.audio import save_wav

    names = [f"speaker-{i:02d}" for i in range(args.speakers)]
    cases: list[dict] = []

    def identify(case: str, wav: np.ndarray, expected: list[str]) -> list[str]:
        path = workdir / f"{case}.wav"
        save_wav(path, wav, SR)
        results = ID.identify(path, threshold=args.threshold, device=args.device)
        ids = [r["speaker_id"] for r in results]
        cases.append({"case": case, "expected": expected, "identified": ids,
                      "scores": [float(r["score"]) for r in results]})
        return ids

    t0 = time.time()
    for i, name in enumerate(names):  # each speaker from utterance 0
        wav_path = workdir / f"enroll_{name}.wav"
        save_wav(wav_path, synth_utterance(i, 0, args.seconds), SR)
        ID.enroll(name, wav_path, create_missing=True, device=args.device)
    enroll_s = time.time() - t0

    single_pass = single_total = 0
    t0 = time.time()
    for i, name in enumerate(names):
        for u in range(1, args.utterances + 1):
            ids = identify(f"test_{name}_{u}", synth_utterance(i, u, args.seconds), [name])
            single_total += 1
            single_pass += bool(ids) and ids[0] == name

    conv_pass = conv_total = 0  # pass iff both speakers are identified
    for i in range(args.speakers):
        j = (i + 1) % args.speakers
        conv = np.concatenate([synth_utterance(i, 100 + i, args.seconds),
                               synth_utterance(j, 200 + j, args.seconds)])
        ids = identify(f"conv_{i}_{j}", conv, [names[i], names[j]])
        conv_total += 1
        conv_pass += {names[i], names[j]} <= set(ids)
    identify_s = time.time() - t0

    out = {
        "benchmark": "identify",
        "backend": args.backend,
        "speakers": args.speakers,
        "single_pass_rate": round(single_pass / max(single_total, 1), 3),
        "single_cases": single_total,
        "conversation_pass_rate": round(conv_pass / max(conv_total, 1), 3),
        "conversation_cases": conv_total,
        "enroll_seconds": round(enroll_s, 2),
        "identify_seconds": round(identify_s, 2),
    }
    return out, cases, single_pass == single_total


if __name__ == "__main__":
    raise SystemExit(main())
