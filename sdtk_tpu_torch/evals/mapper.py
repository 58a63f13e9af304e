"""Speaker-name mapper accuracy.

The counterpart of ``evals/benchmark_mapper.py``: the port's name
detector (``pipeline/llm.py:detect_names``) runs over the scenario
transcripts of ``evals/mapper/tests/*.json`` and its label → name mapping
is graded against ``evals/mapper/references/*.ref.json`` on the reference
toolkit's scale: exact or acceptable 1.0, partial (a substring either
way) the reference file's partial weight, wrong 0.0; a test passes at
accuracy >= 0.75.  Both directories are read as data.  The default
provider, ``pattern``, is offline and deterministic; ``--provider
anthropic|openai|ollama`` grades a real model.

Usage: python -m sdtk_tpu_torch.evals.mapper [--provider pattern] [--model M]
       [--format text|json] [--tests-dir DIR] [--refs-dir DIR] [--only 002]
Exits 1 unless every test passes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]


def score_mapping(actual: str | None, expected: dict) -> tuple[float, str]:
    """Grade one label: (score, match type)."""
    actual = actual or "Unknown"
    acceptable = expected.get("acceptable", [])
    preferred = expected.get("preferred", "")
    if actual == preferred:
        return 1.0, "exact"
    if actual in acceptable:
        return 1.0, "acceptable"
    partial = expected.get("_partial_weight", 0.5)
    for variant in acceptable:
        if variant.lower() in actual.lower() or actual.lower() in variant.lower():
            return partial, "partial"
    return 0.0, "wrong"


def run_test(test_file: Path, ref_file: Path, provider: str, model: str | None) -> dict:
    from ..pipeline import llm as L

    ref = json.loads(ref_file.read_text())
    partial_weight = ref.get("scoring", {}).get("partial_match", 0.5)

    t0 = time.perf_counter()
    mapping = L.detect_names(json.loads(test_file.read_text()), provider=provider, model=model)
    elapsed = time.perf_counter() - t0

    speaker_scores, total = {}, 0.0
    expected_mappings = ref["expected_mappings"]
    for label, expected in expected_mappings.items():
        expected = dict(expected, _partial_weight=partial_weight)
        score, match_type = score_mapping(mapping.get(label), expected)
        speaker_scores[label] = {
            "actual": mapping.get(label) or "Unknown",
            "expected": expected.get("preferred", ""),
            "score": score,
            "match_type": match_type,
        }
        total += score
    accuracy = total / max(len(expected_mappings), 1)
    return {
        "test_id": ref.get("test_id", test_file.stem),
        "status": "pass" if accuracy >= 0.75 else "fail",
        "accuracy": round(accuracy, 3),
        "elapsed_s": round(elapsed, 3),
        "speaker_scores": speaker_scores,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="sdtk_tpu_torch.evals.mapper",
                                 description="Speaker-name mapper accuracy.")
    ap.add_argument("--provider", default="pattern")
    ap.add_argument("--model")
    ap.add_argument("--tests-dir", default=str(REPO_ROOT / "evals/mapper/tests"))
    ap.add_argument("--refs-dir", default=str(REPO_ROOT / "evals/mapper/references"))
    ap.add_argument("--only", help="substring filter on test id")
    ap.add_argument("--format", choices=["text", "json"], default="text")
    args = ap.parse_args(argv)

    tests_dir, refs_dir = Path(args.tests_dir), Path(args.refs_dir)
    results = []
    for test_file in sorted(tests_dir.glob("*.json")):
        if args.only and args.only not in test_file.stem:
            continue
        ref_file = refs_dir / f"{test_file.stem}.ref.json"
        if not ref_file.exists():
            print(f"SKIP {test_file.stem}: no reference", file=sys.stderr)
            continue
        results.append(run_test(test_file, ref_file, args.provider, args.model))

    passed = sum(r["status"] == "pass" for r in results)
    summary = {
        "provider": args.provider,
        "model": args.model,
        "passed": passed,
        "total": len(results),
        "pass_rate": round(passed / max(len(results), 1), 3),
        "mean_accuracy": round(sum(r["accuracy"] for r in results) / max(len(results), 1), 3),
        "results": results,
    }
    if args.format == "json":
        print(json.dumps(summary, indent=2))
    else:
        for r in results:
            marks = " ".join(f"{lbl}:{s['actual']}({s['match_type']})"
                             for lbl, s in r["speaker_scores"].items())
            print(f"{r['status'].upper():<5} {r['test_id']:<28} "
                  f"acc={r['accuracy']:.2f} {r['elapsed_s']:.2f}s  {marks}")
        print(f"\n{passed}/{len(results)} passed "
              f"(mean accuracy {summary['mean_accuracy']:.2f}, provider={args.provider})")
    return 0 if passed == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
