"""Speaker-verification EER and threshold calibration on the held-out voice
family.

The counterpart of ``evals/benchmark_eer.py``.  N held-out speakers
(``data/synth_heldout.py``, disjoint from every training generator) enroll
on one utterance each and score genuine and impostor trials; it reports
the EER and its threshold, FAR / FRR at the inherited 0.354, the same in
the backend's scored space (AS-norm against its cohort sidecar, then its
calibration: ``LocalEmbeddingBackend.score_matrix``) when that differs
from raw cosine, and a calibration table (threshold → FAR / FRR).
Embeddings come from the backend's ``embed_batch`` on ``--device``
(default cuda): utterances of one window's length go through the GPU
backend's batched log-mel kernel.

Usage: python -m sdtk_tpu_torch.evals.eer [--backend gpu|fake] [--speakers 16]
       [--trials-per-speaker 6] [--tier clean|noise|reverb|telephone] [--device cuda]
Prints one JSON line, and the calibration table on stderr.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

REFERENCE_THRESHOLD = 0.354


def _eer(genuine: np.ndarray, impostor: np.ndarray) -> tuple[float, float]:
    """(eer, threshold) over the pooled scores as thresholds."""
    thresholds = np.unique(np.concatenate([genuine, impostor]))
    far = np.array([(impostor >= th).mean() for th in thresholds])
    frr = np.array([(genuine < th).mean() for th in thresholds])
    i = int(np.argmin(np.abs(far - frr)))
    return float((far[i] + frr[i]) / 2), float(thresholds[i])


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="sdtk_tpu_torch.evals.eer")
    p.add_argument("--backend", default="gpu")
    p.add_argument("--speakers", type=int, default=16)
    p.add_argument("--trials-per-speaker", type=int, default=6)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--tier", default="clean", choices=["clean", "noise", "reverb", "telephone"])
    p.add_argument("--snr-db", type=float, default=15.0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)

    from ..backends import get_backend
    from ..data.synth_heldout import apply_tier, heldout_utterance

    backend = get_backend(args.backend, device=args.device)

    def make(spk: int, utt: int) -> np.ndarray:
        wav = heldout_utterance(spk, utt, args.seconds)
        return apply_tier(wav, args.tier, seed=1000 * spk + utt, snr_db=args.snr_db)

    n_spk, n_trial = args.speakers, args.trials_per_speaker
    enroll = np.asarray(backend.embed_batch([make(s, 0) for s in range(n_spk)]))  # (S, D)
    trials = np.asarray(backend.embed_batch(
        [make(s, 1 + t) for s in range(n_spk) for t in range(n_trial)]))  # (S*T, D)
    trial_spk = np.repeat(np.arange(n_spk), n_trial)

    scores = trials @ enroll.T  # cosine (unit rows)
    idx = np.arange(len(trials))
    genuine = scores[idx, trial_spk]
    mask = np.ones_like(scores, dtype=bool)
    mask[idx, trial_spk] = False
    impostor = scores[mask]
    eer, eer_threshold = _eer(genuine, impostor)

    ref_th = REFERENCE_THRESHOLD
    # the scored operating point: with a cohort and a calibration sidecar,
    # 0.354 is meant to be the operating threshold of the scored space
    calibrated = {}
    scored_m = np.asarray(backend.score_matrix(trials, enroll))
    cal_gen, cal_imp = scored_m[idx, trial_spk], scored_m[mask]
    if not np.allclose(cal_gen, genuine):
        scored_eer, _ = _eer(cal_gen, cal_imp)
        calibrated = {
            "scored_eer": round(scored_eer, 4),
            "scored_uses_asnorm": bool(getattr(backend, "cohort", None) is not None),
            "calibrated_far_at_reference": round(float((cal_imp >= ref_th).mean()), 4),
            "calibrated_frr_at_reference": round(float((cal_gen < ref_th).mean()), 4),
        }

    table = [{"threshold": th,
              "far": round(float((impostor >= th).mean()), 4),
              "frr": round(float((genuine < th).mean()), 4)}
             for th in (0.2, 0.3, 0.354, 0.4, 0.5, 0.6, 0.7, round(eer_threshold, 3))]
    print("threshold  FAR     FRR", file=sys.stderr)
    for row in sorted(table, key=lambda r: r["threshold"]):
        print(f"  {row['threshold']:<8} {row['far']:<7} {row['frr']}", file=sys.stderr)

    print(json.dumps({
        "benchmark": "eer",
        "backend": args.backend,
        "generator": "heldout",
        "tier": args.tier,
        "speakers": n_spk,
        "genuine_trials": int(len(genuine)),
        "impostor_trials": int(len(impostor)),
        "eer": round(eer, 4),
        "eer_threshold": round(eer_threshold, 4),
        "reference_threshold": ref_th,
        "far_at_reference": round(float((impostor >= ref_th).mean()), 4),
        "frr_at_reference": round(float((genuine < ref_th).mean()), 4),
        "genuine_mean": round(float(genuine.mean()), 4),
        "impostor_mean": round(float(impostor.mean()), 4),
        **calibrated,
        "calibration": table,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
