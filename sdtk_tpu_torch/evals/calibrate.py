"""Fit the verify-score calibration of a checkpoint.

The counterpart of ``evals/calibrate_threshold.py``.  It scores genuine
and impostor trials over training-family voices unseen in training
(``data/synth_families.py`` ids from ``--base-id``; the held-out family of
``data/synth_heldout.py`` stays a pure measurement set), finds the EER
threshold t*, and writes the affine calibration

    calibrated = 0.354 + (raw - t*) * gain,   gain = (0.9 - 0.354) / (mu_gen - t*)

with the raw-space measurements and ``suggested_merge_tau`` as a
``.calib.json`` sidecar, which ``GpuBackend`` (and the JAX package's
``TpuBackend``) read beside the checkpoint.  With ``--cohort-size > 0`` it
also writes the AS-norm cohort as ``.cohort.npy``.  Embeddings come from
the backend's ``embed_batch`` on ``--device`` (default cuda).

The default ``--out`` is next to the backend's checkpoint (``$SDTK_MODEL_PATH``
or the bundled one): pass ``--out`` to write elsewhere.

Usage: python -m sdtk_tpu_torch.evals.calibrate [--backend gpu] [--speakers 24]
       [--trials-per-speaker 6] [--base-id 500000] [--out PATH] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def eer_point(genuine: np.ndarray, impostor: np.ndarray) -> tuple[float, float]:
    """Threshold sweep → (eer, threshold at the FAR == FRR crossing)."""
    lo = float(min(genuine.min(), impostor.min()))
    hi = float(max(genuine.max(), impostor.max()))
    best = (1.0, 0.5 * (lo + hi), 0.5)
    for t in np.linspace(lo, hi, 2001):
        far = float((impostor >= t).mean())
        frr = float((genuine < t).mean())
        gap = abs(far - frr)
        if gap < best[0]:
            best = (gap, float(t), 0.5 * (far + frr))
    return best[2], best[1]


def _unit(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="sdtk_tpu_torch.evals.calibrate")
    p.add_argument("--backend", default="gpu")
    p.add_argument("--speakers", type=int, default=24)
    p.add_argument("--trials-per-speaker", type=int, default=6)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--base-id", type=int, default=500_000,
                   help="First calibration speaker id (must exceed every training id so "
                        "these voices are unseen)")
    p.add_argument("--families", default="0",
                   help="Comma list of training family ids to sample calibration voices "
                        "from (data/synth_families.py); should match the checkpoint's")
    p.add_argument("--cohort-size", type=int, default=192,
                   help="AS-norm cohort size: embeddings of this many more unseen voices "
                        "go to a <checkpoint>.cohort.npy sidecar.  0 disables.")
    p.add_argument("--augment-prob", type=float, default=0.5,
                   help="Apply the training augmentation chain (data/augment.py) to the "
                        "calibration trials at this per-effect probability.  0 disables.")
    p.add_argument("--out", help="Sidecar path (default: next to the backend's checkpoint)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)

    from ..backends import get_backend
    from ..data.synth_families import family_utterance
    from ..ops.cosine import asnorm

    backend = get_backend(args.backend, device=args.device)
    families = [int(x) for x in str(args.families).split(",") if x != ""]

    aug_rng = np.random.default_rng(12345)
    aug_spec = None
    if args.augment_prob > 0:
        from ..data.augment import AugmentSpec, augment_batch

        aug_spec = AugmentSpec.uniform(args.augment_prob)

    def make(spk: int, utt: int) -> np.ndarray:
        fam = families[spk % len(families)]
        wav = family_utterance(fam, args.base_id + spk, utt, args.seconds)
        if aug_spec is not None:
            wav = augment_batch(wav[None, :], aug_rng, aug_spec)[0]
        return np.asarray(wav, np.float32)

    def embed_all(wavs: list[np.ndarray]) -> np.ndarray:
        return np.asarray(backend.embed_batch(wavs), np.float32)

    n_spk, n_trial = args.speakers, args.trials_per_speaker
    enroll = embed_all([make(s, 0) for s in range(n_spk)])
    trials = embed_all([make(s, 1 + t) for s in range(n_spk) for t in range(n_trial)])
    trial_spk = np.repeat(np.arange(n_spk), n_trial)

    # AS-norm cohort: further unseen voices, ids offset another 100 000
    cohort = None
    if args.cohort_size > 0:
        cohort = _unit(embed_all([make(100_000 + i, 0) for i in range(args.cohort_size)]))

    raw = _unit(trials) @ _unit(enroll).T  # (S*T, S)
    idx = np.arange(len(trials))
    mask = np.ones_like(raw, bool)
    mask[idx, trial_spk] = False
    raw_gen, raw_imp = raw[idx, trial_spk], raw[mask]
    raw_eer, raw_t = eer_point(raw_gen, raw_imp)

    if cohort is not None:
        scored = asnorm(raw, _unit(trials) @ cohort.T, _unit(enroll) @ cohort.T)
        score_space = "asnorm"
    else:
        scored = raw
        score_space = "raw"
    genuine, impostor = scored[idx, trial_spk], scored[mask]

    eer, t_star = eer_point(genuine, impostor)
    mu_gen = float(genuine.mean())
    gain = (0.9 - 0.354) / max(mu_gen - t_star, 1e-3)
    calib = {
        # the affine map, fitted in the space score_matrix scores in
        "eer_threshold": round(t_star, 4),
        "gain": round(gain, 4),
        "score_space": score_space,
        "calibration_eer": round(eer, 4),
        "genuine_mean": round(mu_gen, 4),
        "impostor_mean": round(float(impostor.mean()), 4),
        # raw-cosine measurements, for cluster merging and streaming
        "raw_eer_threshold": round(raw_t, 4),
        "raw_eer": round(raw_eer, 4),
        "raw_genuine_mean": round(float(raw_gen.mean()), 4),
        "raw_impostor_mean": round(float(raw_imp.mean()), 4),
        # the merge bar of cluster.spectral.merge_count: midway between
        # same- and different-speaker cosine in this embedding space
        "suggested_merge_tau": round(0.5 * float(raw_gen.mean() + raw_imp.mean()), 4),
        "speakers": n_spk,
        "base_id": args.base_id,
        "families": families,
        "cohort_size": int(0 if cohort is None else len(cohort)),
        "augment_prob": args.augment_prob,
        "provenance": "training-family voices unseen in training "
                      "(data/synth_families.py ids >= base_id); held-out "
                      "eval family (data/synth_heldout.py) not used",
    }

    out = args.out
    if not out:
        engine = getattr(backend, "engine", None)
        src = getattr(engine, "params_source", None)
        if not src or src == "random-init":
            print("no checkpoint to attach a sidecar to; use --out", file=sys.stderr)
            return 1
        out = str(Path(src).with_suffix(".calib.json"))
    if cohort is not None:
        if str(out).endswith(".calib.json"):
            cohort_path = Path(str(out).replace(".calib.json", ".cohort.npy"))
        else:
            cohort_path = Path(out).with_suffix("").with_suffix(".cohort.npy")
        np.save(cohort_path, cohort.astype(np.float32))
        print(f"wrote {cohort_path}", file=sys.stderr)
    Path(out).write_text(json.dumps(calib, indent=2) + "\n")
    print(f"wrote {out}", file=sys.stderr)
    print(json.dumps({"benchmark": "calibration", "backend": args.backend, **calib}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
