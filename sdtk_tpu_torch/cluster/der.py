"""Diarization Error Rate — the accuracy harness metric (BASELINE.md: DER
parity on AMI is a north-star target).

Frame-based DER (10 ms frames by default) with optional NIST-style collar
around reference boundaries and optimal (Hungarian) speaker mapping.
Supports overlapped speech: each frame holds a *set* of speakers on both
sides; errors follow the standard decomposition
miss + false alarm + speaker confusion, normalized by total reference
speech time.  A copy of ``sdtk_tpu/cluster/der.py``.
"""

from __future__ import annotations

import numpy as np

Segment = tuple[float, float, str]  # (start_sec, end_sec, label)


def _frame_speaker_matrix(
    segments: list[Segment], labels: list[str], n_frames: int, step: float
) -> np.ndarray:
    """(n_frames, n_labels) bool activity matrix."""
    idx = {lbl: i for i, lbl in enumerate(labels)}
    act = np.zeros((n_frames, len(labels)), dtype=bool)
    for start, end, lbl in segments:
        a = int(np.floor(start / step))
        b = int(np.ceil(end / step))
        act[max(a, 0) : min(b, n_frames), idx[lbl]] = True
    return act


def diarization_error_rate(
    reference: list[Segment],
    hypothesis: list[Segment],
    collar: float = 0.25,
    step: float = 0.01,
) -> dict[str, float]:
    """Returns {"der", "miss", "false_alarm", "confusion", "total"} (rates
    are fractions of total reference speech time; "total" is seconds)."""
    if not reference:
        return {"der": 0.0, "miss": 0.0, "false_alarm": 0.0, "confusion": 0.0, "total": 0.0}

    end_time = max(
        [e for _, e, _ in reference] + [e for _, e, _ in hypothesis] + [0.0]
    )
    n_frames = int(np.ceil(end_time / step)) + 1
    ref_labels = sorted({lbl for _, _, lbl in reference})
    hyp_labels = sorted({lbl for _, _, lbl in hypothesis})
    ref = _frame_speaker_matrix(reference, ref_labels, n_frames, step)
    hyp = (
        _frame_speaker_matrix(hypothesis, hyp_labels, n_frames, step)
        if hypothesis
        else np.zeros((n_frames, 0), dtype=bool)
    )

    # Collar: exclude frames within ±collar of any reference boundary.
    keep = np.ones(n_frames, dtype=bool)
    if collar > 0:
        half = collar
        for start, end, _ in reference:
            for t in (start, end):
                a = int(np.floor((t - half) / step))
                b = int(np.ceil((t + half) / step))
                keep[max(a, 0) : min(b, n_frames)] = False
    ref, hyp = ref[keep], hyp[keep]

    # Optimal ref↔hyp label mapping by overlap time.
    overlap = ref.astype(np.float64).T @ hyp.astype(np.float64)  # (R, H)
    mapping: dict[int, int] = {}
    if overlap.size:
        from scipy.optimize import linear_sum_assignment

        rows, cols = linear_sum_assignment(-overlap)
        mapping = {int(r): int(c) for r, c in zip(rows, cols) if overlap[r, c] > 0}

    n_ref = ref.sum(axis=1)  # speakers per frame
    n_hyp = hyp.sum(axis=1)
    # Correct = matched (ref_label → mapped hyp label active) per frame.
    correct = np.zeros(len(ref), dtype=np.int64)
    for r, c in mapping.items():
        correct += ref[:, r] & hyp[:, c]

    total = float(n_ref.sum()) * step
    miss = float(np.maximum(n_ref - n_hyp, 0).sum()) * step
    fa = float(np.maximum(n_hyp - n_ref, 0).sum()) * step
    conf = float((np.minimum(n_ref, n_hyp) - correct).clip(min=0).sum()) * step

    if total == 0:
        return {"der": 0.0, "miss": 0.0, "false_alarm": 0.0, "confusion": 0.0, "total": 0.0}
    return {
        "der": (miss + fa + conf) / total,
        "miss": miss / total,
        "false_alarm": fa / total,
        "confusion": conf / total,
        "total": total,
    }


def load_rttm(path) -> dict[str, list[Segment]]:
    """Parse an RTTM file → {recording_id: [(start, end, label), ...]}.

    Standard NIST format: ``SPEAKER <rec> <chan> <tbeg> <tdur> <NA> <NA>
    <name> <NA> [<NA>]`` — the interchange format for AMI/DIHARD references.
    """
    out: dict[str, list[Segment]] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 8 or parts[0] != "SPEAKER":
                continue
            rec, tbeg, tdur, name = parts[1], float(parts[3]), float(parts[4]), parts[7]
            out.setdefault(rec, []).append((tbeg, tbeg + tdur, name))
    for segs in out.values():
        segs.sort()
    return out


def labels_to_segments(
    labels: np.ndarray, window_starts: np.ndarray, window_dur: float,
    prefix: str = "SPK",
) -> list[Segment]:
    """Window-level cluster labels → merged (start, end, label) segments."""
    segs: list[Segment] = []
    cur: list | None = None
    for lbl, start in zip(labels, window_starts):
        name = f"{prefix}{int(lbl):02d}"
        end = float(start) + window_dur
        if cur is not None and cur[2] == name and start <= cur[1] + 1e-6:
            cur[1] = end
        else:
            if cur is not None:
                segs.append(tuple(cur))
            cur = [float(start), end, name]
    if cur is not None:
        segs.append(tuple(cur))
    return segs
