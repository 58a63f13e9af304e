"""Sub-window boundary localization for diarization turn changes.

Window-quantized output claims each window's FULL [start, start+window)
span for its label.  With overlapped windows (1.0 s at 0.375 s hop) a
label change between consecutive windows therefore produces two
*conflicting* claims over their 0.625 s overlap region — segment A ends
at ``start_i + window`` while segment B already began at ``start_{i+1}``.
A collar of 0.75 s absorbs that ambiguity entirely (which is why the r4
matrix only reported collar 0.75); at the AMI-convention collar of
0.25 s it IS the dominant residual error (r4 oracle measurement,
docs/PERFORMANCE.md: overlap detection gains ~0 while boundary
quantization dominates).

This module replaces the window-quantized cut with a localized change
point per transition:

1. **Similarity crossing.**  Each window's cosine against the two
   disputing centroids is a sample of the continuous "who is speaking"
   evidence at the window's center.  Linear interpolation between the
   last A-window's center and the first B-window's center of the margin
   ``d(t) = sim_A(t) - sim_B(t)`` crosses zero exactly once when the
   evidence flips; that crossing is the change-point estimate.  (This is
   the "per-frame similarity interpolation between adjacent window
   embeddings" lever named by the r4 analysis.)
2. **Pause snapping.**  Real speaker changes overwhelmingly happen at
   pauses.  When the trained VAD's speech intervals expose a non-speech
   gap near the crossing, the boundary snaps to the gap's midpoint —
   frame-level (10 ms) localization where the acoustics support it.

The reference toolkit never faces this problem — its diarization labels
arrive word-aligned from the Speechmatics cloud
(speaker_detection_backends/transcript.py:123-188); a diarizer of its
own owns its boundary placement.

A NumPy copy of ``sdtk_tpu/cluster/boundary.py`` (identical numerics).
"""

from __future__ import annotations

import numpy as np

Segment = tuple[float, float, str]


def _unit(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def _centroids(e: np.ndarray, labels: np.ndarray, k: int) -> np.ndarray:
    c = np.stack([
        e[labels == j].mean(axis=0) if np.any(labels == j)
        else np.zeros(e.shape[1])
        for j in range(k)
    ])
    return _unit(c)


def _snap_to_pause(
    t: float,
    lo: float,
    hi: float,
    speech_spans: list[tuple[float, float]] | None,
    radius: float,
) -> float:
    """Move the boundary to the midpoint of a non-speech gap near ``t``
    (within ``radius`` and inside [lo, hi]), when one exists.  Gaps are
    the complements of the VAD speech intervals; the NEAREST gap
    midpoint wins."""
    if not speech_spans:
        return t
    best, best_dist = t, radius
    prev_end = None
    for a, b in speech_spans:
        if prev_end is not None and a > prev_end:
            mid = 0.5 * (prev_end + a)
            if lo <= mid <= hi:
                d = abs(mid - t)
                if d <= best_dist:
                    best, best_dist = mid, d
        prev_end = b if prev_end is None else max(prev_end, b)
    return best


def refine_segments(
    emb: np.ndarray,
    labels: np.ndarray,
    window_starts: np.ndarray,
    window_s: float,
    prefix: str = "S",
    speech_spans: list[tuple[float, float]] | None = None,
    snap_radius: float = 0.3,
) -> list[Segment]:
    """Window labels → segments with LOCALIZED change points.

    Unlike :func:`..cluster.der.labels_to_segments` (each window claims
    its full span; adjacent differing labels overlap by
    ``window - hop``), every transition emits exactly one cut:

    - at the zero crossing of the interpolated similarity margin
      between the two windows' centers (falling back to the midpoint of
      the windows' physical overlap when the margin does not cross);
    - snapped to the nearest VAD non-speech gap midpoint within
      ``snap_radius`` when ``speech_spans`` expose one.

    Contiguity breaks (VAD-removed windows: consecutive starts further
    apart than ``window_s``) end the segment at the last window's end,
    exactly as before.

    Args:
        emb: (N, D) window embeddings (any scale; normalized here).
        labels: (N,) integer window labels.
        window_starts: (N,) window start times, seconds, ascending.
        window_s: window duration in seconds.
        prefix: label prefix for output segment names.
        speech_spans: optional merged (start, end) speech intervals from
            the trained VAD (pipeline/vad.py) for pause snapping.
        snap_radius: max seconds a cut may move to reach a pause.
    """
    labels = np.asarray(labels)
    starts = np.asarray(window_starts, dtype=np.float64)
    n = len(labels)
    if n == 0:
        return []
    if n == 1:
        return [(float(starts[0]), float(starts[0]) + window_s,
                 f"{prefix}{int(labels[0]):02d}")]

    e = _unit(np.asarray(emb, np.float64))
    k = int(labels.max()) + 1
    sims = e @ _centroids(e, labels, k).T  # (N, K)
    centers = starts + window_s / 2.0

    segs: list[Segment] = []
    seg_start = float(starts[0])
    for i in range(n - 1):
        gap = starts[i + 1] - starts[i] > window_s + 1e-6
        change = labels[i + 1] != labels[i]
        if not gap and not change:
            continue
        seg_end = float(starts[i]) + window_s
        if gap:
            segs.append((seg_start, seg_end,
                         f"{prefix}{int(labels[i]):02d}"))
            seg_start = float(starts[i + 1])
            continue
        # label change inside a contiguous block: localize the cut
        a, b = int(labels[i]), int(labels[i + 1])
        d_i = float(sims[i, a] - sims[i, b])       # >0: window i favors A
        d_j = float(sims[i + 1, a] - sims[i + 1, b])  # <0: i+1 favors B
        lo = float(starts[i + 1])      # first instant both windows cover
        hi = seg_end                    # last instant both windows cover
        if d_i > 0.0 > d_j:
            frac = d_i / (d_i - d_j)
            cut = float(centers[i] + frac * (centers[i + 1] - centers[i]))
        else:
            cut = 0.5 * (lo + hi)
        cut = min(max(cut, lo), hi)
        cut = _snap_to_pause(cut, lo, hi, speech_spans, snap_radius)
        # monotonicity vs the previous cut (A B A flutter on
        # single-window runs must not produce inverted segments)
        cut = max(cut, seg_start + 1e-3)
        segs.append((seg_start, cut, f"{prefix}{a:02d}"))
        seg_start = cut
    segs.append((seg_start, float(starts[-1]) + window_s,
                 f"{prefix}{int(labels[-1]):02d}"))
    return segs
