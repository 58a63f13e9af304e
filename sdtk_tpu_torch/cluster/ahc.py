"""Agglomerative hierarchical clustering — host-side fallback for tiny
inputs (a handful of windows, where spectral machinery is overkill).

Average-linkage on cosine similarity with a stopping threshold, NumPy only.
A copy of ``sdtk_tpu/cluster/ahc.py`` (identical labels).
"""

from __future__ import annotations

import numpy as np


def ahc_labels(
    emb: np.ndarray,
    threshold: float = 0.55,
    n_speakers: int | None = None,
) -> np.ndarray:
    """(N, D) → (N,) int labels.  Merges the closest pair of clusters
    (average linkage over cosine sim) until either the best similarity
    drops below ``threshold`` (if n_speakers is None) or the target count
    is reached."""
    n = len(emb)
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    e = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    sims = e @ e.T

    clusters: list[list[int]] = [[i] for i in range(n)]
    while len(clusters) > 1:
        if n_speakers is not None and len(clusters) <= n_speakers:
            break
        best = (-2.0, -1, -1)
        for i in range(len(clusters)):
            for j in range(i + 1, len(clusters)):
                s = float(np.mean(sims[np.ix_(clusters[i], clusters[j])]))
                if s > best[0]:
                    best = (s, i, j)
        s, i, j = best
        if n_speakers is None and s < threshold:
            break
        clusters[i] = clusters[i] + clusters[j]
        del clusters[j]

    labels = np.zeros(n, dtype=np.int32)
    for lbl, members in enumerate(clusters):
        labels[members] = lbl
    return labels
