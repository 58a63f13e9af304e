"""HMM/Viterbi resegmentation over window posteriors.

Standard post-clustering DER reducer (the VBx-family idea, simplified):
treat the clustered speakers as HMM states, score each window against the
speaker centroids (scaled-cosine log-likelihoods), and decode the
maximum-a-posteriori state path with a sticky transition prior.  Isolated
single-window label flips — the dominant spectral-clustering error mode on
hop-overlapped windows — are smoothed away because a flip costs two
transition penalties.

A NumPy copy of ``sdtk_tpu/cluster/resegment.py`` (identical numerics)
whose Viterbi decode runs on the host at every length; a device decode
is later work.
"""

from __future__ import annotations

import numpy as np


def _viterbi_numpy(
    log_lik: np.ndarray, n_states: int, stay_logprob: float,
    switch_logprob: float
) -> np.ndarray:
    """Host decode: (T, K) log-likelihoods → MAP path."""
    t_len = len(log_lik)
    trans = np.full((n_states, n_states), switch_logprob)
    np.fill_diagonal(trans, stay_logprob)
    alpha = log_lik[0].copy()
    backptrs = np.empty((t_len - 1, n_states), dtype=np.int64)
    for t in range(1, t_len):
        scores = alpha[:, None] + trans  # (from, to)
        backptrs[t - 1] = scores.argmax(axis=0)
        alpha = scores.max(axis=0) + log_lik[t]
    path = np.empty(t_len, dtype=np.int64)
    path[-1] = int(alpha.argmax())
    for t in range(t_len - 2, -1, -1):
        path[t] = backptrs[t][path[t + 1]]
    return path


def viterbi_decode(
    log_lik, n_states: int, stay_logprob: float = -0.1,
    switch_logprob: float = -3.0
):
    """(T, K) log-likelihoods → (T,) MAP state path.

    Sticky transition matrix: log p(stay) = ``stay_logprob``,
    log p(switch to any other state) = ``switch_logprob`` (unnormalized is
    fine for MAP decoding).  The NumPy decode runs at every length: it
    gives the same MAP path as the JAX package's ``lax.scan`` decode,
    which that package uses above 16,384 windows.
    """
    ll = np.asarray(log_lik, dtype=np.float32)
    return _viterbi_numpy(ll, n_states, stay_logprob, switch_logprob)


def _centroids(e: np.ndarray, labels: np.ndarray, k: int) -> np.ndarray:
    c = np.stack(
        [
            e[labels == j].mean(axis=0)
            if np.any(labels == j)
            else np.zeros(e.shape[1])
            for j in range(k)
        ]
    )
    return c / np.maximum(np.linalg.norm(c, axis=-1, keepdims=True), 1e-12)


def resegment(
    emb: np.ndarray, labels: np.ndarray, n_speakers: int,
    scale: float | None = None, stay_logprob: float = -0.1,
    switch_logprob: float = -3.0, em_iters: int = 2,
    evidence_ratio: float = 2.0,
) -> np.ndarray:
    """Refine window labels: EM centroid refinement + sticky-HMM Viterbi.

    Two r4 fixes, both measured on the cached per-tier meeting sets
    (telephone/clean held-out, same-family, 30%-overlap):

    1. **EM refinement first** (``em_iters`` rounds of recompute-centroids
       → nearest-centroid reassignment): the initial turn-cluster groups
       carry contaminated centroids on shifted domains; nearest-TRUE-
       centroid assignment measured 0.95 window accuracy where the raw
       clustering had 0.875, and two EM rounds recover most of that gap
       (clean held-out DER75 0.220 → 0.184, overlap tier 0.204 → 0.163).
    2. **Adaptive emission temperature**: the old fixed ``scale=10``
       assumed the clean-family cosine geometry.  Telephone band-limiting
       compresses the top1−top2 centroid-similarity gap to ~0.1, so
       emission evidence (≈1.0) drowned under the switch penalty (2.9)
       and Viterbi steamrolled real turns — resegmentation made labels
       WORSE than not running it (window acc 0.875 → 0.700; DER75 0.101
       none vs 0.190 fixed-scale).  The temperature now scales so the
       MEDIAN window's top1−top2 evidence equals ``evidence_ratio`` ×
       the switch cost: isolated single-window flips still smooth away
       (they pay two transitions), but a typical 2+-window run of
       genuine evidence overrides stickiness on every domain geometry.
       Telephone DER75: 0.190 (fixed) → 0.093.  Pass an explicit
       ``scale`` to pin the old behavior.

    Args:
        emb: (N, D) window embeddings (need not be normalized).
        labels: (N,) initial cluster assignment.
        n_speakers: number of clusters K.
        scale: cosine→log-likelihood temperature; None (default) adapts
            to the meeting's own score geometry as above.
        em_iters: EM refinement rounds before the Viterbi pass.
        evidence_ratio: median-evidence / switch-cost target for the
            adaptive temperature.

    Returns:
        (N,) refined labels.  Falls back to the input labels for K < 2.
    """
    if n_speakers < 2 or len(labels) < 3:
        return labels
    e = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
    lab = np.asarray(labels)
    for _ in range(em_iters):
        new = np.argmax(e @ _centroids(e, lab, n_speakers).T, axis=1)
        if (new == lab).all():
            break
        lab = new
    sims = e @ _centroids(e, lab, n_speakers).T  # (N, K)
    if scale is None:
        srt = np.sort(sims, axis=1)
        gap = float(np.median(srt[:, -1] - srt[:, -2]))
        switch_cost = stay_logprob - switch_logprob
        scale = min(evidence_ratio * switch_cost / max(gap, 1e-6), 200.0)
    path = viterbi_decode(
        scale * sims, n_speakers,
        stay_logprob=stay_logprob, switch_logprob=switch_logprob,
    )
    return np.asarray(path)
