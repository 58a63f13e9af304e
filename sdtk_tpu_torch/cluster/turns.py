"""Turn-level speaker-count estimation (a NumPy copy of
``sdtk_tpu/cluster/turns.py``, identical numerics).

r3 finding: window-level statistics cannot count speakers on hard
domains.  On the held-out family, 1.5 s window embeddings showed
within-speaker linkage ≈ 0.75–0.80 vs cross-speaker ≈ 0.61–0.64 — a
cross/within ratio ≈ 0.8–0.86 that defeats both a fixed absolute merge
bar (r2's failure) and the r2 scale-free ratio bar (rel = 0.75), while
utterance-level verification on the same checkpoint is at 1.8% EER.
The information is there; the windows are just too short and too
boundary-contaminated.

Fix: estimate the count on TURN-level statistics —

1. **Change-point segmentation** (:func:`turn_segment_ids`): cut the
   window sequence where adjacent-window or skip-one-window similarity
   dips below a fraction of its own median (scale-free), at time gaps,
   and at a max run length.  Over-segmentation is harmless (purity is
   what matters; measured ≥ 0.92 on both families); under-segmentation
   is not.
2. **Denoised segment means** → two complementary estimators:
   - :func:`ahc_count_means` — average-linkage AHC with the scale-free
     relative bar ``max(tau, rel·min(within_i, within_j))`` computed on
     segment means (a singleton group borrows the other side's within —
     ``nanmin`` — so boundary turns aren't held to an unmeasurable
     standard).  Tends to UNDER-count when speakers sit close.
   - :func:`shoulder_count` — Laplacian spectrum of the row-max
     normalized segment affinity; counts eigenvalues below the
     "shoulder" ``λ₂ + γ·(bulk − λ₂)`` — relative to the meeting's own
     spectral contrast, so it transfers across domains.  A
     structure-gap guard (``bulk − λ₂ < min_structure·bulk``) detects
     single-speaker meetings.  Tends to be right where AHC
     under-counts, and never collapses to 1 when structure exists.
3. **Composite**: ``k = max(AHC, shoulder)`` — the failure modes are
   complementary (measured on an 11-meeting two-family sweep: 8/11
   exact, all misses ±1, no collapse; the r2 window-level rule
   collapsed every held-out meeting to k=1).
"""

from __future__ import annotations

import numpy as np


def _unit(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def turn_segment_ids(
    emb: np.ndarray,
    starts: np.ndarray | None = None,
    hop_s: float = 0.75,
    beta: float = 0.85,
    max_len: int = 4,
) -> np.ndarray:
    """Window embeddings (+ optional start times) → turn segment ids.

    Boundaries at: time gaps (> hop), adjacent-similarity dips below
    ``beta × median(adjacent)``, skip-one-similarity dips below
    ``beta × median(skip)`` (the skip signal sees past the boundary-
    straddling window that blurs the adjacent signal), and every
    ``max_len`` windows (caps impurity from missed boundaries).
    """
    e = _unit(np.asarray(emb, np.float64))
    n = len(e)
    ids = np.zeros(n, dtype=np.int64)
    if n <= 1:
        return ids
    adj = (e[:-1] * e[1:]).sum(axis=1)
    med = float(np.median(adj))
    skip = (e[:-2] * e[2:]).sum(axis=1) if n > 2 else np.zeros(0)
    med_s = float(np.median(skip)) if len(skip) else 1.0
    cur, run = 0, 1
    for i in range(1, n):
        time_gap = (
            starts is not None and starts[i] - starts[i - 1] > hop_s + 1e-6
        )
        dip = adj[i - 1] < beta * med
        sdip = (i - 1 < len(skip)) and skip[i - 1] < beta * med_s
        if time_gap or dip or sdip or run >= max_len:
            cur += 1
            run = 1
        else:
            run += 1
        ids[i] = cur
    return ids


def turn_means(emb: np.ndarray, seg_ids: np.ndarray) -> np.ndarray:
    """Unit segment-mean embeddings, one row per segment id."""
    e = _unit(np.asarray(emb, np.float64))
    uniq = np.unique(seg_ids)
    return _unit(np.stack([e[seg_ids == s].mean(axis=0) for s in uniq]))


def ahc_count_means(
    means: np.ndarray, tau: float = 0.42, rel: float = 0.75,
    max_speakers: int = 8, sizes: np.ndarray | None = None,
    min_windows: int = 2,
) -> tuple[int, np.ndarray]:
    """Average-linkage AHC over segment means with the scale-free
    relative bar.  Returns (count, group id per segment).

    ``sizes`` (windows per segment): groups whose total window evidence
    stays below ``min_windows`` after merging are absorbed into their
    nearest group instead of counting as speakers — a single
    boundary-straddling window (a mix of two real speakers) otherwise
    survives as a phantom cluster."""
    m = _unit(np.asarray(means, np.float64))
    groups: list[list[int]] = [[i] for i in range(len(m))]

    def within(g: list[int]) -> float:
        if len(g) < 2:
            return float("nan")
        x = m[g]
        s = x @ x.T
        n = len(g)
        return float((s.sum() - np.trace(s)) / (n * n - n))

    def cross(a: list[int], b: list[int]) -> float:
        return float((m[a] @ m[b].T).mean())

    while len(groups) > 1:
        best = (-np.inf, (0, 0))
        for i in range(len(groups)):
            for j in range(i + 1, len(groups)):
                c = cross(groups[i], groups[j])
                ws = [
                    w
                    for w in (within(groups[i]), within(groups[j]))
                    if not np.isnan(w)
                ]
                bar = max(tau, rel * min(ws)) if ws else tau
                if c - bar > best[0]:
                    best = (c - bar, (i, j))
        if best[0] < 0 and len(groups) <= max_speakers:
            break
        i, j = best[1]
        groups[i] = groups[i] + groups[j]
        del groups[j]
    if sizes is not None and len(groups) > 1:
        sz = np.asarray(sizes, np.float64)
        while len(groups) > 1:
            counts = [float(sz[g].sum()) for g in groups]
            tiny = [gi for gi, c in enumerate(counts) if c < min_windows]
            if not tiny:
                break
            gi = tiny[0]
            best_j, best_c = None, -np.inf
            for j in range(len(groups)):
                if j == gi:
                    continue
                c = cross(groups[gi], groups[j])
                if c > best_c:
                    best_c, best_j = c, j
            groups[best_j] = groups[best_j] + groups[gi]
            del groups[gi]
    labels = np.zeros(len(m), dtype=np.int64)
    for gi, g in enumerate(groups):
        labels[g] = gi
    return len(groups), labels


def shoulder_count(
    means: np.ndarray, max_speakers: int = 8, gamma: float = 0.6,
    min_structure: float = 0.03,
) -> int:
    """Spectral count from segment means: eigenvalues of the normalized
    Laplacian of the row-max-normalized affinity below the shoulder
    ``λ₂ + γ·(bulk − λ₂)``; 1 when the spectrum carries no structure."""
    m = _unit(np.asarray(means, np.float64))
    n = len(m)
    if n < 3:
        return n
    sim = (1.0 + m @ m.T) * 0.5
    np.fill_diagonal(sim, 0.0)
    a = sim / np.maximum(sim.max(axis=1, keepdims=True), 1e-9)
    a = np.maximum(a, a.T)
    np.fill_diagonal(a, 1.0)
    d = np.maximum(a.sum(axis=1), 1e-12)
    lap = np.eye(n) - a / np.sqrt(d[:, None] * d[None, :])
    ev = np.linalg.eigvalsh(lap)
    lam2 = float(ev[1])
    bulk = float(np.median(ev[max(1, n // 2):]))
    if bulk - lam2 < min_structure * max(bulk, 1e-9):
        return 1  # spectrum flat above λ₁ → no cluster structure
    bar = lam2 + gamma * (bulk - lam2)
    kk = min(max_speakers + 1, n)
    return int(np.clip((ev[:kk] < bar).sum(), 1, max_speakers))


def estimate_speaker_count(
    emb: np.ndarray,
    starts: np.ndarray | None = None,
    hop_s: float = 0.75,
    tau: float = 0.42,
    rel: float = 0.75,
    max_speakers: int = 8,
) -> int:
    """Composite turn-level speaker-count estimate (see module doc)."""
    seg = turn_segment_ids(emb, starts, hop_s)
    means = turn_means(emb, seg)
    sizes = np.asarray([(seg == s).sum() for s in np.unique(seg)])
    k_ahc, _ = ahc_count_means(means, tau=tau, rel=rel,
                               max_speakers=max_speakers, sizes=sizes)
    k_sh = shoulder_count(means, max_speakers=max_speakers)
    return int(np.clip(max(k_ahc, k_sh), 1, max_speakers))


def turn_cluster(
    emb: np.ndarray,
    starts: np.ndarray | None = None,
    hop_s: float = 0.75,
    tau: float = 0.42,
    rel: float = 0.75,
    max_speakers: int = 8,
    device: str | None = None,
) -> tuple[np.ndarray, int]:
    """Full auto-k clustering of window embeddings via turn statistics.

    Count = max(AHC, shoulder).  Assignment: when the AHC bar itself
    chose k, the AHC turn groups are already speaker-coherent — windows
    take their group's centroid by nearest-centroid assignment (measured
    3× lower same-family DER than re-running spectral k-means, whose
    farthest-point init can land on outlier windows).  When the spectral
    shoulder overrides the count upward, fall back to spectral
    clustering at that k (the AHC trajectory's own groups under-split by
    construction there).  Returns (window labels, k).  ``device`` is
    where that spectral fallback runs its device path (N ≥ 1024).
    """
    from .spectral import spectral_cluster

    e = _unit(np.asarray(emb, np.float64))
    seg = turn_segment_ids(e, starts, hop_s)
    means = turn_means(e, seg)
    sizes = np.asarray([(seg == s).sum() for s in np.unique(seg)])
    k_ahc, glab = ahc_count_means(means, tau=tau, rel=rel,
                                  max_speakers=max_speakers, sizes=sizes)
    k_sh = shoulder_count(means, max_speakers=max_speakers)
    k = int(np.clip(max(k_ahc, k_sh), 1, max_speakers))
    if k <= 1:
        return np.zeros(len(e), dtype=np.int32), 1
    if k == k_ahc:
        uniq = list(np.unique(seg))
        w2g = np.asarray([glab[uniq.index(s)] for s in seg])
        cents = np.stack([
            e[w2g == g].mean(axis=0) for g in range(k) if (w2g == g).any()
        ])
        cents = _unit(cents)
        labels = np.argmax(e @ cents.T, axis=1).astype(np.int32)
        return labels, int(cents.shape[0])
    labels, kk = spectral_cluster(
        np.asarray(emb, np.float32), n_speakers=k, max_speakers=max_speakers,
        device=device,
    )
    return labels, kk
