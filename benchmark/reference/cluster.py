"""Plain spectral clustering in float64 NumPy: a frozen statement of the
port's device clustering (``cluster_stage`` and ``spectral_cluster``).

Affinity (1 + cos) / 2 → zero diagonal → per row keep the top
max(3, round(0.05·N)) entries and scale the rest by 0.01 → symmetrize by the
maximum → the diagonal set to each row's maximum → normalized Laplacian
I − D^-½ A D^-½ → its smallest eigenvectors (an exact ``eigh``; the port may
iterate a subspace, which spans the same eigenvectors up to a rotation, and
k-means on unit rows does not see a rotation) → unit rows → k-means:
farthest-point start from row 0, 25 Lloyd steps, ties to the lowest index,
an empty cluster's centre at the origin.  The speaker count is the port's
over-cluster-then-merge: k-means at ``max_speakers`` on the eigenvectors,
then average-linkage merging of groups whose mean embeddings' cosine clears
0.47.

``tf32=True`` is the control: float32 throughout, the operands of every
product rounded to TF32, k-means distances as ‖x‖² − 2x·c + ‖c‖².
"""

from __future__ import annotations

import numpy as np

from .precision import tf32 as to_tf32

MERGE_TAU = 0.47


class _Arith:
    def __init__(self, tf32: bool):
        self.tf32 = tf32
        self.dtype = np.float32 if tf32 else np.float64

    def mm(self, a, b):
        if self.tf32:
            return to_tf32(a) @ to_tf32(b)
        return a @ b


def unit_rows(x: np.ndarray, dtype=np.float64) -> np.ndarray:
    x = np.asarray(x, dtype)
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def laplacian_eigvecs(emb: np.ndarray, p_percentile: float = 0.95, tf32: bool = False
                      ) -> np.ndarray:
    """All eigenvectors of the refined affinity's normalized Laplacian,
    eigenvalues ascending."""
    ar = _Arith(tf32)
    e = unit_rows(emb, ar.dtype)
    n = len(e)
    a = (1.0 + ar.mm(e, e.T)) * 0.5
    np.fill_diagonal(a, 0.0)
    k = min(n - 1, max(3, int(round((1.0 - p_percentile) * n))))
    kth = -np.partition(-a, k - 1, axis=1)[:, k - 1 : k]
    a = np.where(a >= kth, a, a * 0.01)
    a = np.maximum(a, a.T)
    np.fill_diagonal(a, a.max(axis=1))
    inv = 1.0 / np.sqrt(np.maximum(a.sum(axis=1), 1e-12))
    lap = np.eye(n, dtype=ar.dtype) - a * inv[:, None] * inv[None, :]
    return np.linalg.eigh(lap.astype(ar.dtype))[1]


def kmeans(x: np.ndarray, k: int, n_iters: int = 25, tf32: bool = False) -> np.ndarray:
    ar = _Arith(tf32)
    x = np.asarray(x, ar.dtype)
    n = len(x)
    centers = np.zeros((k, x.shape[1]), ar.dtype)
    centers[0] = x[0]
    min_d2 = np.full(n, np.inf)
    for i in range(1, k):
        min_d2 = np.minimum(min_d2, ((x - centers[i - 1]) ** 2).sum(axis=1))
        centers[i] = x[int(np.argmax(min_d2))]
    assign = np.zeros(n, np.int64)
    for _ in range(n_iters):
        if tf32:
            d2 = ((x * x).sum(1)[:, None] - 2.0 * ar.mm(x, centers.T)
                  + (centers * centers).sum(1)[None, :])
        else:
            d2 = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(axis=2)
        assign = np.argmin(d2, axis=1)
        onehot = np.eye(k, dtype=ar.dtype)[assign]
        centers = ar.mm(onehot.T, x) / np.maximum(onehot.sum(axis=0), 1e-6)[:, None]
    return assign


def merge_count(emb_unit: np.ndarray, labels: np.ndarray, tau: float = MERGE_TAU,
                tf32: bool = False) -> int:
    """Groups left after average-linkage merging while the most similar
    pair's mean embeddings have cosine-sum similarity ≥ ``tau``."""
    uniq = np.unique(labels)
    means = [emb_unit[labels == j].mean(axis=0) for j in uniq]
    sizes = [float((labels == j).sum()) for j in uniq]
    while len(means) > 1:
        m = np.stack(means)
        sims = _Arith(tf32).mm(m, m.T)
        np.fill_diagonal(sims, -np.inf)
        i, j = divmod(int(np.argmax(sims)), len(means))
        if sims[i, j] < tau:
            break
        w = sizes[i] + sizes[j]
        means[i] = (sizes[i] * means[i] + sizes[j] * means[j]) / w
        sizes[i] = w
        del means[j], sizes[j]
    return len(means)


def cluster_fixed(emb: np.ndarray, k: int, tf32: bool = False) -> np.ndarray:
    """``cluster_stage``: labels of N windows into exactly ``k`` groups."""
    dt = _Arith(tf32).dtype
    return kmeans(unit_rows(laplacian_eigvecs(emb, tf32=tf32)[:, :k], dt), k, tf32=tf32)


def cluster_count(emb: np.ndarray, max_speakers: int = 8, tf32: bool = False
                  ) -> tuple[np.ndarray, int]:
    """``spectral_cluster`` with the count estimated: (labels, count)."""
    dt = _Arith(tf32).dtype
    n = len(emb)
    kmax = min(max_speakers, n)
    vecs = laplacian_eigvecs(emb, tf32=tf32)
    count = merge_count(unit_rows(emb, dt), kmeans(unit_rows(vecs[:, :kmax], dt), kmax, tf32=tf32),
                        tf32=tf32)
    count = max(1, min(count, kmax))
    if count == 1:
        return np.zeros(n, np.int64), 1
    return kmeans(unit_rows(vecs[:, :count], dt), count, tf32=tf32), count
