"""Spectral clustering: normalized-Laplacian eigenvectors, k-means, and the
over-cluster-then-merge speaker count.

The counterpart of ``sdtk_tpu/cluster/spectral.py``.  Below 1024 windows
the NumPy path runs on the host (a copy of the JAX package's, identical
numerics); from 1024 windows on (or with ``force_device``) the affinity,
Laplacian, eigensolve and k-means run in PyTorch on ``device`` — dense
``torch.linalg.eigh`` up to 4096 windows, subspace iteration beyond.
``cluster_stage`` is the fixed-k device stage that the embed + cluster
throughput measurement times.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.device import resolve_device
from .affinity import cosine_affinity, refine_affinity

EIGVAL_TAU = 0.65
MERGE_TAU = 0.47
MERGE_REL = 0.75


def normalized_laplacian(aff: torch.Tensor) -> torch.Tensor:
    d_inv_sqrt = torch.rsqrt(torch.clamp(aff.sum(dim=1), min=1e-12))
    eye = torch.eye(aff.shape[0], dtype=aff.dtype, device=aff.device)
    return eye - aff * d_inv_sqrt[:, None] * d_inv_sqrt[None, :]


def merge_count(
    emb_unit: np.ndarray, labels: np.ndarray, tau: float = MERGE_TAU,
    rel: float | None = None,
) -> tuple[int, np.ndarray]:
    """Speaker count by over-cluster-then-merge: average-linkage merging
    of groups whose mean pairwise cosine clears ``tau`` (or, with
    ``rel``, ``max(tau, rel · min(within_i, within_j))``).  Returns
    (count, merged root label per window).  See the JAX package's
    docstring for the measurements behind the rule."""
    uniq = np.unique(labels)
    means = np.stack([emb_unit[labels == j].mean(axis=0) for j in uniq])
    sizes = np.asarray([(labels == j).sum() for j in uniq], np.float64)
    group_ids = [int(j) for j in uniq]
    remap = {int(j): int(j) for j in uniq}

    def within(idx: int) -> float:
        n = sizes[idx]
        if n < 2:
            return float("nan")
        return float((n * n * means[idx] @ means[idx] - n) / (n * (n - 1)))

    while len(means) > 1:
        sims = means @ means.T
        np.fill_diagonal(sims, -np.inf)
        k = len(means)
        bars = np.full((k, k), tau)
        if rel is not None:
            withins = np.asarray([within(g) for g in range(k)])
            w_min = np.minimum(withins[:, None], withins[None, :])
            bars = np.where(np.isnan(w_min), tau,
                            np.maximum(tau, rel * w_min))
        margin = sims - bars
        flat = int(np.argmax(margin))
        i, j = divmod(flat, k)
        if margin[i, j] < 0:
            break
        w = sizes[i] + sizes[j]
        means[i] = (sizes[i] * means[i] + sizes[j] * means[j]) / w
        sizes[i] = w
        for src, dst in remap.items():
            if dst == group_ids[j]:
                remap[src] = group_ids[i]
        means = np.delete(means, j, axis=0)
        sizes = np.delete(sizes, j)
        del group_ids[j]
    merged = np.asarray([remap[int(l)] for l in labels])
    return len(means), merged


def kmeans(x: torch.Tensor, k: int, n_iters: int = 25) -> torch.Tensor:
    """Fixed-iteration k-means with deterministic farthest-point init
    (the JAX device k-means: argmin ties go to the lowest index, empty
    clusters collapse toward the origin as there)."""
    n = x.shape[0]
    centers = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = x[0]
    min_d2 = torch.full((n,), float("inf"), dtype=x.dtype, device=x.device)
    for i in range(1, k):
        min_d2 = torch.minimum(min_d2, ((x - centers[i - 1]) ** 2).sum(dim=1))
        centers[i] = x[torch.argmax(min_d2)]
    assign = torch.zeros(n, dtype=torch.int64, device=x.device)
    xx = (x * x).sum(dim=1, keepdim=True)
    for _ in range(n_iters):
        d2 = xx - 2.0 * x @ centers.T + (centers * centers).sum(dim=1)[None, :]
        assign = torch.argmin(d2, dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype)
        counts = torch.clamp(onehot.sum(dim=0), min=1e-6)
        centers = (onehot.T @ x) / counts[:, None]
    return assign


def topk_eigvecs_subspace(
    lap: torch.Tensor, k: int, n_iters: int = 50,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k eigenpairs of a normalized Laplacian by subspace iteration
    on (2·I − L)², then Rayleigh–Ritz.  Returns (eigvals ascending,
    eigvecs (N, k)).  The random start comes from ``generator`` (default:
    seed 0 on the CPU), so it is not the JAX package's start: eigenvalues
    agree, eigenvectors only up to rotation within degenerate spaces."""
    n = lap.shape[0]
    c = 2.0
    a = c * torch.eye(n, dtype=lap.dtype, device=lap.device) - lap
    m = min(n, k + 8)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    q = torch.randn((n, m), generator=generator, dtype=lap.dtype).to(lap.device)
    q, _ = torch.linalg.qr(q)
    for _ in range(n_iters):
        q, _ = torch.linalg.qr(a @ (a @ q))
    w, s = torch.linalg.eigh(q.T @ (a @ q))
    lam = c - w
    order = torch.argsort(lam)
    return lam[order][:k], (q @ s)[:, order][:, :k]


def _row_unit(x):
    if isinstance(x, torch.Tensor):
        return x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True), min=1e-12)
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def _spectral_cluster_numpy(
    emb: np.ndarray, n_speakers: int | None, max_speakers: int,
    p_percentile: float, merge_tau: float = MERGE_TAU,
    merge_rel: float | None = None,
) -> tuple[np.ndarray, int]:
    """Host path for small window counts (a copy of the JAX package's)."""
    n = emb.shape[0]
    e = _row_unit(emb)
    raw = (1.0 + e @ e.T) * 0.5

    a = raw.copy()
    np.fill_diagonal(a, 0.0)
    k = min(n - 1, max(3, int(round((1.0 - p_percentile) * n))))
    kth = np.partition(a, -k, axis=1)[:, -k][:, None]
    a = np.where(a >= kth, a, a * 0.01)
    a = np.maximum(a, a.T)
    np.fill_diagonal(a, a.max(axis=1))

    d = np.maximum(a.sum(axis=1), 1e-12)
    inv = 1.0 / np.sqrt(d)
    eigvals, eigvecs = np.linalg.eigh(np.eye(n) - a * inv[:, None] * inv[None, :])
    if n_speakers is None:
        kmax = min(max_speakers, n)
        n_speakers, _ = merge_count(e, _kmeans_np(_row_unit(eigvecs[:, :kmax]), kmax),
                                    merge_tau, rel=merge_rel)
    n_speakers = max(1, min(n_speakers, max_speakers))
    if n_speakers == 1:
        return np.zeros(n, dtype=np.int32), 1
    spec = _row_unit(eigvecs[:, :n_speakers])
    return _kmeans_np(spec, n_speakers).astype(np.int32), n_speakers


def _kmeans_np(spec: np.ndarray, k: int, n_iters: int = 25) -> np.ndarray:
    """Farthest-point init + Lloyd iterations (host path)."""
    n = len(spec)
    centers = [spec[0]]
    min_d2 = np.full(n, np.inf)
    for _ in range(1, k):
        min_d2 = np.minimum(min_d2, ((spec - centers[-1]) ** 2).sum(axis=1))
        centers.append(spec[int(np.argmax(min_d2))])
    c = np.stack(centers)
    assign = np.zeros(n, dtype=np.int64)
    for _ in range(n_iters):
        d2 = ((spec[:, None, :] - c[None, :, :]) ** 2).sum(axis=2)
        assign = d2.argmin(axis=1)
        for j in range(k):
            members = spec[assign == j]
            if len(members):
                c[j] = members.mean(axis=0)
    return assign


def spectral_eig(
    emb: torch.Tensor, max_speakers: int = 8, p_percentile: float = 0.95,
    use_subspace: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Device half of the pipeline: (N, D) embeddings → Laplacian
    (eigvals ascending, eigvecs) — all of them for the dense solve, the
    smallest ``max_speakers + 1`` for the subspace path (default above
    4096 windows)."""
    lap = normalized_laplacian(refine_affinity(cosine_affinity(emb), p_percentile))
    if use_subspace is None:
        use_subspace = emb.shape[0] > 4096
    if use_subspace:
        return topk_eigvecs_subspace(lap, max_speakers + 1)
    return torch.linalg.eigh(lap)


def spectral_cluster(
    emb: np.ndarray,
    n_speakers: int | None = None,
    max_speakers: int = 8,
    p_percentile: float = 0.95,
    use_subspace: bool | None = None,
    force_device: bool = False,
    merge_tau: float = MERGE_TAU,
    merge_rel: float | None = None,
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, int]:
    """Embeddings → (labels (N,), n_speakers).  ``n_speakers=None``
    estimates the count by over-cluster-then-merge.  Fewer than 1024
    windows take the NumPy path unless ``force_device``; the device path
    runs on ``device`` (default CUDA, which must then be available)."""
    n = int(emb.shape[0])
    if n == 0:
        return np.zeros(0, dtype=np.int32), 0
    if n == 1:
        return np.zeros(1, dtype=np.int32), 1
    max_speakers = min(max_speakers, n)

    if not force_device and n < 1024:
        return _spectral_cluster_numpy(
            np.asarray(emb, dtype=np.float32), n_speakers, max_speakers,
            p_percentile, merge_tau, merge_rel,
        )

    emb_np = np.asarray(emb, np.float32)
    e = torch.from_numpy(emb_np).to(resolve_device(device))
    _, eigvecs = spectral_eig(e, max_speakers, p_percentile, use_subspace)

    if n_speakers is None:
        kmax = min(max_speakers, n)
        labels0 = kmeans(_row_unit(eigvecs[:, :kmax]), kmax).cpu().numpy()
        n_speakers, _ = merge_count(_row_unit(emb_np), labels0, merge_tau,
                                    rel=merge_rel)
    n_speakers = max(1, min(n_speakers, max_speakers))
    if n_speakers == 1:
        return np.zeros(n, dtype=np.int32), 1
    labels = kmeans(_row_unit(eigvecs[:, :n_speakers]), n_speakers)
    return labels.cpu().numpy().astype(np.int32), n_speakers


def eigengap_count(eigvals: torch.Tensor, max_speakers: int = 8) -> torch.Tensor:
    """Speaker count as the number of Laplacian eigenvalues below
    ``EIGVAL_TAU`` among the smallest ``max_speakers + 1``, clipped to
    [1, max_speakers]; a 0-d tensor on the eigenvalues' device."""
    k = min(max_speakers + 1, eigvals.shape[0])
    return torch.clamp((eigvals[:k] < EIGVAL_TAU).sum(), 1, max_speakers)


def cluster_stage(emb: torch.Tensor, max_speakers: int = 8,
                  use_subspace: bool = False) -> torch.Tensor:
    """Fixed-k clustering of (N, D) embeddings into ``max_speakers``
    groups, all on ``emb``'s device: cosine affinity → refinement →
    normalized Laplacian → the smallest ``max_speakers`` eigenvectors
    (dense ``torch.linalg.eigh``, or subspace iteration) → row-normalized
    → k-means.  Returns (N,) int64 labels on the same device.  The JAX
    package computes this stage in XLA, with no Pallas kernel."""
    lap = normalized_laplacian(refine_affinity(cosine_affinity(emb)))
    if use_subspace:
        spec = topk_eigvecs_subspace(lap, max_speakers)[1]
    else:
        spec = torch.linalg.eigh(lap)[1][:, :max_speakers]
    return kmeans(_row_unit(spec), max_speakers)


def bench_cluster_fn(max_speakers: int = 8, use_subspace: bool = False):
    """``cluster_stage`` with its options bound, for benchmark loops."""
    return functools.partial(cluster_stage, max_speakers=max_speakers,
                             use_subspace=use_subspace)
