"""Affinity-matrix construction and refinement on the device.

The counterpart of ``sdtk_tpu/cluster/affinity.py``: cosine affinity of
window embeddings mapped to [0, 1], then zero diagonal → soft per-row
top-k threshold → symmetrize → self-affinity restored as the row max.
"""

from __future__ import annotations

import torch


def cosine_affinity(emb: torch.Tensor) -> torch.Tensor:
    """(N, D) embeddings → (N, N) cosine affinity in [0, 1]."""
    e = emb / torch.clamp(torch.linalg.norm(emb, dim=-1, keepdim=True), min=1e-12)
    return (1.0 + e @ e.T) * 0.5


def refine_affinity(aff: torch.Tensor, p_percentile: float = 0.95) -> torch.Tensor:
    """Zero diagonal → keep the top (1-p) fraction per row (≥ 3 neighbours)
    and scale the rest by 0.01 → symmetrize → diagonal = row max."""
    n = aff.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=aff.device)
    a = aff.masked_fill(eye, 0.0)
    k = min(n - 1, max(3, int(round((1.0 - p_percentile) * n))))
    kth = torch.topk(a, k, dim=1).values[:, -1:]
    a = torch.where(a >= kth, a, a * 0.01)
    a = torch.maximum(a, a.T)
    return torch.where(eye, a.max(dim=1, keepdim=True).values, a)
