"""Large-N identification scoring: cosine → max over windows → top-k.

The counterpart of ``sdtk_tpu/ops/topk.py``.  :func:`identify_topk_plain`
is the plain PyTorch decomposition (the JAX package's
``identify_topk_xla``): a (W, N) score matrix, its max over windows, and
the top k.  :func:`identify_topk` is the host-facing dispatcher of the
identify path; it goes through the fused kernel (``ops/topk_fused.py``),
which launches on a CUDA tensor and runs the plain version on a CPU one.

Ties are broken as ``lax.top_k`` breaks them: the lower row first.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .cosine import rsqrt_normalize


def select_topk(m: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The min(k, len(m)) largest entries of ``m``, descending, lower index
    first among equal scores; indices as int64."""
    s, order = torch.sort(m, descending=True, stable=True)
    k = min(k, m.shape[0])
    return s[:k], order[:k]


def identify_topk_plain(queries: torch.Tensor, profiles: torch.Tensor, k: int = 64,
                        assume_normalized: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(W, D) queries vs (N, D) profiles → top-k (scores, rows) by
    best-window cosine, through the full (W, N) matrix.
    ``assume_normalized`` skips normalizing the profiles."""
    p = profiles.float() if assume_normalized else rsqrt_normalize(profiles)
    return select_topk((rsqrt_normalize(queries) @ p.T).amax(dim=0), k)


def bucket_windows(queries: torch.Tensor) -> torch.Tensor:
    """(W, D) → (W_b, D), W_b the next power of two (at least 8), by
    repeating the first row, as the JAX dispatcher buckets; the max over
    windows does not change."""
    w = queries.shape[0]
    w_b = max(8, 1 << (w - 1).bit_length())
    return queries if w_b == w else torch.cat([queries, queries[:1].expand(w_b - w, -1)])


def identify_topk(queries, profiles, k: int = 64, device: str | torch.device | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Host-facing dispatcher: (W, D) query windows vs the (N, D) profile
    matrix → top-k (scores, profile rows) as NumPy.  Runs on ``device``
    (default CUDA) or on the profiles' device when they are a tensor.
    The windows are bucketed by :func:`bucket_windows`."""
    from .topk_fused import identify_topk_fused  # imports this module

    dev = profiles.device if isinstance(profiles, torch.Tensor) else resolve_device(device)
    q = torch.from_numpy(np.asarray(queries, np.float32)).to(dev)
    p = (profiles if isinstance(profiles, torch.Tensor) else torch.from_numpy(np.asarray(profiles))
         ).to(dev)
    s, i = identify_topk_fused(bucket_windows(q), p, k)
    return s.cpu().numpy(), i.cpu().numpy()
