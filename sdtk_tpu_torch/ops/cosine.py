"""Batched cosine scoring: query embeddings vs the profile matrix.

The counterpart of ``sdtk_tpu/ops/cosine.py``.  :func:`cosine` is the
port of the Pallas kernel ``cosine_pallas``: (Q, D) × (N, D) → (Q, N)
float32 cosine with the rows normalized inside the kernel
(``csrc/cosine.cu``; its header holds the design and the bound).  On a
CPU tensor it runs :func:`cosine_plain`; on a CUDA tensor it launches the
kernel or raises.  ``cosine.launches`` counts kernel launches.

:func:`score_rows` keeps the JAX package's routes: small NumPy inputs
(Q·N·D < 2^24) score in NumPy, larger ones on the device through
:func:`cosine`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import build
from ..utils.device import resolve_device

NUMPY_MAX_WORK = 1 << 24  # Q·N·D below which NumPy scores small inputs

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _P]


def rsqrt_normalize(x: torch.Tensor) -> torch.Tensor:
    """Rows scaled by rsqrt(Σx² + 1e-24), in float32 (the TPU kernels' form)."""
    x = x.float()
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + 1e-24)


def cosine_plain(queries: torch.Tensor, profiles: torch.Tensor) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: (Q, N) float32 cosine of
    the rows normalized as rsqrt(Σx² + 1e-24)."""
    return rsqrt_normalize(queries) @ rsqrt_normalize(profiles).T


def cosine_cuda(queries: torch.Tensor, profiles: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream: same contract as
    :func:`cosine_plain`, for CUDA tensors (any float type, read as f32)."""
    if queries.device.type != "cuda" or profiles.device != queries.device:
        raise ValueError(f"expected CUDA tensors on one device, got {queries.device} "
                         f"and {profiles.device}")
    if queries.dim() != 2 or profiles.dim() != 2 or queries.shape[1] != profiles.shape[1]:
        raise ValueError(f"expected (Q, D) and (N, D), got {tuple(queries.shape)} "
                         f"and {tuple(profiles.shape)}")
    if not (queries.is_floating_point() and profiles.is_floating_point()):
        raise ValueError(f"expected float tensors, got {queries.dtype} and {profiles.dtype}")
    q = queries.float().contiguous()
    p = profiles.float().contiguous()
    (nq, d), n = q.shape, p.shape[0]
    out = torch.empty((nq, n), dtype=torch.float32, device=q.device)
    if nq == 0 or n == 0 or d == 0:
        return out.zero_()
    build.launch("cosine", _ARGTYPES, q.data_ptr(), p.data_ptr(), out.data_ptr(), nq, n, d,
                 torch.cuda.current_stream(q.device).cuda_stream)
    cosine.launches += 1
    return out


def cosine(queries: torch.Tensor, profiles: torch.Tensor) -> torch.Tensor:
    """(Q, D) × (N, D) → (Q, N) float32 cosine: the kernel on CUDA, the
    plain version on the CPU."""
    if queries.device.type == "cuda":
        return cosine_cuda(queries, profiles)
    if queries.device.type == "cpu":
        return cosine_plain(queries, profiles)
    raise ValueError(f"cosine runs on cuda or cpu, not {queries.device}")


cosine.launches = 0


def _on_device(x, device: torch.device) -> torch.Tensor:
    return (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))).to(device)


def score_rows(queries, profiles, device: str | torch.device | None = None) -> np.ndarray:
    """(Q, D) × (N, D) → (Q, N) cosine similarity as NumPy float32 (inputs
    need not be normalized).

    Small NumPy inputs score in NumPy: a device round trip costs more than
    the handful of FLOPs.  Above that, the scores come from :func:`cosine`
    on ``device`` (default CUDA), or on the tensors' own device."""
    if profiles.shape[0] == 0:
        return np.zeros((queries.shape[0], 0), dtype=np.float32)
    if (isinstance(queries, np.ndarray) and isinstance(profiles, np.ndarray)
            and queries.shape[0] * profiles.shape[0] * profiles.shape[1] < NUMPY_MAX_WORK):
        q = queries / np.maximum(np.linalg.norm(queries, axis=-1, keepdims=True), 1e-12)
        p = profiles / np.maximum(np.linalg.norm(profiles, axis=-1, keepdims=True), 1e-12)
        return (q @ p.T).astype(np.float32)
    if isinstance(queries, torch.Tensor):
        dev = queries.device
    else:
        dev = resolve_device(device)
    return cosine(_on_device(queries, dev), _on_device(profiles, dev)).cpu().numpy()


def asnorm(raw: np.ndarray, query_cohort: np.ndarray, profile_cohort: np.ndarray,
           top_k: int = 64) -> np.ndarray:
    """Adaptive symmetric score normalization (AS-norm), a NumPy copy of the
    JAX package's: each raw cosine is standardized against the top-K cohort
    scores of the query and of the profile, and the two z-scores averaged.

    raw: (Q, P); query_cohort: (Q, C); profile_cohort: (P, C) → (Q, P)."""
    k = min(top_k, query_cohort.shape[1])
    if k < 4:
        return raw

    def _stats(sims: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        top = np.partition(sims, -k, axis=1)[:, -k:]
        return top.mean(axis=1), np.maximum(top.std(axis=1), 1e-6)

    mu_q, sd_q = _stats(query_cohort)
    mu_p, sd_p = _stats(profile_cohort)
    zq = (raw - mu_q[:, None]) / sd_q[:, None]
    zp = (raw - mu_p[None, :]) / sd_p[None, :]
    return (0.5 * (zq + zp)).astype(np.float32)

