"""Fused identify scoring: the CUDA kernel and its wrapper.

The port of the Pallas kernel
``sdtk_tpu/ops/research/topk_pallas.py:identify_topk_pallas``: cosine →
max over windows → top-k per tile of profile rows, with the (W, N) score
matrix never in device memory (``csrc/identify_topk.cu``; its header
holds the design and the bound).  The wrapper merges the tiles'
survivors, min(k, TILE) each, as the JAX wrapper merges with
``lax.top_k``.  Keeping the global k in every tile (the whole tile when
k >= TILE) makes the merge exact for any k, so the plain version is the
global top-k of :func:`~.topk.identify_topk_plain`.

On a CPU tensor :func:`identify_topk_fused` runs the plain version; on a
CUDA tensor it launches the kernel or raises, whatever k is (the JAX
kernel hands k > 128 to XLA; this one has no cap).
``identify_topk_fused.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import build
from .topk import identify_topk_plain, select_topk

TILE = 512  # profile rows per block (csrc/identify_topk.cu)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]


def identify_topk_cuda(queries: torch.Tensor, profiles: torch.Tensor, k: int = 64
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream and merge its survivors:
    same contract as :func:`~.topk.identify_topk_plain`, for CUDA tensors,
    queries of any float type (read as f32), profiles f32 or bf16."""
    if queries.device.type != "cuda" or profiles.device != queries.device:
        raise ValueError(f"expected CUDA tensors on one device, got {queries.device} "
                         f"and {profiles.device}")
    if queries.dim() != 2 or profiles.dim() != 2 or queries.shape[1] != profiles.shape[1]:
        raise ValueError(f"expected (W, D) and (N, D), got {tuple(queries.shape)} "
                         f"and {tuple(profiles.shape)}")
    if k < 1:
        raise ValueError(f"expected k >= 1, got {k}")
    if not queries.is_floating_point():
        raise ValueError(f"expected float queries, got {queries.dtype}")
    if profiles.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"profiles must be float32 or bfloat16, not {profiles.dtype}")
    q = queries.float().contiguous()
    p = profiles.contiguous()
    (w, d), n = q.shape, p.shape[0]
    if w == 0 or n == 0 or d == 0:
        raise ValueError(f"empty input: W={w}, N={n}, D={d}")
    blocks, kc = -(-n // TILE), min(k, TILE)
    cand_s = torch.empty((blocks, kc), dtype=torch.float32, device=q.device)
    cand_i = torch.empty((blocks, kc), dtype=torch.int32, device=q.device)
    build.launch("identify_topk", _ARGTYPES, q.data_ptr(), p.data_ptr(), cand_s.data_ptr(),
                 cand_i.data_ptr(), w, n, d, kc, int(p.dtype == torch.bfloat16),
                 torch.cuda.current_stream(q.device).cuda_stream)
    identify_topk_fused.launches += 1
    # Each tile is sorted (score desc, row asc) and tiles hold ascending
    # rows, so a stable sort of the survivors breaks ties by row.  Rows
    # past N sit at -inf behind the min(k, N) real rows taken.
    s, pos = select_topk(cand_s.reshape(-1), min(k, n))
    return s, cand_i.reshape(-1)[pos].long()


def identify_topk_fused(queries: torch.Tensor, profiles: torch.Tensor, k: int = 64
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(W, D) queries vs (N, D) profiles → top-k (scores, rows) by
    best-window cosine: the kernel on CUDA, the plain version on the CPU."""
    if queries.device.type == "cuda":
        return identify_topk_cuda(queries, profiles, k)
    if queries.device.type == "cpu":
        return identify_topk_plain(queries, profiles, k)
    raise ValueError(f"identify_topk_fused runs on cuda or cpu, not {queries.device}")


identify_topk_fused.launches = 0
