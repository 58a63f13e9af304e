"""Fused identify scoring: the CUDA kernel and its wrapper.

The port of the Pallas kernel
``sdtk_tpu/ops/research/topk_pallas.py:identify_topk_pallas``: cosine →
max over windows → top-k per tile of profile rows, with the (W, N) score
matrix never in device memory (``csrc/identify_topk.cu``; its header
holds the design and the bound).  After a small kernel that normalizes
the queries and splits them for 3xTF32, the kernel runs in two passes: the
window max m (N,) of every profile row, then the top min(k, TILE) of each
TILE-row tile of m.  The wrapper merges the tiles' survivors, as the JAX
wrapper merges with ``lax.top_k``.  Keeping the global k in every tile
(the whole tile when k >= TILE) makes the merge exact for any k, so the
plain version is the global top-k of :func:`~.topk.identify_topk_plain`;
:func:`identify_topk_tiles_plain` spells out the two passes and the merge
in plain PyTorch, for the tests.

On a CPU tensor :func:`identify_topk_fused` runs the plain version; on a
CUDA tensor it launches the kernel or raises, whatever k is (the JAX
kernel hands k > 128 to XLA; this one has no cap).
``identify_topk_fused.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import build
from ..utils.profiling import launched
from .cosine import rsqrt_normalize
from .topk import identify_topk_plain, select_topk

TILE = 512  # profile rows per tile of the selection pass (csrc/identify_topk.cu)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]


def window_max_plain(queries: torch.Tensor, profiles: torch.Tensor) -> torch.Tensor:
    """Pass A in plain PyTorch: m_j = inv_p_j · max_w(qn_w · p_j), (N,)
    float32, the profile's inverse norm applied after the window max."""
    p = profiles.float()
    inv_p = torch.rsqrt((p * p).sum(dim=1) + 1e-24)
    return (rsqrt_normalize(queries) @ p.T).amax(dim=0) * inv_p


def tile_select_plain(m: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass B in plain PyTorch: the top min(k, TILE) of each TILE-row tile
    of ``m`` (rows past N at -inf), score descending, lower row first, as
    (tiles, kc) scores and int64 rows."""
    n, kc = m.shape[0], min(k, TILE)
    tiles = -(-n // TILE)
    padded = torch.full((tiles * TILE,), float("-inf"), dtype=m.dtype, device=m.device)
    padded[:n] = m
    s, order = torch.sort(padded.view(tiles, TILE), dim=1, descending=True, stable=True)
    rows = order[:, :kc] + TILE * torch.arange(tiles, device=m.device)[:, None]
    return s[:, :kc], rows


def identify_topk_tiles_plain(queries: torch.Tensor, profiles: torch.Tensor, k: int = 64
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's algorithm in plain PyTorch: pass A, pass B, then the
    wrapper's merge of the survivors."""
    s, rows = tile_select_plain(window_max_plain(queries, profiles), k)
    top, pos = select_topk(s.reshape(-1), min(k, profiles.shape[0]))
    return top, rows.reshape(-1)[pos]


def identify_topk_cuda(queries: torch.Tensor, profiles: torch.Tensor, k: int = 64
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel's two passes on the current stream and merge the
    survivors: same contract as :func:`~.topk.identify_topk_plain`, for CUDA tensors,
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
    tiles, kc = -(-n // TILE), min(k, TILE)
    # One scratch buffer, carved into the queries normalized and split for
    # 3xTF32 (rows padded to a multiple of 4; first, so 16-byte aligned),
    # pass B's survivor rows (int64) and scores, and pass A's window maxima.
    nq, nc = 2 * w * (-(-d // 4) * 4), tiles * kc
    scratch = torch.empty(nq + 3 * nc + n, dtype=torch.float32, device=q.device)
    cand_i = scratch[nq:nq + 2 * nc].view(torch.int64)
    cand_s = scratch[nq + 2 * nc:nq + 3 * nc]
    base = scratch.data_ptr()
    build.launch("identify_topk", _ARGTYPES, q.data_ptr(), p.data_ptr(), base,
                 base + 4 * (nq + 3 * nc), cand_s.data_ptr(), cand_i.data_ptr(), w, n, d, kc,
                 int(p.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream)
    launched(identify_topk_fused)
    # Each tile is sorted (score desc, row asc) and tiles hold ascending
    # rows, so a stable sort of the survivors breaks ties by row.  Rows
    # past N sit at -inf behind the min(k, N) real rows taken.
    s, pos = select_topk(cand_s, min(k, n))
    return s, cand_i[pos]


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
