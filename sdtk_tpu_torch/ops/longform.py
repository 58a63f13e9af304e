"""Sequence parallelism for hour-scale recordings over a process group.

The port of ``sdtk_tpu/ops/longform.py``.  The JAX package shards the
time axis over a ``data`` mesh with ``shard_map``; here each rank of a
``torch.distributed`` group (``parallel/multihost.py``) holds one
contiguous chunk, and the collectives are ``all_gather`` and
``all_reduce``.  Without a group, both functions run as one rank of one.

- :func:`sharded_log_mel`: each rank owns ``n / world`` contiguous
  samples.  Its frames that straddle the right boundary need the first
  ``win - hop`` samples of the right neighbour, and preemphasis needs the
  last sample of the left neighbour; one small ``all_gather`` of every
  rank's head and last sample brings both (no send/receive pairs, which
  deadlock easily, and the same code on NCCL and gloo).  The extended
  chunk is preemphasized and its ``n_local / hop`` frames go through the
  waveform→log-mel kernel (K1, ``ops/fbank_wave.py``) with coefficient 0
  on a CUDA tensor, through its plain version on a CPU one.  CMN is
  global over valid frames (an ``all_reduce`` of the sum and the count).
  Frames are those of the one-device frontend on the same padded signal;
  CMN differs only by the order of its float32 sums.
- :func:`sharded_affinity_rows`: each rank builds its row block of the
  refined affinity against the all-gathered embeddings, as the JAX
  package does.  The JAX package then lets GSPMD shard the transpose and
  the eigensolve; here every rank gathers the row blocks and holds the
  whole matrix (N² float32 over the kept windows: about a quarter of a
  GB for an hour at the CLI's 0.375 s hop), and the caller solves it on
  every rank.

Both return the whole result on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.multihost import all_gather_rows, all_reduce_sum, rank_and_world
from .fbank import FrontendConfig
from .fbank_wave import raw_log_mel_wave


def pad_for_sharding(x: np.ndarray, world: int, cfg: FrontendConfig = FrontendConfig()
                     ) -> np.ndarray:
    """Zero-pad a 1-D signal to a multiple of ``world · hop`` samples."""
    q = world * cfg.hop_length
    pad = (-len(x)) % q
    return np.pad(x, (0, pad)) if pad else x


def halo_chunk(x_local: torch.Tensor, cfg: FrontendConfig = FrontendConfig()) -> torch.Tensor:
    """The waveform→log-mel kernel's input on this rank: its chunk with the
    right neighbour's first ``win - hop`` samples appended (zeros on the
    last rank), preemphasized with the left neighbour's last sample as
    context (zero on the first rank); (n_local + win - hop,) float32."""
    rank, world = rank_and_world()
    x_local = x_local.reshape(-1).float()
    n_local = x_local.shape[0]
    hop, win = cfg.hop_length, cfg.win_length
    halo = win - hop
    if n_local % hop or n_local < halo:
        raise ValueError(f"chunk of {n_local} samples: pad the signal to world·hop "
                         f"({world}·{hop}) with at least {halo} samples a rank")
    # every rank's head (the right context of its left neighbour) and last
    # sample (the preemphasis context of its right neighbour), zero at the ends
    edges = all_gather_rows(torch.cat([x_local[:halo], x_local[-1:]])[None])
    zero = x_local.new_zeros(halo + 1)
    right_head = (edges[rank + 1] if rank < world - 1 else zero)[:halo]
    left_last = (edges[rank - 1] if rank > 0 else zero)[halo:]
    ext = torch.cat([left_last, x_local, right_head])
    return ext[1:] - cfg.preemphasis * ext[:-1]


def sharded_log_mel(x_local: torch.Tensor, cfg: FrontendConfig = FrontendConfig()
                    ) -> torch.Tensor:
    """Time-sharded log-mel of one long mono waveform.

    Args:
        x_local: (n_local,) float32, this rank's contiguous chunk of a
            signal of ``n = n_local · world`` samples (pad with
            :func:`pad_for_sharding` first); ``n_local`` a multiple of
            ``hop`` and at least ``win - hop``.
    Returns:
        (T, n_mels) float32 on every rank, ``T = cfg.num_frames(n)``: the
        trailing frames whose windows run past the signal's end are
        dropped, as the JAX package drops them.

    Frames sit at ``center=False`` positions and the features honour
    ``log_scale`` and ``mel_fmin`` (the JAX function takes natural log and
    the default band whatever the config says; the two agree on the
    default config).  ``center=True`` raises: the JAX function frames such
    a config at ``center=False`` positions without saying so.
    """
    if cfg.center:
        raise NotImplementedError("long-form framing is center=False; this frontend config "
                                  "asks for center=True")
    rank, world = rank_and_world()
    n_local = x_local.numel()
    t_exact = cfg.num_frames(n_local * world)
    # (n_local / hop, n_mels): the kernel with coefficient 0 on the preemphasized chunk
    feats = raw_log_mel_wave(halo_chunk(x_local, cfg)[None], cfg, 0.0)[0]
    if cfg.mean_norm:
        n_frames_local = feats.shape[0]
        first = rank * n_frames_local
        valid = (torch.arange(first, first + n_frames_local, device=feats.device)
                 < t_exact)[:, None].float()
        stats = all_reduce_sum(torch.cat([(feats * valid).sum(dim=0), valid.sum()[None]]))
        feats = feats - stats[:-1] / stats[-1]
    return all_gather_rows(feats)[:t_exact]


def _normalize_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)


def sharded_affinity_rows(emb_local: torch.Tensor, p_percentile: float = 0.95) -> torch.Tensor:
    """Refined cosine affinity from row blocks: this rank's rows
    (``emb_local``, N / world of them, in rank order) against the
    all-gathered (N, D) matrix, mapped to [0, 1], the global diagonal
    zeroed, each row thresholded at its k-th largest value (the rule of
    ``cluster/affinity.py:refine_affinity``), then every block gathered,
    symmetrized, and the self-affinity set to the row maximum.  Returns the
    (N, N) float32 matrix on every rank."""
    rank, _ = rank_and_world()
    full = all_gather_rows(emb_local)
    n = full.shape[0]
    e_full = _normalize_rows(full.float())
    e_loc = _normalize_rows(emb_local.float())
    rows = (1.0 + e_loc @ e_full.T) * 0.5  # (N / world, N); a plain product in JAX too
    n_local = rows.shape[0]
    own = torch.arange(rank * n_local, (rank + 1) * n_local, device=rows.device)
    rows = rows.masked_fill(torch.arange(n, device=rows.device)[None, :] == own[:, None], 0.0)
    k = min(n - 1, max(3, int(round((1.0 - p_percentile) * n))))
    kth = torch.topk(rows, k, dim=1).values[:, -1:]
    rows = torch.where(rows >= kth, rows, rows * 0.01)
    a = all_gather_rows(rows)
    a = torch.maximum(a, a.T)
    eye = torch.eye(n, dtype=torch.bool, device=a.device)
    return torch.where(eye, a.max(dim=1, keepdim=True).values, a)
