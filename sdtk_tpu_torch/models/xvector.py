"""x-vector TDNN speaker embedder in PyTorch (inference and training).

The counterpart of ``sdtk_tpu/models/xvector.py`` (flax), with the same
module names, so the JAX package's checkpoints (the bundled
``models/xvector.msgpack``) load through
``utils.checkpoint.xvector_state_dict``.  Five frame-level TDNN blocks
with (kernel, dilation) (5, 1) (3, 2) (3, 3) (1, 1) (1, 1), the last one
``pre_pool_channels`` wide → masked mean/std pooling in float32 →
``segment6``, a dense layer run in float32 whatever the compute dtype,
as the JAX module sets it.  The blocks are ECAPA's ``TdnnBlock``, which
re-zeroes padded frames after every block as the JAX one does; under
``module.train()`` their BatchNorm takes batch statistics.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .ecapa import Dense, TdnnBlock, _masked_mean_std, random_init

# (kernel, dilation) of tdnn1 … tdnn5
_LAYERS = ((5, 1), (3, 2), (3, 3), (1, 1), (1, 1))


@dataclass(frozen=True)
class XVectorConfig:
    n_mels: int = 80
    channels: int = 512
    pre_pool_channels: int = 1500
    emb_dim: int = 512
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class XVector(nn.Module):
    """(B, T, n_mels) features + (B, T) mask → (B, emb_dim) f32."""

    def __init__(self, cfg: XVectorConfig = XVectorConfig()):
        super().__init__()
        self.cfg = cfg
        cin = cfg.n_mels
        for i, (k, d) in enumerate(_LAYERS):
            cout = cfg.pre_pool_channels if i == len(_LAYERS) - 1 else cfg.channels
            self.add_module(f"tdnn{i + 1}", TdnnBlock(cin, cout, k, d))
            cin = cout
        self.segment6 = Dense(2 * cfg.pre_pool_channels, cfg.emb_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        random_init(self, generator)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        b, t, _ = feats.shape
        if mask is None:
            mask = torch.ones((b, t), dtype=torch.bool, device=feats.device)
        m = mask[:, None, :].float()  # (B, 1, T)
        x = feats.to(dt).transpose(1, 2) * m.to(dt)
        for i in range(len(_LAYERS)):
            x = getattr(self, f"tdnn{i + 1}")(x, m, dt, mask)
        mean, std = _masked_mean_std(x, m)
        return self.segment6(torch.cat([mean, std], dim=1), torch.float32)
