"""Conformer speaker embedder in PyTorch (inference and training).

The counterpart of ``sdtk_tpu/models/conformer.py`` (flax), with the same
module names, so the JAX package's variables load through
``utils.checkpoint.conformer_state_dict``.  Conformer blocks (feed-forward
½ → multi-head self-attention → depthwise conv module → feed-forward ½,
pre-norm, a final LayerNorm) over log-mel frames, then ECAPA's masked
attentive-statistics pooling and a float32 dense projection.  The public
call keeps the JAX layout: (B, T, n_mels) features and a (B, T) mask in,
(B, emb_dim) float32 out.  Blocks run on (B, T, C); the conv module turns
to (B, C, T) for ``conv1d`` and BatchNorm.

Numerics follow flax 0.12:

- LayerNorm (ε = 1e-6) in float32 with the variance as E[x²] − E[x]²,
  cast to the compute dtype after;
- attention in the compute dtype: q scaled by 1/√Dh, a masked logit set
  to the dtype's lowest finite value (so a padded query row, every key
  masked, gets a uniform, finite softmax), the softmax cast back to the
  compute dtype; the attention output is not masked;
- the conv module zeroes padded frames after its GLU and after its last
  dense layer; its BatchNorm (ε = 1e-5, momentum 0.99) takes, in train
  mode, statistics over every (B, T) position, padded ones included;
- each block zeroes padded frames at its end.

Parameters are held in float32 and cast where they are used, as in
``models/ecapa.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .ecapa import AttentiveStatsPooling, BatchNorm, Conv, Dense, random_init
from .vad import LayerNorm


@dataclass(frozen=True)
class ConformerConfig:
    n_mels: int = 80
    dim: int = 256
    n_blocks: int = 6
    n_heads: int = 4
    ff_mult: int = 4
    conv_kernel: int = 15
    emb_dim: int = 192
    attention_channels: int = 128
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _norm(ln: LayerNorm, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=float32)(x).astype(dt)``."""
    return ln(x.float()).to(dt)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim)
        self.Dense_0 = Dense(dim, dim * mult)
        self.Dense_1 = Dense(dim * mult, dim)

    def forward(self, x, dt):
        h = self.Dense_0(_norm(self.LayerNorm_0, x, dt), dt)
        return self.Dense_1(F.silu(h), dt)


class Attention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (self-attention): the
    (C, H, Dh) projection kernels held flat as (H·Dh, C), the (H, Dh, C)
    output kernel as (C, H·Dh)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        for name in ("query", "key", "value"):
            self.add_module(name, Dense(dim, dim))
        self.out = Dense(dim, dim)

    def forward(self, h, mask, dt):
        b, t, c = h.shape
        split = (b, t, self.heads, c // self.heads)
        q = self.query(h, dt).view(split)
        k = self.key(h, dt).view(split)
        v = self.value(h, dt).view(split)
        q = q / torch.tensor(float(split[-1])).sqrt().to(dt)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        pair = (mask[:, None, :, None] & mask[:, None, None, :])
        logits = logits.masked_fill(~pair, torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, dim=-1).to(dt)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t, c)
        return self.out(o, dt)


class MHSA(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim)
        self.MultiHeadDotProductAttention_0 = Attention(dim, heads)

    def forward(self, x, mask, dt):
        return self.MultiHeadDotProductAttention_0(_norm(self.LayerNorm_0, x, dt), mask, dt)


class ConvModule(nn.Module):
    """Pointwise GLU → depthwise conv (flax ``padding="SAME"``) →
    BatchNorm (f32) → swish → pointwise, masked."""

    def __init__(self, dim: int, kernel: int):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim)
        self.Dense_0 = Dense(dim, 2 * dim)
        self.depthwise = Conv(dim, dim, kernel, groups=dim)
        self.BatchNorm_0 = BatchNorm(dim)
        self.Dense_1 = Dense(dim, dim)

    def forward(self, x, mask, dt):
        m = mask[..., None].to(dt)
        a, g = self.Dense_0(_norm(self.LayerNorm_0, x, dt), dt).chunk(2, dim=-1)
        h = a * torch.sigmoid(g) * m  # GLU, no leakage into padding
        h = self.BatchNorm_0(self.depthwise(h.transpose(1, 2), dt))
        h = F.silu(h.to(dt)).transpose(1, 2)
        return self.Dense_1(h, dt) * m


class ConformerBlock(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.ff1 = FeedForward(cfg.dim, cfg.ff_mult)
        self.mhsa = MHSA(cfg.dim, cfg.n_heads)
        self.conv = ConvModule(cfg.dim, cfg.conv_kernel)
        self.ff2 = FeedForward(cfg.dim, cfg.ff_mult)
        self.final_norm = LayerNorm(cfg.dim)

    def forward(self, x, mask, dt):
        x = x + 0.5 * self.ff1(x, dt)
        x = x + self.mhsa(x, mask, dt)
        x = x + self.conv(x, mask, dt)
        x = x + 0.5 * self.ff2(x, dt)
        return _norm(self.final_norm, x, dt) * mask[..., None].to(dt)


class Conformer(nn.Module):
    """(B, T, n_mels) log-mel + (B, T) mask → (B, emb_dim) f32."""

    def __init__(self, cfg: ConformerConfig = ConformerConfig()):
        super().__init__()
        self.cfg = cfg
        self.input_proj = Dense(cfg.n_mels, cfg.dim)
        for i in range(cfg.n_blocks):
            self.add_module(f"block{i}", ConformerBlock(cfg))
        self.asp = AttentiveStatsPooling(cfg.dim, cfg.attention_channels)
        self.embedding = Dense(2 * cfg.dim, cfg.emb_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's default law: ``lecun_normal`` kernels (fan-in C for the
        q/k/v projections, H·Dh for the output, K for the depthwise conv)
        and zero biases."""
        random_init(self, generator)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.compute_dtype
        b, t, _ = feats.shape
        if mask is None:
            mask = torch.ones((b, t), dtype=torch.bool, device=feats.device)
        x = self.input_proj(feats, dt) * mask[..., None].to(dt)
        for i in range(cfg.n_blocks):
            x = getattr(self, f"block{i}")(x, mask, dt)
        pooled = self.asp(x.transpose(1, 2), mask, dt)
        return self.embedding(pooled, torch.float32)
