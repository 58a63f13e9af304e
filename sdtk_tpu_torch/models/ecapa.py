"""ECAPA-TDNN speaker embedder in PyTorch (inference).

The counterpart of ``sdtk_tpu/models/ecapa.py`` (flax), with the same
module names, so the JAX package's checkpoints load through
``utils.checkpoint.ecapa_state_dict``.  The tower's public call keeps the
JAX layout — (B, T, n_mels) features and a (B, T) mask in, (B, emb_dim)
out — and runs channels-first (B, C, T) inside, which is what
``torch.nn.functional.conv1d`` takes.

Numerics follow the JAX module: convolutions and dense layers in the
compute dtype (bf16 by default), BatchNorm (ε = 1e-5) and every masked
statistic in float32, then cast back.  Padded frames are re-zeroed after
every TdnnBlock and every Res2 branch, SE pools with a masked mean,
attentive pooling masks its logits with −1e9 before an f32 softmax, so
rows with no valid frame stay finite.  Parameters are held in float32 and
cast to the compute dtype where they are used.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class EcapaConfig:
    n_mels: int = 80
    channels: int = 512
    emb_dim: int = 192
    scale: int = 8  # Res2Net scale
    se_bottleneck: int = 128
    attention_channels: int = 128
    mfa_channels: int = 1536
    dilations: tuple[int, ...] = (2, 3, 4)
    dtype: str = "bfloat16"
    mfa_bn: bool = False    # SpeechBrain layout: BN after the MFA conv+relu
    asp_tdnn: bool = False  # SpeechBrain layout: conv→relu→BN→tanh→conv attention

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class Conv(nn.Module):
    """Conv1d with flax ``padding="SAME"`` (odd kernels: d·(k−1)/2 on each
    side), run in the compute dtype ``dt``."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, dilation: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dilation = dilation
        self.pad = dilation * (kernel - 1) // 2

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        return F.conv1d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        padding=self.pad, dilation=self.dilation)


class Dense(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class BatchNorm(nn.Module):
    """Inference BatchNorm over dim 1 in float32 (flax: ε = 1e-5)."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x.float(), self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def _masked_mean_std(x: torch.Tensor, m: torch.Tensor, eps: float = 1e-5
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, C, T) and a (B, 1, T) float mask → f32 mean/std over time."""
    xf = x.float() * m
    denom = torch.clamp(m.sum(dim=2), min=1.0)
    mean = xf.sum(dim=2) / denom
    var = (xf * xf).sum(dim=2) / denom - mean * mean
    return mean, torch.sqrt(torch.clamp(var, min=eps))


def random_init(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``: N(0, 1/fan_in) kernels, zero
    biases, identity BatchNorm (for runs without a checkpoint)."""
    for mod in model.modules():
        if isinstance(mod, (Conv, Dense)):
            w = mod.weight
            with torch.no_grad():
                w.copy_(torch.randn(w.shape, generator=generator) / w[0].numel() ** 0.5)
                mod.bias.zero_()


class TdnnBlock(nn.Module):
    """Conv1d(k, dilation) → ReLU → BatchNorm (f32) → mask."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, dilation: int = 1):
        super().__init__()
        self.conv = Conv(cin, cout, kernel, dilation)
        self.bn = BatchNorm(cout)

    def forward(self, x, m, dt):
        x = self.bn(torch.relu(self.conv(x, dt))).to(dt)
        return x * m.to(dt)


class Res2Conv(nn.Module):
    """Res2Net multi-scale conv: split 0 passes through; split i (≥1) is
    convolved (``conv{i}``/``bn{i}``) after adding split i−1's output."""

    def __init__(self, channels: int, kernel: int = 3, dilation: int = 1, scale: int = 8):
        super().__init__()
        assert channels % scale == 0
        self.scale = scale
        width = channels // scale
        for i in range(1, scale):
            self.add_module(f"conv{i}", Conv(width, width, kernel, dilation))
            self.add_module(f"bn{i}", BatchNorm(width))

    def forward(self, x, m, dt):
        xs = torch.chunk(x, self.scale, dim=1)
        outs = [xs[0]]
        prev = None
        for i in range(1, self.scale):
            inp = xs[i] if prev is None else xs[i] + prev
            prev = getattr(self, f"conv{i}")(inp, dt)
            prev = getattr(self, f"bn{i}")(torch.relu(prev)).to(dt) * m.to(dt)
            outs.append(prev)
        return torch.cat(outs, dim=1)


class SEBlock(nn.Module):
    """Squeeze-excitation with a masked f32 mean over time."""

    def __init__(self, channels: int, bottleneck: int = 128):
        super().__init__()
        self.fc1 = Dense(channels, bottleneck)
        self.fc2 = Dense(bottleneck, channels)

    def forward(self, x, m, dt):
        denom = torch.clamp(m.sum(dim=2), min=1.0)
        s = (x.float() * m).sum(dim=2) / denom  # (B, C)
        s = torch.relu(self.fc1(s, dt))
        s = torch.sigmoid(self.fc2(s, dt))
        return x * s[:, :, None]


class SERes2Block(nn.Module):
    """1×1 TDNN → Res2 conv → 1×1 TDNN → SE, with a residual connection."""

    def __init__(self, channels, kernel=3, dilation=1, scale=8, se_bottleneck=128):
        super().__init__()
        self.tdnn_in = TdnnBlock(channels, channels, 1, 1)
        self.res2 = Res2Conv(channels, kernel, dilation, scale)
        self.tdnn_out = TdnnBlock(channels, channels, 1, 1)
        self.se = SEBlock(channels, se_bottleneck)

    def forward(self, x, m, dt):
        residual = x
        x = self.tdnn_in(x, m, dt)
        x = self.res2(x, m, dt)
        x = self.tdnn_out(x, m, dt)
        x = self.se(x, m, dt)
        return x + residual


class AttentiveStatsPooling(nn.Module):
    """Channel- and context-dependent attentive statistics pooling:
    attention sees [h_t, global mean, global std]; returns (B, 2C) f32."""

    def __init__(self, channels: int, attention_channels: int = 128, tdnn_attention=False):
        super().__init__()
        self.att1 = Conv(3 * channels, attention_channels)
        if tdnn_attention:
            self.att_bn = BatchNorm(attention_channels)
        self.att2 = Conv(attention_channels, channels)
        self.tdnn_attention = tdnn_attention

    def forward(self, x, mask, dt):
        m = mask[:, None, :].float()
        mean, std = _masked_mean_std(x, m)
        t = x.shape[2]
        ctx = torch.cat([x, mean[:, :, None].expand(-1, -1, t).to(x.dtype),
                         std[:, :, None].expand(-1, -1, t).to(x.dtype)], dim=1)
        a = self.att1(ctx, dt)
        if self.tdnn_attention:
            a = self.att_bn(torch.relu(a)).to(dt)
        a = self.att2(torch.tanh(a), dt).float()
        a = a.masked_fill(~mask[:, None, :], -1e9)
        w = torch.softmax(a, dim=2)  # per-channel attention over time
        xf = x.float()
        mu = (w * xf).sum(dim=2)
        var = (w * xf * xf).sum(dim=2) - mu * mu
        return torch.cat([mu, torch.sqrt(torch.clamp(var, min=1e-5))], dim=1)


class EcapaTdnn(nn.Module):
    """(B, T, n_mels) features + (B, T) mask → (B, emb_dim) f32."""

    def __init__(self, cfg: EcapaConfig = EcapaConfig()):
        super().__init__()
        self.cfg = cfg
        c = cfg.channels
        self.stem = TdnnBlock(cfg.n_mels, c, 5, 1)
        for i, dil in enumerate(cfg.dilations):
            self.add_module(f"block{i + 1}",
                            SERes2Block(c, 3, dil, cfg.scale, cfg.se_bottleneck))
        self.mfa = Conv(c * len(cfg.dilations), cfg.mfa_channels)
        if cfg.mfa_bn:
            self.mfa_bn = BatchNorm(cfg.mfa_channels)
        self.asp = AttentiveStatsPooling(cfg.mfa_channels, cfg.attention_channels,
                                         tdnn_attention=cfg.asp_tdnn)
        self.asp_bn = BatchNorm(2 * cfg.mfa_channels)
        self.embedding = Dense(2 * cfg.mfa_channels, cfg.emb_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        random_init(self, generator)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.compute_dtype
        b, t, _ = feats.shape
        if mask is None:
            mask = torch.ones((b, t), dtype=torch.bool, device=feats.device)
        m = mask[:, None, :].float()  # (B, 1, T)
        x = feats.to(dt).transpose(1, 2) * m.to(dt)

        x = self.stem(x, m, dt)
        block_outs = []
        for i in range(len(cfg.dilations)):
            x = getattr(self, f"block{i + 1}")(x, m, dt)
            block_outs.append(x)

        x = torch.relu(self.mfa(torch.cat(block_outs, dim=1), dt))
        if cfg.mfa_bn:
            x = self.mfa_bn(x).to(dt)
        x = x * m.to(x.dtype)

        pooled = self.asp_bn(self.asp(x, mask, dt))
        return self.embedding(pooled, torch.float32)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=eps)
