"""ECAPA-TDNN speaker embedder in PyTorch (inference and training).

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
cast to the compute dtype where they are used, so autograd returns float32
gradients.  Under ``module.train()`` BatchNorm normalizes with batch
statistics as flax's ``nn.BatchNorm(use_running_average=False)`` does.
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
    side), run in the compute dtype ``dt``; ``groups`` is flax's
    ``feature_group_count``."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, dilation: int = 1,
                 groups: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dilation = dilation
        self.groups = groups
        self.pad = dilation * (kernel - 1) // 2

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        return F.conv1d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        padding=self.pad, dilation=self.dilation, groups=self.groups)


class Dense(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 in float32, as flax 0.12's ``nn.BatchNorm``
    (ε = 1e-5, momentum 0.99, ``use_fast_variance``).

    In eval mode it normalizes with the running statistics.  In train mode
    it takes the batch mean and the *biased* variance E[x²] − E[x]² over
    every axis but the channels (padded frames included, as the JAX tower
    does), normalizes with them, and moves the running statistics by
    r ← 0.99·r + 0.01·batch.  ``F.batch_norm(training=True)`` would update
    with momentum 0.1 and the unbiased variance instead.

    With ``sync`` set (``parallel/train.py:sync_batchnorm``) and more than
    one rank in the process group, the batch is the global one, as GSPMD
    makes it for the JAX step over a ``data`` mesh: Σx, Σx² and the count are
    summed over the ranks in float32 by an all-reduce that autograd
    differentiates, so the backward is the global batch's too."""

    momentum = 0.99

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eps = eps
        self.sync = False  # statistics over the process group's ranks

    def _global_moments(self, x: torch.Tensor, dims: list[int]
                        ) -> tuple[torch.Tensor, torch.Tensor] | None:
        """(E[x], E[x²]) over every rank's batch, or None to use this
        rank's alone (no sync, no group, or a group of one)."""
        import torch.distributed as dist

        if not self.sync or not dist.is_initialized() or dist.get_world_size() == 1:
            return None
        from torch.distributed.nn.functional import all_reduce

        count = x.new_full((1,), float(x.numel() // x.shape[1]))
        sums = all_reduce(torch.cat([x.sum(dims), (x * x).sum(dims), count]))
        c = x.shape[1]
        return sums[:c] / sums[-1], sums[c : 2 * c] / sums[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dims = [0, *range(2, x.dim())]
        moments = self._global_moments(x, dims)
        if moments is None:
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
        else:
            mean, sq = moments
            var = torch.clamp(sq - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


def _masked_mean_std(x: torch.Tensor, m: torch.Tensor, eps: float = 1e-5
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, C, T) and a (B, 1, T) float mask → f32 mean/std over time."""
    xf = x.float() * m
    denom = torch.clamp(m.sum(dim=2), min=1.0)
    mean = xf.sum(dim=2) / denom
    var = (xf * xf).sum(dim=2) / denom - mean * mean
    return mean, torch.sqrt(torch.clamp(var, min=eps))


# standard deviation of a unit normal truncated to (-2, 2)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_init_(mod: nn.Module, generator: torch.Generator) -> None:
    """flax's default law for a conv or Dense module, in place: the kernel
    from ``lecun_normal`` (a unit normal truncated to (−2, 2), scaled to
    variance 1/fan_in), a zero bias."""
    w = mod.weight
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    w.mul_(1.0 / (w[0].numel() ** 0.5 * _TRUNC_STD))
    mod.bias.zero_()


def random_init(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator`` with flax's default law
    (:func:`lecun_init_` for every conv and Dense), identity BatchNorm."""
    for mod in model.modules():
        if isinstance(mod, (Conv, Dense)):
            lecun_init_(mod, generator)


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
