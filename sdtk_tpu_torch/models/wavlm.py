"""WavLM Large + ECAPA-TDNN: UniSpeech's speaker-verification model, in PyTorch
(inference).

WavLM (Chen et al., "WavLM: Large-Scale Self-Supervised Pre-Training for Full
Stack Speech Processing", arXiv:2110.13900) at the widths of
``huggingface.co/microsoft/wavlm-large``'s ``config.json``, under the head of
``github.com/microsoft/UniSpeech/tree/main/downstreams/speaker_verification``
(``ECAPA_TDNN_SMALL``).  Raw 16 kHz samples in, no log-mel:

1. each clip layer-normalized (no affine, ε 1e-5) over its own valid samples,
   the tail zeroed (WavLM Large's ``normalize: true``);
2. seven convolutions of 512 channels, kernels (10, 3, 3, 3, 3, 2, 2), strides
   (5, 2, 2, 2, 2, 2, 2), no bias, each followed by a LayerNorm over the
   channels (affine) and GELU: 320× down to 50 frames/s; frame lengths follow
   the same formula, ⌊(L − k) / s⌋ + 1 a layer;
3. LayerNorm(512) → Linear 512 → 1 024; padded frames zeroed;
4. plus GELU(conv(x)), the convolutional position embedding (1 024 → 1 024,
   kernel 128, padding 64, 16 groups, its last frame dropped);
5. 24 pre-LN layers: ``x += Attn(LN₁(x))``, ``x += W₂·GELU(W₁·LN₂(x))``,
   with scores ``qᵢ·kⱼ/8 + gₕ,ᵢ·r[h, bucket(j − i)]``: the (320, 16) table
   ``r`` is held in layer 0 and shared by all; each layer's gate is
   ``a·(b·cₕ − 1) + 2`` with (a, b) the sigmoids of the two 4-sums of
   ``Linear(64 → 8)`` over each 64-wide head of LN₁(x) (:func:`gates`);
   buckets as :func:`relative_buckets`;
6. the 25 states (the encoder's input after step 4, then every layer's
   output, none through the final LayerNorm) weighted by the softmax of 25
   scalars and summed, an instance norm over time per channel (no affine,
   ε 1e-5), then ``models/ecapa.py``'s tower in UniSpeech's layout
   (``global_context=False``, ``dense_blocks=True``).

Departures from the sources, each also listed in the benchmark's
configuration: masks for ragged clips (a clip's valid frames come from the
CNN's length formula where WavLM pads by 320-sample blocks; padded keys are
masked with −1e9 in the scores; the instance norm, the head's SE means and
its pooling count valid frames alone), the position convolution's weight
norm folded into the stored weight, and the port's Res2 split order (split 0
passes, UniSpeech passes its last; one rotation of the block's channels
maps one onto the other).

Numerics on the serving route (the card, bf16, autograd off): products and
the attention in bf16, reading bf16 copies of the weights made once (the
dense layers are ECAPA's ``Dense``, which ``ecapa.prepare_serving`` covers;
the convolutions and norms keep theirs the same way; each copy is rebuilt
when its parameter moves); the
residual stream, every norm's statistics, the gates, the states' weighted
sum and the instance norm in float32.  Attention runs through
``F.scaled_dot_product_attention`` with the gated bias and the key mask
materialised as one (B, H, T, T) float mask, its rows padded to a multiple
of 16 elements, which the memory-efficient kernel takes without a copy.

Spans (``utils/profiling.stage``): ``wavlm.extract`` (steps 1–3),
``wavlm.encoder`` (4–5), ``wavlm.head`` (6).  Counters: ``wavlm.frames``
(frames run, padded included), ``wavlm.pad_frames`` (of them padded),
``wavlm.bias_bytes`` (bytes of gated bias materialised).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import count, stage
from .ecapa import Dense, EcapaConfig, EcapaTdnn, _serving_copy, random_init

MASKED = -1e9  # the score of a padded key: finite, so a clip with no frame stays finite


@dataclass(frozen=True)
class WavLMEcapaConfig:
    # the encoder (wavlm-large's config.json names)
    conv_dim: tuple[int, ...] = (512,) * 7
    conv_kernel: tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_bucket_distance: int = 800
    gate_dim: int = 8
    layer_norm_eps: float = 1e-5
    # the head (UniSpeech's ECAPA_TDNN_SMALL)
    channels: int = 512
    emb_dim: int = 256
    scale: int = 8
    se_bottleneck: int = 128
    attention_channels: int = 128
    mfa_channels: int = 1536
    dilations: tuple[int, ...] = (2, 3, 4)
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def head(self) -> EcapaConfig:
        return EcapaConfig(n_mels=self.hidden_size, channels=self.channels, emb_dim=self.emb_dim,
                           scale=self.scale, se_bottleneck=self.se_bottleneck,
                           attention_channels=self.attention_channels,
                           mfa_channels=self.mfa_channels, dilations=tuple(self.dilations),
                           dtype=self.dtype, global_context=False, dense_blocks=True)

    @classmethod
    def from_dict(cls, d: dict) -> "WavLMEcapaConfig":
        tuples = ("conv_dim", "conv_kernel", "conv_stride", "dilations")
        return cls(**{k: tuple(v) if k in tuples else v for k, v in d.items()})


def frame_lengths(lengths: torch.Tensor, cfg: WavLMEcapaConfig) -> torch.Tensor:
    """Valid samples → valid frames through the CNN's formula, ⌊(L − k)/s⌋ + 1
    a layer (0 where a clip is shorter than the receptive field)."""
    n = lengths.to(torch.int64)
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        n = torch.clamp(torch.div(n - k, s, rounding_mode="floor") + 1, min=0)
    return n


def relative_buckets(offsets: torch.Tensor, num_buckets: int = 320,
                     max_distance: int = 800) -> torch.Tensor:
    """WavLM's bidirectional bucket of each key − query offset n: half the
    buckets a side, n > 0 in the upper half; |n| below half a side's count
    is its own bucket, else ⌊ln(|n|/e)/ln(max/e)·(side − e)⌋ + e with
    e = side / 2, capped at side − 1 (float32 logarithms, as WavLM takes
    them)."""
    side = num_buckets // 2
    exact = side // 2
    m = offsets.abs()
    large = exact + (torch.log(m.float() / exact) / math.log(max_distance / exact)
                     * (side - exact)).to(torch.int64)
    large = torch.clamp(large, max=side - 1)
    return (offsets > 0).to(torch.int64) * side + torch.where(m < exact, m, large)


def gates(z: torch.Tensor, const: torch.Tensor) -> torch.Tensor:
    """WavLM's gate of the relative bias, per head and query: the (B, T, H, 8)
    outputs of ``Linear(64 → 8)`` over each head's slice of LN₁(x), summed
    by fours into (a, b) through a sigmoid, then ``a·(b·cₕ − 1) + 2`` with
    ``const`` = (cₕ) → (B, H, T) f32."""
    b, t, heads, _ = z.shape
    ab = torch.sigmoid(z.float().view(b, t, heads, 2, -1).sum(-1))
    g = ab[..., 0] * (ab[..., 1] * const.float() - 1.0) + 2.0
    return g.permute(0, 2, 1)


def _cast(mod: nn.Module, x: torch.Tensor, dt: torch.dtype) -> list[torch.Tensor]:
    """``mod``'s own parameters in ``dt``: kept copies on the serving route
    (the card, bf16, autograd off; rebuilt when a parameter moves or is
    written), else cast now."""
    params = tuple(mod.parameters(recurse=False))
    if x.device.type == "cuda" and dt == torch.bfloat16 and not torch.is_grad_enabled():
        return _serving_copy(mod, params, lambda: [p.detach().to(dt) for p in params])
    return [p.to(dt) for p in params]


def _conv2d_params(conv: nn.Conv1d, x: torch.Tensor, dt: torch.dtype) -> list[torch.Tensor]:
    """A convolution's parameters for ``F.conv2d`` over the (B, C, 1, T) view
    of (B, T, C) frames: the weight as (out, in, 1, k), channels-last, so
    that cuDNN runs its NHWC kernels and hands back (B, T', C) frames (half
    the time of ``conv1d`` on the channels-first copy, the same result)."""
    w, *bias = _cast(conv, x, dt)
    return [w[:, :, None, :].contiguous(memory_format=torch.channels_last), *bias]


def _layer_norm(mod: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """float32 statistics and affine, whatever ``x``'s type."""
    return F.layer_norm(x.float(), mod.normalized_shape, mod.weight, mod.bias, mod.eps)


class EncoderLayer(nn.Module):
    """A pre-LN layer with WavLM's gated relative position bias."""

    def __init__(self, cfg: WavLMEcapaConfig, has_table: bool):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.heads = cfg.num_attention_heads
        self.ln1 = nn.LayerNorm(d, eps=eps)
        self.q, self.k, self.v, self.o = (Dense(d, d) for _ in range(4))
        self.gate = Dense(d // self.heads, cfg.gate_dim)
        self.gate_const = nn.Parameter(torch.ones(self.heads))
        if has_table:
            self.rel_table = nn.Parameter(torch.zeros(cfg.num_buckets, self.heads))
        self.ln2 = nn.LayerNorm(d, eps=eps)
        self.fc1 = Dense(d, cfg.intermediate_size)
        self.fc2 = Dense(cfg.intermediate_size, d)

    def forward(self, x: torch.Tensor, rel: torch.Tensor, keymask: torch.Tensor,
                dt: torch.dtype) -> torch.Tensor:
        """(B, T, D) f32 residual stream, (H, T, T) table bias and (B, 1, 1,
        T) key mask (0 or −1e9) in ``dt`` → the layer's output, f32."""
        b, t, d = x.shape
        h = _layer_norm(self.ln1, x).to(dt)
        q, k, v = (p(h, dt).view(b, t, self.heads, -1).transpose(1, 2)
                   for p in (self.q, self.k, self.v))
        g = gates(self.gate(h.view(b, t, self.heads, -1), dt), self.gate_const)
        # one pass: key mask + gate · table, in rows padded to 16 elements
        buf = torch.empty((b, self.heads, t, -(-t // 16) * 16), dtype=dt, device=x.device)
        bias = torch.addcmul(keymask, g[..., None].to(dt), rel[None], out=buf[..., :t])
        count("wavlm.bias_bytes", buf.numel() * buf.element_size())
        a = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        del buf, bias
        x = x + self.o(a.transpose(1, 2).reshape(b, t, d), dt).float()
        f = F.gelu(self.fc1(_layer_norm(self.ln2, x), dt))
        return x + self.fc2(f, dt).float()


class WavLMEcapa(nn.Module):
    """(B, L) float32 samples + (B,) valid sample counts → (B, emb_dim) f32
    (not normalized)."""

    def __init__(self, cfg: WavLMEcapaConfig = WavLMEcapaConfig()):
        super().__init__()
        self.cfg = cfg
        eps = cfg.layer_norm_eps
        cin = 1
        for i, (c, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)):
            self.add_module(f"conv{i}", nn.Conv1d(cin, c, k, s, bias=cfg.conv_bias))
            self.add_module(f"conv{i}_norm", nn.LayerNorm(c, eps=eps))
            cin = c
        self.proj_norm = nn.LayerNorm(cin, eps=eps)
        self.proj = Dense(cin, cfg.hidden_size)
        d = cfg.hidden_size
        self.pos_conv = nn.Conv1d(d, d, cfg.num_conv_pos_embeddings,
                                  padding=cfg.num_conv_pos_embeddings // 2,
                                  groups=cfg.num_conv_pos_embedding_groups)
        self.layers = nn.ModuleList(EncoderLayer(cfg, i == 0)
                                    for i in range(cfg.num_hidden_layers))
        self.mix = nn.Module()
        self.mix.weight = nn.Parameter(torch.zeros(cfg.num_hidden_layers + 1))
        self.head = EcapaTdnn(cfg.head)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights from ``generator``: the head by flax's default law
        (``ecapa.random_init``), every other kernel normal with variance
        1/fan_in, biases 0, norms the identity, the table standard normal,
        gate constants 1, equal state weights."""
        random_init(self.head, generator)
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, nn.LayerNorm):
                    mod.reset_parameters()
            for name, p in self.named_parameters():
                if name.startswith("head.") or "norm" in name or ".ln" in name:
                    continue
                if name.endswith("rel_table"):
                    p.copy_(torch.randn(p.shape, generator=generator))
                elif name.endswith("gate_const"):
                    p.fill_(1.0)
                elif p.dim() > 1:
                    p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(p[0].numel()))
                else:
                    p.zero_()

    def relative_bias(self, t: int, device) -> torch.Tensor:
        """(H, T, T): layer 0's table at each key − query offset's bucket."""
        pos = torch.arange(t, device=device)
        idx = relative_buckets(pos[None, :] - pos[:, None], self.cfg.num_buckets,
                               self.cfg.max_bucket_distance)
        return self.layers[0].rel_table[idx].permute(2, 0, 1)

    def extract(self, wav: torch.Tensor, lengths: torch.Tensor, dt: torch.dtype):
        """Steps 1–3: (B, T, D) f32 frames, zero where padded, and the (B, T)
        bool mask of valid frames."""
        cfg = self.cfg
        n = wav.shape[1]
        valid = torch.arange(n, device=wav.device)[None, :] < lengths[:, None]
        cnt = torch.clamp(lengths, min=1)[:, None].float()
        x = wav.float() * valid
        mean = x.sum(1, keepdim=True) / cnt
        var = ((x - mean) * valid).square().sum(1, keepdim=True) / cnt
        x = (x - mean) * torch.rsqrt(var + cfg.layer_norm_eps) * valid
        x = x.to(dt)[:, :, None]  # (B, L, 1): frames stay channels-last through the CNN
        for i, s in enumerate(cfg.conv_stride):
            conv, norm = getattr(self, f"conv{i}"), getattr(self, f"conv{i}_norm")
            y = F.conv2d(x.transpose(1, 2)[:, :, None, :], *_conv2d_params(conv, x, dt),
                         stride=(1, s))[:, :, 0, :].transpose(1, 2)
            x = F.gelu(F.layer_norm(y, norm.normalized_shape, *_cast(norm, y, dt), norm.eps))
        flen = frame_lengths(lengths, cfg)
        t = x.shape[1]
        mask = torch.arange(t, device=x.device)[None, :] < flen[:, None]
        count("wavlm.frames", mask.numel())
        count("wavlm.pad_frames", mask.numel() - flen.sum())
        h = self.proj(_layer_norm(self.proj_norm, x), dt).float()
        return h * mask[..., None], mask

    def encode(self, x: torch.Tensor, mask: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """Steps 4–5: the softmax-weighted sum of the 25 states, (B, T, D) f32."""
        cfg = self.cfg
        k = cfg.num_conv_pos_embeddings
        pos = F.conv1d(x.to(dt).transpose(1, 2), *_cast(self.pos_conv, x, dt), padding=k // 2,
                       groups=cfg.num_conv_pos_embedding_groups)
        x = x + F.gelu(pos[..., : x.shape[1]]).transpose(1, 2).float()
        w = torch.softmax(self.mix.weight.float(), dim=0)
        acc = x * w[0]
        rel = self.relative_bias(x.shape[1], x.device).to(dt)
        keymask = torch.where(mask, 0.0, MASKED).to(dt)[:, None, None, :]
        for i, layer in enumerate(self.layers):
            x = layer(x, rel, keymask, dt)
            acc.add_(x * w[i + 1])
        return acc

    def forward(self, wav: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        with stage("wavlm.extract"):
            x, mask = self.extract(wav, lengths, dt)
        with stage("wavlm.encoder"):
            h = self.encode(x, mask, dt)
        with stage("wavlm.head"):
            m = mask[..., None].float()
            cnt = torch.clamp(m.sum(1, keepdim=True), min=1.0)
            mean = (h * m).sum(1, keepdim=True) / cnt
            var = ((h - mean) * m).square().sum(1, keepdim=True) / cnt
            feats = (h - mean) * torch.rsqrt(var + 1e-5) * m
            return self.head(feats, mask)
