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

Tensor parallel (``parallel/sharding.py:shard_params``): a Conv or Dense
whose ``tp`` is set holds its rank's block of the weight.  A Conv split
on its output channels, or a lone Dense split so, computes its block and
gathers the whole output before its (replicated) bias; a Dense split on
its input rows takes its block of the input and sums the partial
products over the model ranks; SE's fc1 and fc2, split on the bottleneck,
are one pair with one sum.  Each returns what the whole layer returns.

UniSpeech's layout (``ECAPA_TDNN`` of its speaker-verification recipe,
the head of ``models/wavlm.py``): ``global_context=False`` pools with
attention over h_t alone, and ``dense_blocks=True`` feeds block i + 1 the
sum of the stem's and every earlier block's output (UniSpeech's
``out3 = layer3(out1 + out2) + out1 + out2``); the MFA concatenates the
blocks' outputs either way.  Both at their defaults leave the tower as
the JAX module computes it.

Serving route.  An eval forward on the card in bf16 with autograd off (no
``tp``) takes each convolution's ReLU → BatchNorm → bf16 → mask in one
launch of ``ops/tower_epilogue.py`` (a Res2 split's next-split add and its
slice of the block's output too), and each Conv and Dense its weight and
bias from a bf16 serving copy instead of casting them every call.  The
copies and each BatchNorm's f32 (scale, shift) are built at first use or
ahead by :func:`prepare_serving`, and rebuilt whenever a parameter or
statistic is replaced or written in place (``load_state_dict``, ``.to()``,
an optimizer step).  Training, tensor parallel, f32 towers and the CPU
take the eager ops above.  Counters (while profiling): ``tower.epilogues``
every post-convolution epilogue, ``tower.fused_epilogues`` those the
kernel ran.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.tower_epilogue import bn_affine, tower_epilogue
from ..parallel.sharding import copy_to, gather_from, reduce_from, scatter_to
from ..utils.profiling import count


SERVING_DEVICES = ("cuda",)  # where the serving route runs


def serving(mod: "Conv | Dense", x: torch.Tensor, dt: torch.dtype) -> bool:
    """Take the serving route: an eval Conv or Dense on the card, bf16, with
    autograd off (the kernel has no backward) and no tensor-parallel
    split."""
    return _serving_on(mod, x.device, dt)


def _serving_on(mod: "Conv | Dense", device: torch.device, dt: torch.dtype) -> bool:
    return (device.type in SERVING_DEVICES and not mod.training and dt == torch.bfloat16
            and not torch.is_grad_enabled() and mod.tp is None)


def serving_tower(modules, device: torch.device, dt: torch.dtype) -> bool:
    """Every Conv and Dense among ``modules`` (a tower's ``modules()``)
    takes the serving route on ``device`` in ``dt``: the tower's whole
    forward is the serving one."""
    return all(_serving_on(m, device, dt) for m in modules if isinstance(m, (Conv, Dense)))


def _serving_copy(mod: nn.Module, sources: tuple[torch.Tensor, ...], make):
    """``make()``'s tensors, cached on ``mod`` until a tensor of ``sources``
    moves or is written (its storage or version counter changes)."""
    key = [(t.data_ptr(), t._version) for t in sources]
    cached = mod.__dict__.get("_serving")
    if cached is None or cached[0] != key:
        with torch.no_grad():
            cached = (key, make())
        mod.__dict__["_serving"] = cached
    return cached[1]


def _cast_copy(mod: nn.Module, dt: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """A Conv's or Dense's serving copy of (weight, bias) in ``dt``."""
    w, b = mod.weight, mod.bias
    return _serving_copy(mod, (w, b), lambda: (w.detach().to(dt), b.detach().to(dt)))


def _params(mod: nn.Module, x: torch.Tensor, dt: torch.dtype):
    """A Conv's or Dense's (weight, bias) in ``dt``: the serving copy on the
    serving route, else cast now."""
    if serving(mod, x, dt):
        return _cast_copy(mod, dt)
    return mod.weight.to(dt), mod.bias.to(dt)


def _epilogue(bn: "BatchNorm | None", y: torch.Tensor, m: torch.Tensor | None, dt: torch.dtype,
              mask: torch.Tensor | None, owner: nn.Module) -> torch.Tensor:
    """ReLU → ``bn`` (f32, None: none) → ``dt`` → times the (B, 1, T) float
    mask ``m`` (None with ``mask`` None: unmasked) after a convolution; on
    the serving route one kernel launch, reading the (B, T) bool ``mask``."""
    fused = serving(owner, y, dt)
    count("tower.epilogues")
    if fused:
        count("tower.fused_epilogues")
        scale, shift = bn.serving_affine() if bn is not None else (None, None)
        return tower_epilogue(y, mask, scale, shift)
    x = torch.relu(y)
    if bn is not None:
        x = bn(x).to(dt)
    return x if m is None else x * m.to(dt)


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
    global_context: bool = True  # False (UniSpeech): the attention sees h_t alone
    dense_blocks: bool = False   # True (UniSpeech): block i takes the sum of all before it

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
        self.tp = None  # parallel.sharding.Split: this rank's output channels

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        if self.tp is None:
            w, b = _params(self, x, dt)
            return F.conv1d(x.to(dt), w, b, padding=self.pad, dilation=self.dilation,
                            groups=self.groups)
        if self.tp.dim != 0 or self.groups != 1:
            raise NotImplementedError("a Conv splits its output channels only, ungrouped")
        mesh = self.tp.mesh
        y = F.conv1d(copy_to(x.to(dt), mesh), self.weight.to(dt), None,
                     padding=self.pad, dilation=self.dilation)
        return gather_from(y, 1, mesh) + self.bias.to(dt)[:, None]


class Dense(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.tp = None  # parallel.sharding.Split: dim 0 outputs, dim 1 input rows

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        if self.tp is None:
            return F.linear(x.to(dt), *_params(self, x, dt))
        mesh = self.tp.mesh
        if self.tp.dim == 1:
            y = F.linear(scatter_to(x.to(dt), -1, mesh), self.weight.to(dt))
            return reduce_from(y, mesh) + self.bias.to(dt)
        y = F.linear(copy_to(x.to(dt), mesh), self.weight.to(dt))
        return gather_from(y, -1, mesh) + self.bias.to(dt)


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
    one rank in ``sync_group`` (None: the whole process group), the batch
    is the global one, as GSPMD makes it for the JAX step over a ``data``
    mesh: Σx, Σx² and the count are summed over the group's ranks in
    float32 by an all-reduce that autograd differentiates, so the backward
    is the global batch's too.  With a model axis the group is the data
    ranks of one model column: the model ranks of a data row hold the same
    rows and every channel."""

    momentum = 0.99

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eps = eps
        self.sync = False  # statistics over the ranks of sync_group
        self.sync_group = None

    def serving_affine(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Eval normalization as f32 per-channel (scale, shift)
        (``ops/tower_epilogue.py:bn_affine``), kept until a statistic or
        parameter changes."""
        src = (self.running_mean, self.running_var, self.weight, self.bias)
        return _serving_copy(self, src, lambda: bn_affine(*(t.detach() for t in src), self.eps))

    def _global_moments(self, x: torch.Tensor, dims: list[int]
                        ) -> tuple[torch.Tensor, torch.Tensor] | None:
        """(E[x], E[x²]) over every rank's batch, or None to use this
        rank's alone (no sync, no group, or a group of one)."""
        import torch.distributed as dist

        if (not self.sync or not dist.is_initialized()
                or dist.get_world_size(self.sync_group) == 1):
            return None
        from torch.distributed.nn.functional import all_reduce

        count = x.new_full((1,), float(x.numel() // x.shape[1]))
        sums = all_reduce(torch.cat([x.sum(dims), (x * x).sum(dims), count]),
                          group=self.sync_group or dist.group.WORLD)
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

    def forward(self, x, m, dt, mask):
        return _epilogue(self.bn, self.conv(x, dt), m, dt, mask, self.conv)


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

    def forward(self, x, m, dt, mask):
        if serving(self.conv1, x, dt):
            return self._serve(x.contiguous(), mask, dt)
        xs = torch.chunk(x, self.scale, dim=1)
        outs = [xs[0]]
        prev = None
        for i in range(1, self.scale):
            inp = xs[i] if prev is None else xs[i] + prev
            prev = _epilogue(getattr(self, f"bn{i}"), getattr(self, f"conv{i}")(inp, dt), m, dt,
                             mask, self.conv1)
            outs.append(prev)
        return torch.cat(outs, dim=1)

    def _serve(self, x, mask, dt):
        """The serving route: split i's epilogue writes its slice of the
        output and, for i < scale − 1, split i + 1's input xs[i+1] + out_i
        (rounded as PyTorch's bf16 add rounds); no add, no cat."""
        xs = torch.chunk(x, self.scale, dim=1)
        out = torch.empty_like(x)
        w = xs[0].shape[1]
        out[:, :w].copy_(xs[0])
        inp = xs[1]
        for i in range(1, self.scale):
            scale, shift = getattr(self, f"bn{i}").serving_affine()
            y = getattr(self, f"conv{i}")(inp, dt)
            nxt = xs[i + 1] if i + 1 < self.scale else None
            res = tower_epilogue(y, mask, scale, shift, out=out[:, i * w : (i + 1) * w], add=nxt)
            inp = res[1] if nxt is not None else None
        count("tower.epilogues", self.scale - 1)
        count("tower.fused_epilogues", self.scale - 1)
        return out


class SEBlock(nn.Module):
    """Squeeze-excitation with a masked f32 mean over time."""

    def __init__(self, channels: int, bottleneck: int = 128):
        super().__init__()
        self.fc1 = Dense(channels, bottleneck)
        self.fc2 = Dense(bottleneck, channels)

    def forward(self, x, m, dt):
        denom = torch.clamp(m.sum(dim=2), min=1.0)
        s = (x.float() * m).sum(dim=2) / denom  # (B, C)
        fc1, fc2 = self.fc1, self.fc2
        if fc1.tp is not None and fc2.tp is not None:  # split on the bottleneck: one sum
            mesh = fc1.tp.mesh
            h = F.linear(copy_to(s.to(dt), mesh), fc1.weight.to(dt),
                         scatter_to(fc1.bias, 0, mesh).to(dt))
            y = reduce_from(F.linear(torch.relu(h), fc2.weight.to(dt)), mesh)
            s = torch.sigmoid(y + fc2.bias.to(dt))
        else:
            s = torch.sigmoid(fc2(torch.relu(fc1(s, dt)), dt))
        return x * s[:, :, None]


class SERes2Block(nn.Module):
    """1×1 TDNN → Res2 conv → 1×1 TDNN → SE, with a residual connection."""

    def __init__(self, channels, kernel=3, dilation=1, scale=8, se_bottleneck=128):
        super().__init__()
        self.tdnn_in = TdnnBlock(channels, channels, 1, 1)
        self.res2 = Res2Conv(channels, kernel, dilation, scale)
        self.tdnn_out = TdnnBlock(channels, channels, 1, 1)
        self.se = SEBlock(channels, se_bottleneck)

    def forward(self, x, m, dt, mask):
        residual = x
        x = self.tdnn_in(x, m, dt, mask)
        x = self.res2(x, m, dt, mask)
        x = self.tdnn_out(x, m, dt, mask)
        x = self.se(x, m, dt)
        return x + residual


class AttentiveStatsPooling(nn.Module):
    """Channel- and context-dependent attentive statistics pooling:
    attention sees [h_t, global mean, global std] (``global_context``) or
    h_t alone; returns (B, 2C) f32."""

    def __init__(self, channels: int, attention_channels: int = 128, tdnn_attention=False,
                 global_context=True):
        super().__init__()
        self.att1 = Conv((3 if global_context else 1) * channels, attention_channels)
        if tdnn_attention:
            self.att_bn = BatchNorm(attention_channels)
        self.att2 = Conv(attention_channels, channels)
        self.tdnn_attention = tdnn_attention
        self.global_context = global_context

    def forward(self, x, mask, dt):
        ctx = x
        if self.global_context:
            mean, std = _masked_mean_std(x, mask[:, None, :].float())
            t = x.shape[2]
            ctx = torch.cat([x, mean[:, :, None].expand(-1, -1, t).to(x.dtype),
                             std[:, :, None].expand(-1, -1, t).to(x.dtype)], dim=1)
        a = self.att1(ctx, dt)
        if self.tdnn_attention:  # unmasked, as the JAX module leaves it
            a = _epilogue(self.att_bn, a, None, dt, None, self.att1)
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
                                         tdnn_attention=cfg.asp_tdnn,
                                         global_context=cfg.global_context)
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

        x = self.stem(x, m, dt, mask)
        block_outs = []
        for i in range(len(cfg.dilations)):
            out = getattr(self, f"block{i + 1}")(x, m, dt, mask)
            block_outs.append(out)
            x = x + out if cfg.dense_blocks else out

        x = _epilogue(self.mfa_bn if cfg.mfa_bn else None,
                      self.mfa(torch.cat(block_outs, dim=1), dt), m, dt, mask, self.mfa)

        pooled = self.asp_bn(self.asp(x, mask, dt))
        return self.embedding(pooled, torch.float32)


def prepare_serving(model: nn.Module) -> None:
    """Build the serving copies of ``model``'s Conv and Dense weights (in its
    compute dtype) and BatchNorm constants now, so that the first serving
    forward does not; each is rebuilt at use if it went stale.  Any tower
    built of these modules (ECAPA, the x-vector, the Conformer) takes it."""
    dt = model.cfg.compute_dtype
    if dt != torch.bfloat16:
        return
    for mod in model.modules():
        if isinstance(mod, (Conv, Dense)) and mod.tp is None:
            _cast_copy(mod, dt)
        elif isinstance(mod, BatchNorm):
            mod.serving_affine()


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=eps)
