"""Trained frame-level voice activity detection.

Two faces, one parameter set, as in ``sdtk_tpu/models/vad.py``:

- :class:`VadNet` — the torch module for training
  (``evals/train_vad.py``): two or three dilated 1-D convs + LayerNorm on
  per-window-CMN'd log-mel, a per-frame speech logit; the counterpart of
  the flax ``VadNet``.  :func:`save_params` writes its weights as the flax
  msgpack the JAX trainer writes, byte for byte.
- :class:`VadScorer` — a NumPy copy of the JAX ``VadScorer`` (identical
  numerics) for serving.  The model has ~23k parameters and gates windows
  on the host before the embedding program, so it stays on the host here
  too.  The checkpoint is read with the port's flax-msgpack reader.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..config import repo_models_dir
from ..utils.checkpoint import read_msgpack, vad_jax_tree, write_msgpack
from .ecapa import lecun_init_


@dataclass(frozen=True)
class VadConfig:
    n_mels: int = 80
    channels: int = 32
    kernel: int = 5
    dilation: int = 2
    deep: bool = False    # third conv at dilation3 (inferred from the checkpoint)
    dilation3: int = 8
    extra_feats: bool = False  # [flatness, flux] channels (inferred likewise)


_FLATNESS_SCALE = 5.0
_FLUX_SCALE = 2.0


def _derived_channels_np(x: np.ndarray) -> np.ndarray:
    """(T, M) log-mel → (T, 2) [flatness, flux]."""
    m = np.mean(x, axis=-1)
    flat = -np.log(
        np.mean(np.exp(x - m[:, None]), axis=-1) + 1e-8) / _FLATNESS_SCALE
    d = np.mean(np.abs(np.diff(x, axis=0)), axis=-1)
    flux = np.concatenate([d[:1], d]) / _FLUX_SCALE
    return np.stack([flat, flux], axis=-1).astype(np.float32)


def derived_channels(x: torch.Tensor) -> torch.Tensor:
    """(B, T, M) log-mel → (B, T, M + 2): [flatness, flux] appended, the
    flax module's formula (log(GM/AM) over mel bands, mean-shifted; mean
    |Δ| between frames, the first frame's repeated)."""
    m = x.mean(dim=-1)
    flat = -torch.log(torch.exp(x - m[..., None]).mean(dim=-1) + 1e-8) / _FLATNESS_SCALE
    d = (x[:, 1:] - x[:, :-1]).abs().mean(dim=-1)
    flux = torch.cat([d[:, :1], d], dim=1) / _FLUX_SCALE
    return torch.cat([x, flat[..., None], flux[..., None]], dim=-1)


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` over the last axis: ε = 1e-6, the variance
    as max(E[x²] − E[x]², 0), then (x − μ)·(rsqrt(var + ε)·scale) + bias.
    ``weight`` is flax's ``scale``."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
        return (x - mu) * (torch.rsqrt(var + 1e-6) * self.weight) + self.bias


class VadNet(nn.Module):
    """(B, T, n_mels) log-mel (per-window CMN) → (B, T) speech logits.

    conv1 (k 5) → ReLU → ln1 → conv2 (k 3, dilation 2) → ReLU → ln2 →
    [conv3 (k 3, dilation 8) → ReLU → ln3] → out (Dense 1), every conv
    zero-padded SAME ((k − 1)/2 · dilation a side).  ``cfg.extra_feats``
    appends the derived [flatness, flux] channels first; ``cfg.deep``
    adds conv3."""

    def __init__(self, cfg: VadConfig = VadConfig()):
        super().__init__()
        self.cfg = cfg
        c, cin = cfg.channels, cfg.n_mels + (2 if cfg.extra_feats else 0)

        def conv(i: int, k: int, dilation: int = 1) -> nn.Conv1d:
            return nn.Conv1d(i, c, k, padding=(k - 1) // 2 * dilation, dilation=dilation)

        self.conv1, self.ln1 = conv(cin, cfg.kernel), LayerNorm(c)
        self.conv2, self.ln2 = conv(c, 3, cfg.dilation), LayerNorm(c)
        if cfg.deep:
            self.conv3, self.ln3 = conv(c, 3, cfg.dilation3), LayerNorm(c)
        self.out = nn.Linear(c, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's default law from ``generator``: ``lecun_normal`` conv and
        Dense kernels, zero biases, identity LayerNorms."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv1d, nn.Linear)):
                lecun_init_(mod, generator)
            elif isinstance(mod, LayerNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = derived_channels(feats) if self.cfg.extra_feats else feats
        layers = [(self.conv1, self.ln1), (self.conv2, self.ln2)]
        if self.cfg.deep:
            layers.append((self.conv3, self.ln3))
        for conv, ln in layers:  # the convs take (B, C, T)
            x = ln(torch.relu(conv(x.transpose(1, 2))).transpose(1, 2))
        return self.out(x).squeeze(-1)


def save_params(model: VadNet, path: str | Path) -> None:
    """Write ``model``'s weights as the flax variables ``{"params": ...}``
    in flax msgpack (the bytes ``flax.serialization.to_bytes`` writes for
    the JAX trainer's tree), atomically."""
    write_msgpack(path, vad_jax_tree(model.state_dict()))


def default_checkpoint() -> Path:
    return repo_models_dir() / "vad.msgpack"


class VadScorer:
    """NumPy serving inference for the trained VAD.

    The graph is inferred from the checkpoint tree, as in the JAX
    package: ``conv3`` present = the deep graph; a ``conv1`` input wider
    than ``n_mels`` = the derived channels.  Both flags are recorded in
    ``self.cfg`` beside the loaded weights."""

    def __init__(self, params_path: str | Path | None = None,
                 cfg: VadConfig = VadConfig()):
        path = Path(params_path) if params_path else default_checkpoint()
        if not path.exists():
            raise FileNotFoundError(
                f"no VAD checkpoint at {path} — train one with "
                f"evals/train_vad.py or fall back to the energy gate")
        p = read_msgpack(path)["params"]
        f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
        self.w1, self.b1 = f32(p["conv1"]["kernel"]), f32(p["conv1"]["bias"])  # (k, in, ch)
        self.g1, self.be1 = f32(p["ln1"]["scale"]), f32(p["ln1"]["bias"])
        self.w2, self.b2 = f32(p["conv2"]["kernel"]), f32(p["conv2"]["bias"])
        self.g2, self.be2 = f32(p["ln2"]["scale"]), f32(p["ln2"]["bias"])
        self.wo, self.bo = f32(p["out"]["kernel"]), f32(p["out"]["bias"])  # (ch, 1)
        deep = "conv3" in p
        if deep:
            self.w3, self.b3 = f32(p["conv3"]["kernel"]), f32(p["conv3"]["bias"])
            self.g3, self.be3 = f32(p["ln3"]["scale"]), f32(p["ln3"]["bias"])
        else:
            self.w3 = None
        self.extra_feats = self.w1.shape[1] > cfg.n_mels
        self.cfg = replace(cfg, deep=deep, extra_feats=self.extra_feats)
        self.params_source = str(path)

    @staticmethod
    def _conv_same(x: np.ndarray, w: np.ndarray, b: np.ndarray,
                   dilation: int = 1) -> np.ndarray:
        """(T, Cin) ⊛ (k, Cin, Cout), zero-padded SAME, via shifted matmuls."""
        t = x.shape[0]
        k = w.shape[0]
        half = (k - 1) // 2 * dilation
        xp = np.pad(x, ((half, half), (0, 0)))
        out = np.tile(b, (t, 1)).astype(np.float32)
        for tap in range(k):
            out += xp[tap * dilation : tap * dilation + t] @ w[tap]
        return out

    @staticmethod
    def _ln(x: np.ndarray, g: np.ndarray, b: np.ndarray) -> np.ndarray:
        mu = x.mean(axis=-1, keepdims=True)
        var = x.var(axis=-1, keepdims=True)
        return (x - mu) / np.sqrt(var + 1e-6) * g + b

    def frame_probs(self, feats: np.ndarray) -> np.ndarray:
        """(T, n_mels) per-window-CMN log-mel → (T,) speech probability."""
        x = np.asarray(feats, np.float32)
        if self.extra_feats:
            x = np.concatenate([x, _derived_channels_np(x)], axis=-1)
        x = self._conv_same(x, self.w1, self.b1)
        x = self._ln(np.maximum(x, 0.0), self.g1, self.be1)
        x = self._conv_same(x, self.w2, self.b2, dilation=self.cfg.dilation)
        x = self._ln(np.maximum(x, 0.0), self.g2, self.be2)
        if self.w3 is not None:
            x = self._conv_same(x, self.w3, self.b3, dilation=self.cfg.dilation3)
            x = self._ln(np.maximum(x, 0.0), self.g3, self.be3)
        logit = (x @ self.wo)[:, 0] + self.bo[0]
        return 1.0 / (1.0 + np.exp(-logit))
