"""Trained frame-level voice activity detection — serving inference.

A NumPy copy of ``sdtk_tpu/models/vad.py:VadScorer`` (identical
numerics): two or three dilated 1-D convs + LayerNorm (ε = 1e-6) on
per-window-CMN'd log-mel, a per-frame speech logit.  The model has ~23k
parameters and gates windows on the host before the embedding program,
so it stays on the host here too.  The checkpoint is read with the
port's flax-msgpack reader.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from pathlib import Path

import numpy as np

from ..config import repo_models_dir
from ..utils.checkpoint import read_msgpack


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
