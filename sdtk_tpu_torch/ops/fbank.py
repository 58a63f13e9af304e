"""Log-mel frontend: configuration, frame mask, and the plain versions.

The counterpart of ``sdtk_tpu/ops/fbank.py``.  :func:`log_mel` is the
plain PyTorch version of the frontend (the reference the CUDA kernel in
``ops/fbank_wave.py`` is held to); :func:`log_mel_reference` is the NumPy
FFT oracle, which the trained VAD uses on the host.

Rounding follows the JAX package: the preemphasized frames, the windowed
DFT bases, the power spectrum and the mel matrix are rounded to
``compute_dtype``; every product is accumulated in float32.  Products of
two bfloat16 values are exact in float32, so the products here run on
float32 copies of the rounded operands — the same numbers that JAX's
``preferred_element_type=float32`` gives.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from . import melbank


@dataclass(frozen=True)
class FrontendConfig:
    sample_rate: int = 16000
    win_length: int = 400  # 25 ms
    hop_length: int = 160  # 10 ms
    n_fft: int = 512
    n_mels: int = 80
    window: str = "hann"
    preemphasis: float = 0.97
    log_floor: float = 1e-6
    mean_norm: bool = True  # per-utterance CMN over valid frames
    compute_dtype: str = "bfloat16"
    log_scale: str = "ln"   # "ln" (natural log) | "db" (10·log10)
    mel_fmin: float = 20.0
    center: bool = False    # torch.stft center=True framing (pad win//2)

    @property
    def frames_per_second(self) -> float:
        return self.sample_rate / self.hop_length

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def num_frames(self, n_samples: int) -> int:
        if self.center:
            return 1 + n_samples // self.hop_length
        return melbank.num_frames(n_samples, self.win_length, self.hop_length)


def frame_mask(lengths: torch.Tensor, n_samples: int, cfg: FrontendConfig) -> torch.Tensor:
    """(B,) sample lengths → (B, T) bool validity mask over frames."""
    t = torch.arange(cfg.num_frames(n_samples), device=lengths.device)
    if cfg.center:  # frame t is centered at t·hop
        return cfg.hop_length * t[None, :] < lengths[:, None]
    return cfg.win_length + cfg.hop_length * t[None, :] <= lengths[:, None]


def preemphasize(x: torch.Tensor, coeff: float) -> torch.Tensor:
    """x[n] − c·x[n−1] along the last axis, with x[−1] = 0."""
    if coeff <= 0:
        return x
    return x - coeff * torch.nn.functional.pad(x[:, :-1], (1, 0))


@lru_cache(maxsize=16)
def bases(cfg: FrontendConfig, device: torch.device, dtype: torch.dtype
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(wr, wi, mel) on ``device``, rounded to the compute dtype and held
    as ``dtype``: windowed DFT bases (win, n_freqs) and the mel matrix
    (n_freqs, n_mels)."""
    wr, wi = melbank.windowed_bases(cfg.win_length, cfg.n_fft, cfg.window)
    mel = melbank.mel_filterbank(cfg.n_mels, cfg.n_fft, cfg.sample_rate, fmin=cfg.mel_fmin)
    return tuple(
        torch.from_numpy(a).to(device).to(cfg.torch_dtype).to(dtype).contiguous()
        for a in (wr, wi, mel)
    )


def log_of_mel(melspec: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    if cfg.log_scale == "db":  # torch/SB convention: 10·log10(clamp(x, amin))
        return 10.0 * torch.log10(torch.clamp(melspec, min=cfg.log_floor))
    return torch.log(melspec + cfg.log_floor)


def normalize(feats: torch.Tensor, mask: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """Per-utterance CMN over valid frames (when ``cfg.mean_norm``) and
    zeroed padding frames."""
    m = mask[..., None].to(feats.dtype)
    if cfg.mean_norm:
        denom = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
        mean = (feats * m).sum(dim=1, keepdim=True) / denom
        return (feats - mean) * m
    return feats * m


def raw_log_mel(xp: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(B, N') already preemphasized (and, for ``center``, padded) signal
    → (B, T, n_mels) log-mel without CMN or mask: frames at hop, rounded
    to the compute dtype, windowed DFT, power, mel, log."""
    dt = cfg.torch_dtype
    wr, wi, mel = bases(cfg, xp.device, torch.float32)
    frames = xp.unfold(1, cfg.win_length, cfg.hop_length).to(dt).float()
    re = frames @ wr
    im = frames @ wi
    power = (re * re + im * im).to(dt).float()
    return log_of_mel(power @ mel, cfg)


def pad_centered(x: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    pad = cfg.win_length // 2
    return torch.nn.functional.pad(x, (pad, pad))


def mask_for(lengths: torch.Tensor | None, x: torch.Tensor, t: int,
             cfg: FrontendConfig) -> torch.Tensor:
    if lengths is None:
        return torch.ones((x.shape[0], t), dtype=torch.bool, device=x.device)
    return frame_mask(lengths.to(x.device), x.shape[1], cfg)


def log_mel(
    x: torch.Tensor, cfg: FrontendConfig = FrontendConfig(),
    lengths: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched log-mel features, plain PyTorch.

    Args:
        x: (B, N) float32 waveform at cfg.sample_rate, N >= win_length.
        lengths: optional (B,) valid sample counts (ragged batches).

    Returns:
        feats: (B, T, n_mels) float32
        mask:  (B, T) bool — valid frames
    """
    xp = preemphasize(x.float(), cfg.preemphasis)
    if cfg.center:
        xp = pad_centered(xp, cfg)
    feats = raw_log_mel(xp, cfg)
    mask = mask_for(lengths, x, feats.shape[1], cfg)
    return normalize(feats, mask, cfg), mask


def log_mel_reference(x: np.ndarray, cfg: FrontendConfig = FrontendConfig()) -> np.ndarray:
    """Straightforward NumPy/FFT implementation (a copy of the JAX
    package's oracle; the trained VAD computes its features with it)."""
    if cfg.preemphasis > 0:
        x = x - cfg.preemphasis * np.concatenate([[0.0], x[:-1]])
    t = cfg.num_frames(len(x))
    if cfg.center:
        pad = cfg.win_length // 2
        x = np.pad(x, (pad, pad))
    w = melbank.window(cfg.win_length, cfg.window)
    mel = melbank.mel_filterbank(
        cfg.n_mels, cfg.n_fft, cfg.sample_rate, fmin=cfg.mel_fmin
    )
    frames = np.stack(
        [x[i * cfg.hop_length : i * cfg.hop_length + cfg.win_length] for i in range(t)]
    )
    spec = np.fft.rfft(frames * w, n=cfg.n_fft, axis=-1)
    power = np.abs(spec) ** 2
    if cfg.log_scale == "db":
        feats = 10.0 * np.log10(np.maximum(power @ mel, cfg.log_floor))
    else:
        feats = np.log(power @ mel + cfg.log_floor)
    if cfg.mean_norm:
        feats = feats - feats.mean(axis=0, keepdims=True)
    return feats.astype(np.float32)
