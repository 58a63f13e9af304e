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


# Geometry of the packed operands: csrc/dft_mma.cuh reads exactly this.
DFT_BINS = 32        # bins per chunk (one wgmma of n = 64: 32 rows of re, 32 of im)
DFT_MEL_GROUP = 80   # mels per block (one wgmma of n = 80)
MMA_MAX_WIN = 576    # the bf16 kernel's frame tile and one chunk of bases fill shared memory
FMA_MAX_FREQS = 288  # the f32 kernel keeps 9 bins a lane in registers


def _round_up(n: int, to: int) -> int:
    return -(-n // to) * to


def _core_matrices(a: torch.Tensor) -> torch.Tensor:
    """(..., rows, k) -> (..., rows·k) in the order a ``wgmma`` descriptor
    without swizzle reads an operand: core matrices of 8 rows x 8 k, each 64
    contiguous values, ordered (row // 8, k // 8, row % 8, k % 8)."""
    *lead, rows, k = a.shape
    a = a.reshape(*lead, rows // 8, 8, k // 8, 8).transpose(-3, -2)
    return a.reshape(*lead, rows * k)


def pack_dft_operands(wr: torch.Tensor, wi: torch.Tensor, mel: torch.Tensor) -> torch.Tensor:
    """Pack the DFT bases (win, n_freqs) and the mel matrix (n_freqs,
    n_mels) as the tensor-core kernels stream them, one row per chunk of
    32 bins.  First the chunk's 64 basis rows (32 of ``wr.T``, then 32 of
    ``wi.T``) over K = win padded to a multiple of 16.  Then, for each
    group of 80 mels (n_mels padded to whole groups), the group's 80 rows
    of ``mel.T`` over the chunk's 32 bins.  Both in the order of
    :func:`_core_matrices`.  All padding is zero, so products on the packed
    operands add exact zeros.  Returns (n_chunks, 64·kp + nmp·32) in the
    inputs' dtype."""
    win, n_freqs = wr.shape
    n_mels = mel.shape[1]
    kp = _round_up(win, 16)
    n_chunks = _round_up(n_freqs, DFT_BINS) // DFT_BINS
    nmp = _round_up(n_mels, DFT_MEL_GROUP)
    basis = wr.new_zeros((2, n_chunks * DFT_BINS, kp))
    basis[0, :n_freqs, :win] = wr.T
    basis[1, :n_freqs, :win] = wi.T
    basis = basis.reshape(2, n_chunks, DFT_BINS, kp).transpose(0, 1)  # chunk, re/im, row, k
    basis = _core_matrices(basis.reshape(n_chunks, 2 * DFT_BINS, kp))
    melt = mel.new_zeros((nmp, n_chunks * DFT_BINS))
    melt[:n_mels, :n_freqs] = mel.T
    melt = melt.reshape(nmp // DFT_MEL_GROUP, DFT_MEL_GROUP, n_chunks, DFT_BINS).permute(2, 0, 1, 3)
    melp = _core_matrices(melt).reshape(n_chunks, -1)  # chunk, group, then 80 rows x 32 bins
    return torch.cat([basis, melp], dim=1).contiguous()


@lru_cache(maxsize=16)
def packed_bases(cfg: FrontendConfig, device: torch.device) -> torch.Tensor:
    """:func:`bases` in bfloat16, packed for the tensor-core kernels."""
    return pack_dft_operands(*bases(cfg, device, torch.bfloat16))


def check_kernel_range(cfg: FrontendConfig) -> None:
    """Raise for a configuration the log-mel kernels cannot take."""
    if cfg.compute_dtype == "bfloat16":
        if cfg.win_length > MMA_MAX_WIN:
            raise ValueError(f"win_length {cfg.win_length} > {MMA_MAX_WIN}: the bfloat16 log-mel "
                             "kernel's frame tile does not fit shared memory")
    elif cfg.compute_dtype == "float32":
        if cfg.n_fft // 2 + 1 > FMA_MAX_FREQS:
            raise ValueError(f"n_fft {cfg.n_fft} gives more than {FMA_MAX_FREQS} bins: the "
                             "float32 log-mel kernel keeps them in registers")
    else:
        raise ValueError(f"kernel supports float32/bfloat16 compute, not {cfg.compute_dtype}")


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
