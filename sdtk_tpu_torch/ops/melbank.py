"""Host-side construction of DFT bases and mel filterbanks.

A NumPy copy of ``sdtk_tpu/ops/melbank.py`` (identical numerics): the
frontend (``ops/fbank.py``) and its CUDA kernel (``ops/fbank_wave.py``)
evaluate the windowed DFT as products with these fixed cos/sin bases
(GEMM-NDFT, after MelT — PAPERS.md).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def hz_to_mel(hz: np.ndarray | float) -> np.ndarray | float:
    """HTK mel scale."""
    return 2595.0 * np.log10(1.0 + np.asarray(hz) / 700.0)


def mel_to_hz(mel: np.ndarray | float) -> np.ndarray | float:
    return 700.0 * (10.0 ** (np.asarray(mel) / 2595.0) - 1.0)


@lru_cache(maxsize=8)
def mel_filterbank(
    n_mels: int = 80,
    n_fft: int = 512,
    sample_rate: int = 16000,
    fmin: float = 20.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Triangular mel filterbank, shape (n_fft//2+1, n_mels), float32."""
    fmax = fmax or sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fb = np.zeros((n_freqs, n_mels), dtype=np.float64)
    for m in range(n_mels):
        lo, center, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (freqs - lo) / max(center - lo, 1e-10)
        down = (hi - freqs) / max(hi - center, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb.astype(np.float32)


@lru_cache(maxsize=8)
def dft_bases(win_length: int = 400, n_fft: int = 512) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag NDFT bases of shape (win_length, n_fft//2+1).

    Evaluating only the first ``win_length`` rows is equivalent to
    zero-padding each frame to ``n_fft`` before an FFT.
    """
    n_freqs = n_fft // 2 + 1
    n = np.arange(win_length)[:, None]
    k = np.arange(n_freqs)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@lru_cache(maxsize=8)
def window(win_length: int = 400, kind: str = "hann") -> np.ndarray:
    if kind == "hann":
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win_length) / win_length)
    elif kind == "hamming":
        w = 0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(win_length) / (win_length - 1))
    elif kind == "povey":
        w = (
            0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win_length) / (win_length - 1))
        ) ** 0.85
    else:
        raise ValueError(f"unknown window: {kind}")
    return w.astype(np.float32)


@lru_cache(maxsize=8)
def windowed_bases(
    win_length: int = 400, n_fft: int = 512, window_kind: str = "hann"
) -> tuple[np.ndarray, np.ndarray]:
    """DFT bases with the analysis window folded in — one less elementwise
    pass on device: frames @ (w ⊙ cos), frames @ (w ⊙ -sin)."""
    wr, wi = dft_bases(win_length, n_fft)
    w = window(win_length, window_kind)[:, None]
    return (wr * w).astype(np.float32), (wi * w).astype(np.float32)


def num_frames(n_samples: int, win_length: int = 400, hop: int = 160) -> int:
    """Frame count for 'center=False' framing."""
    if n_samples < win_length:
        return 0
    return 1 + (n_samples - win_length) // hop
