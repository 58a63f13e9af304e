"""Plain log-mel features of whole clips (float32 FFT, no kernel, no padding).

A frozen statement of the port's frontend (``FrontendConfig``'s fields):
preemphasis x[n] − c·x[n−1] with x[−1] = 0; frames of ``win_length`` at
``hop_length``, either from the clip's start (``center`` false) or centred
on multiples of the hop with ``win_length // 2`` zeros each side; a Hann
(periodic) or Hamming (symmetric) window; the power spectrum at ``n_fft``;
an HTK triangular mel bank from ``mel_fmin`` to Nyquist; ln(x + floor) or
10·log10(max(x, floor)); the mean over the clip's frames taken off.

Valid frames are the port's: without centring those that lie wholly in the
clip, 1 + (L − win) // hop; with centring those whose centre lies in it,
ceil(L / hop).  ``quant`` rounds the frames and the power spectrum through a
lower precision (the control; ``precision.py``), where the port rounds them
to bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch


def hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz) / 700.0)


def mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel) / 2595.0) - 1.0)


def mel_bank(n_mels: int, n_fft: int, sr: int, fmin: float) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) triangular filters, float64."""
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(sr / 2.0), n_mels + 2))
    fb = np.zeros((len(freqs), n_mels))
    for m in range(n_mels):
        lo, mid, hi = hz[m], hz[m + 1], hz[m + 2]
        fb[:, m] = np.maximum(0.0, np.minimum((freqs - lo) / max(mid - lo, 1e-10),
                                              (hi - freqs) / max(hi - mid, 1e-10)))
    return fb


def window(win: int, kind: str) -> np.ndarray:
    n = np.arange(win)
    if kind == "hann":
        return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win)
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (win - 1))
    raise ValueError(f"window {kind!r} not in the reference")


def n_valid(length: int, cfg: dict) -> int:
    if cfg["center"]:
        return -(-length // cfg["hop_length"])
    return 1 + (length - cfg["win_length"]) // cfg["hop_length"]


def log_mel(x: torch.Tensor, cfg: dict, quant=None) -> torch.Tensor:
    """(B, L) clips of one length → (B, T, n_mels) float32 features over the
    valid frames, mean-normalized per clip when ``cfg["mean_norm"]``."""
    x = x.float()
    length = x.shape[1]
    win, hop = cfg["win_length"], cfg["hop_length"]
    c = cfg["preemphasis"]
    if c > 0:
        x = x - c * torch.nn.functional.pad(x[:, :-1], (1, 0))
    if cfg["center"]:
        x = torch.nn.functional.pad(x, (win // 2, win // 2))
    frames = x.unfold(1, win, hop)[:, : n_valid(length, cfg)]
    if quant is not None:
        frames = quant(frames)
    w = torch.tensor(window(win, cfg["window"]), dtype=torch.float32, device=x.device)
    spec = torch.fft.rfft(frames * w, n=cfg["n_fft"])
    power = spec.real ** 2 + spec.imag ** 2
    if quant is not None:
        power = quant(power)
    fb = torch.tensor(mel_bank(cfg["n_mels"], cfg["n_fft"], cfg["sample_rate"], cfg["mel_fmin"]),
                      dtype=torch.float32, device=x.device)
    mel = power @ fb
    if cfg["log_scale"] == "db":
        feats = 10.0 * torch.log10(torch.clamp(mel, min=cfg["log_floor"]))
    else:
        feats = torch.log(mel + cfg["log_floor"])
    if cfg["mean_norm"]:
        feats = feats - feats.mean(dim=1, keepdim=True)
    return feats
