"""WAV input and output with the standard library's ``wave`` module.

PCM 8/16/24/32-bit, mixed down to mono, scaled to [-1, 1) as the JAX
package's decoder does, and resampled with ``scipy.signal.resample_poly``
when the rate is not the target.  Other containers are later work.
"""

from __future__ import annotations

import wave
from math import gcd
from pathlib import Path

import numpy as np


def load_wav(path: str | Path, target_sr: int = 16000) -> np.ndarray:
    """PCM WAV → float32 mono at ``target_sr``."""
    with wave.open(str(path), "rb") as w:
        ch, width, sr = w.getnchannels(), w.getsampwidth(), w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
        v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        x = np.where(v >= 1 << 23, v - (1 << 24), v).astype(np.float32) / float(1 << 23)
    else:
        x = np.frombuffer(raw, f"<i{width}").astype(np.float32) / float(1 << (8 * width - 1))
    x = x[: len(x) // ch * ch].reshape(-1, ch).mean(axis=1)
    if sr != target_sr:
        from scipy.signal import resample_poly

        g = gcd(sr, target_sr)
        x = resample_poly(x, target_sr // g, sr // g)
    return np.ascontiguousarray(x, dtype=np.float32)


def save_wav(path: str | Path, x: np.ndarray, sr: int = 16000) -> None:
    """float32 [-1, 1] mono → 16-bit PCM WAV."""
    pcm = (np.clip(np.asarray(x), -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
