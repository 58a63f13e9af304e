"""WAV input and output, resampling and segment slicing.

A copy of the WAV part of ``sdtk_tpu/utils/audio.py``: RIFF parsed by hand
(PCM 8/16/24/32-bit and IEEE float 32/64), mixed down to mono, scaled to
[-1, 1) as the JAX package's decoder does, and resampled with
``scipy.signal.resample_poly`` when the rate is not the target.  Other
containers are later work.
"""

from __future__ import annotations

import struct
import wave
from dataclasses import dataclass
from math import gcd
from pathlib import Path

import numpy as np

TARGET_SR = 16000


@dataclass
class AudioInfo:
    """Container metadata (the JAX package's ``probe`` result)."""

    sample_rate: int
    channels: int
    n_frames: int
    duration: float
    format: str


class AudioFormatError(ValueError):
    pass


def _check_wav(path: Path) -> None:
    if path.suffix.lower() != ".wav":
        raise AudioFormatError(f"unsupported container: {path.suffix} — the port reads .wav "
                               f"only so far")


def _decode_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """WAV file → float32 (frames, channels) and its sample rate."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise AudioFormatError(f"not a RIFF/WAVE file: {path}")
    pos, fmt, payload = 12, None, None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            payload = body
        pos += 8 + size + (size & 1)
    if fmt is None or payload is None:
        raise AudioFormatError(f"missing fmt/data chunk: {path}")

    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE: taken as PCM
        audio_format = 1
    if audio_format == 1 and bits in (8, 16, 24, 32):
        if bits == 8:
            x = (np.frombuffer(payload, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(payload, np.uint8)
            b = b[: len(b) // 3 * 3].reshape(-1, 3).astype(np.int32)
            v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
            x = np.where(v >= 1 << 23, v - (1 << 24), v).astype(np.float32) / float(1 << 23)
        else:
            x = np.frombuffer(payload, f"<i{bits // 8}").astype(np.float32) / float(1 << (bits - 1))
    elif audio_format == 3:  # IEEE float
        x = np.frombuffer(payload, "<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise AudioFormatError(f"unsupported WAV codec {audio_format}/{bits}-bit: {path}")
    return x[: len(x) // channels * channels].reshape(-1, channels), sample_rate


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling."""
    if sr_in == sr_out:
        return x
    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    return resample_poly(x, sr_out // g, sr_in // g).astype(np.float32)


def load_audio(path: str | Path, target_sr: int = TARGET_SR) -> tuple[np.ndarray, int]:
    """WAV → mono float32 at ``target_sr`` (0 keeps the file's rate);
    returns (samples, rate)."""
    path = Path(path)
    _check_wav(path)
    x, sr = _decode_wav(path)
    x = x.mean(axis=1)
    if target_sr and sr != target_sr:
        x, sr = resample(x, sr, target_sr), target_sr
    return np.ascontiguousarray(x, dtype=np.float32), sr


def probe(path: str | Path) -> AudioInfo:
    """Sample rate, channels, frames, duration and format of a WAV file;
    any other container raises :class:`AudioFormatError`."""
    path = Path(path)
    _check_wav(path)
    x, sr = _decode_wav(path)
    return AudioInfo(sr, x.shape[1], x.shape[0], x.shape[0] / sr, "wav")


def load_wav(path: str | Path, target_sr: int = TARGET_SR) -> np.ndarray:
    """PCM or float WAV → float32 mono at ``target_sr``."""
    return load_audio(path, target_sr)[0]


def slice_segments(x: np.ndarray, sr: int, segments: list[tuple[float, float]]) -> np.ndarray:
    """Concatenate the [start, end) second ranges of a waveform."""
    n = len(x)
    parts = [x[max(0, int(round(a * sr))) : min(n, int(round(b * sr)))] for a, b in segments]
    parts = [p for p in parts if len(p)]
    return np.concatenate(parts) if parts else np.zeros(0, dtype=np.float32)


def save_wav(path: str | Path, x: np.ndarray, sr: int = TARGET_SR) -> None:
    """float32 [-1, 1] mono → 16-bit PCM WAV."""
    pcm = (np.clip(np.asarray(x), -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
