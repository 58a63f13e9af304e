"""Audio input and output: decode, resample, slice, encode.

The counterpart of ``sdtk_tpu/utils/audio.py``, with its decoders by
extension (``_DECODERS``) and its tiers:

- WAV: RIFF parsed by hand (PCM 8/16/24/32-bit and IEEE float 32/64) in
  NumPy (the JAX package's C++ reader is not built by the port; it gives
  the same samples);
- FLAC: first party (``utils/flacio.py``);
- MPEG audio (.mp3 .mp2 .mpga): the first-party Layer I/II decoder
  (``utils/mpegaudio.py``), then libmpg123 (``utils/syscodec.py``), then
  the system AV libraries;
- every other container (.m4a .aac .mp4 .ogg .opus .wma .webm .mka): the
  system AV libraries (libavformat, libavcodec, ``utils/avio.py``).

A codec the host lacks raises :class:`AudioFormatError` with the reason,
which speaker-process records as ``unsupported_format``.  Samples are
mixed down to mono, scaled to [-1, 1) as the JAX package's decoders do,
and resampled with ``scipy.signal.resample_poly`` when the rate is not
the target.
"""

from __future__ import annotations

import struct
import wave
from concurrent.futures import ThreadPoolExecutor
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


def _decode_flac(path: str | Path) -> tuple[np.ndarray, int]:
    """FLAC file → float32 (frames, channels) and its sample rate."""
    from .flacio import FlacError, decode

    with open(path, "rb") as f:
        data = f.read()
    try:
        pcm, sr, bits = decode(data)
    except FlacError as e:
        raise AudioFormatError(f"FLAC decode failed for {path}: {e}") from e
    return pcm.astype(np.float32) / float(1 << (bits - 1)), sr


def _decode_mpeg(path: str | Path) -> tuple[np.ndarray, int]:
    """MPEG audio: the first-party Layer I/II decoder, then libmpg123 for
    streams outside its scope (Layer III), then the AV libraries.  Raises
    :class:`AudioFormatError` only when every tier is unable."""
    from .mpegaudio import UnsupportedFormatError, decode

    with open(path, "rb") as f:
        data = f.read()
    try:
        pcm, sr = decode(data)
        return pcm.astype(np.float32)[:, None], sr
    except UnsupportedFormatError as first_party_err:
        from . import syscodec

        sys_err: Exception | None = None
        if syscodec.mpg123_available():
            try:
                return syscodec.decode_mpeg(data)
            except syscodec.SysCodecError as e:
                sys_err = e  # on to the AV tier
        try:
            return _decode_av(path)
        except AudioFormatError:
            pass
        if sys_err is not None:
            raise AudioFormatError(f"{path}: {first_party_err} (system codec also "
                                   f"failed: {sys_err})") from sys_err
        raise AudioFormatError(f"{path}: {first_party_err}") from first_party_err


def _decode_av(path: str | Path) -> tuple[np.ndarray, int]:
    """The system AV libraries (``utils/avio.py``); without them,
    :class:`AudioFormatError` with the reason."""
    from . import avio

    if not avio.available():
        raise AudioFormatError(
            f"cannot decode {path}: requires the system AV libraries "
            f"(libavformat/libavcodec) — {avio.disabled_reason()}")
    try:
        return avio.decode_file(str(path))
    except avio.AvError as e:
        raise AudioFormatError(f"AV decode failed for {path}: {e}") from e


# extension → decoder of (float32 (frames, channels), sample rate)
_DECODERS = {
    ".wav": _decode_wav,
    ".flac": _decode_flac,
    ".mp3": _decode_mpeg,
    ".mp2": _decode_mpeg,
    ".mpga": _decode_mpeg,
    ".m4a": _decode_av,
    ".aac": _decode_av,
    ".mp4": _decode_av,
    ".ogg": _decode_av,
    ".opus": _decode_av,
    ".wma": _decode_av,
    ".webm": _decode_av,
    ".mka": _decode_av,
}


def _decoder(path: Path):
    decoder = _DECODERS.get(path.suffix.lower())
    if decoder is None:
        raise AudioFormatError(
            f"unsupported container: {path.suffix} — supported: "
            f"{', '.join(sorted(_DECODERS))} (first-party + in-process "
            f"system codecs; no ffmpeg CLI required)")
    return decoder


def load_audio(path: str | Path, target_sr: int = TARGET_SR, mono: bool = True
               ) -> tuple[np.ndarray, int]:
    """Decode → mono mixdown (unless ``mono`` is False: (N, channels)) →
    resample to ``target_sr`` (0 keeps the file's rate); returns (float32
    samples, rate)."""
    path = Path(path)
    x, sr = _decoder(path)(path)
    if mono:
        x = x.mean(axis=1)
    if target_sr and sr != target_sr:
        x = (resample(x, sr, target_sr) if mono
             else np.stack([resample(c, sr, target_sr) for c in x.T], axis=1))
        sr = target_sr
    return np.ascontiguousarray(x, dtype=np.float32), sr


def load_audio_batch(paths: list[str | Path], target_sr: int = TARGET_SR, n_threads: int = 0
                     ) -> list[np.ndarray]:
    """:func:`load_audio` of every path on a pool of threads (``n_threads``
    0: one a path, at most 8), in the order given."""
    if not paths:
        return []
    workers = n_threads or min(8, len(paths))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(lambda p: load_audio(p, target_sr)[0], paths))


def probe(path: str | Path) -> AudioInfo:
    """Sample rate, channels, frames, duration and format of any container
    :func:`load_audio` reads."""
    path = Path(path)
    x, sr = _decoder(path)(path)
    return AudioInfo(sr, x.shape[1], x.shape[0], x.shape[0] / sr, path.suffix.lower()[1:])


def load_wav(path: str | Path, target_sr: int = TARGET_SR) -> np.ndarray:
    """Any container :func:`load_audio` reads → float32 mono at ``target_sr``."""
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


def save_mp3(path: str | Path, x: np.ndarray, sr: int = TARGET_SR, bitrate_kbps: int = 128) -> None:
    """float32 [-1, 1] mono → ``.mp3``: MPEG Layer III through libmp3lame
    where the host has it, else the first-party Layer II encoder."""
    from . import syscodec
    from .ioutil import atomic_write_bytes

    if syscodec.lame_available():
        try:
            atomic_write_bytes(path, syscodec.encode_mp3(np.asarray(x), sr, bitrate_kbps))
            return
        except syscodec.SysCodecError:
            pass  # on to the first-party encoder
    from .mpegaudio import encode_layer2

    atomic_write_bytes(path, encode_layer2(np.asarray(x), sr, bitrate_kbps))


def save_flac(path: str | Path, x: np.ndarray, sr: int = TARGET_SR) -> None:
    """float32 [-1, 1] (mono or stereo) → 16-bit FLAC, losslessly."""
    from .flacio import encode
    from .ioutil import atomic_write_bytes

    atomic_write_bytes(path, encode(np.asarray(x), sr, 16))
