"""Per-backend audio format requirements.

A copy of ``sdtk_tpu/backends/audio_profiles.py``: the ``AudioProfile``
dataclass, the ``PROFILES`` registry (the on-device backend is ``gpu``
here), ``register_profile`` and ``format_ffmpeg_args``.  Conversion
happens in-process (``utils.audio.load_audio(**profile.load_kwargs())``);
``format_ffmpeg_args`` is kept for users exporting an equivalent ffmpeg
command line.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class AudioProfile:
    """Audio format a backend expects (default: 16 kHz mono 16-bit WAV;
    ``max_duration_sec`` None = unlimited)."""

    sample_rate: int = 16000
    channels: int = 1
    format: str = "wav"
    bit_depth: int = 16
    max_duration_sec: float | None = None

    @property
    def container(self) -> str:
        """Alias of ``format``."""
        return self.format

    def load_kwargs(self) -> dict:
        """kwargs for ``utils.audio.load_audio`` satisfying this profile."""
        return {"target_sr": self.sample_rate, "mono": self.channels == 1}


PROFILES: dict[str, AudioProfile] = {
    "default": AudioProfile(),
    "gpu": AudioProfile(),
    "fake": AudioProfile(),
    "speechmatics": AudioProfile(),  # the cloud accepts most; 16 kHz mono is sent
    "pyannote": AudioProfile(),
}


def get_profile(backend_name: str) -> AudioProfile:
    return PROFILES.get(backend_name, PROFILES["default"])


def register_profile(backend_name: str, profile: AudioProfile) -> None:
    PROFILES[backend_name] = profile


def format_ffmpeg_args(profile: AudioProfile) -> list[str]:
    """ffmpeg argument list (no input/output paths) converting audio to
    this profile: ``-ar SR -ac CH -f FMT``, an explicit little-endian PCM
    codec for WAV bit depths 16/24/32, and ``-t`` for a duration cap."""
    args = ["-ar", str(profile.sample_rate), "-ac", str(profile.channels), "-f", profile.format]
    if profile.format == "wav" and profile.bit_depth in (16, 24, 32):
        args += ["-acodec", f"pcm_s{profile.bit_depth}le"]
    if profile.max_duration_sec is not None:
        args += ["-t", str(profile.max_duration_sec)]
    return args
