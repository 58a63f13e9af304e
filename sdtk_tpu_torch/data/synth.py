"""Procedural synthetic voices and meetings (no JAX, no model).

``synth_utterance`` is a copy of ``sdtk_tpu/data/synth.py`` (identical
output per (speaker_id, utterance_id)): a glottal-pulse source at a
speaker-specific F0 driven through speaker-specific formant resonators.
``build_meeting`` follows ``evals/benchmark_der.py:build_meeting`` for the
same-family clean case: K speakers taking turns, with the reference
segmentation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SR = 16000

# Vowel formant templates (F1, F2, F3) in Hz — rough adult averages.
_VOWELS = {
    "a": (730, 1090, 2440),
    "e": (530, 1840, 2480),
    "i": (270, 2290, 3010),
    "o": (570, 840, 2410),
    "u": (300, 870, 2240),
}


@dataclass(frozen=True)
class VoiceSpec:
    f0: float  # fundamental, Hz
    formant_scale: float  # vocal-tract length factor
    vibrato_hz: float
    vibrato_depth: float  # relative F0 excursion
    jitter: float  # per-period F0 noise
    breathiness: float  # noise mix

    @classmethod
    def for_speaker(cls, speaker_id: int) -> "VoiceSpec":
        rng = np.random.default_rng(1_000_003 * (speaker_id + 1))
        return cls(
            f0=float(rng.uniform(85, 280)),
            formant_scale=float(rng.uniform(0.85, 1.2)),
            vibrato_hz=float(rng.uniform(4.0, 7.0)),
            vibrato_depth=float(rng.uniform(0.005, 0.03)),
            jitter=float(rng.uniform(0.003, 0.02)),
            breathiness=float(rng.uniform(0.02, 0.12)),
        )


def _resonator_coeffs(freq: float, bandwidth: float, sr: int) -> tuple[np.ndarray, np.ndarray]:
    """Two-pole resonator (digital formant filter)."""
    r = np.exp(-np.pi * bandwidth / sr)
    theta = 2.0 * np.pi * freq / sr
    a = np.array([1.0, -2.0 * r * np.cos(theta), r * r])
    b = np.array([1.0 - r])
    return b, a


def _glottal_source(f0_track: np.ndarray, sr: int, rng: np.random.Generator) -> np.ndarray:
    """Impulse-ish glottal pulse train following an F0 track (phase
    accumulation → sawtooth-shaped pulses)."""
    phase = np.cumsum(f0_track / sr)
    saw = 2.0 * (phase % 1.0) - 1.0
    # Soft-clip the sawtooth into a pulse-like waveform (richer harmonics).
    return np.sign(saw) * np.abs(saw) ** 0.25


def synth_utterance(
    speaker_id: int,
    utterance_id: int,
    seconds: float = 3.0,
    sr: int = SR,
) -> np.ndarray:
    """Deterministic speech-like utterance for a synthetic speaker."""
    from scipy.signal import lfilter

    spec = VoiceSpec.for_speaker(speaker_id)
    rng = np.random.default_rng(7_777_777 * (speaker_id + 1) + utterance_id)

    n = int(seconds * sr)
    t = np.arange(n) / sr

    # Random vowel sequence with 120-350 ms holds and brief pauses.
    vowels = list(_VOWELS.values())
    out = np.zeros(n, dtype=np.float64)
    pos = 0
    while pos < n:
        hold = int(rng.uniform(0.12, 0.35) * sr)
        hold = min(hold, n - pos)
        if rng.uniform() < 0.15:  # pause
            pos += hold
            continue
        f1, f2, f3 = vowels[rng.integers(len(vowels))]

        # F0 track: base + vibrato + slow drift + jitter
        seg_t = t[pos : pos + hold]
        f0 = spec.f0 * (
            1.0
            + spec.vibrato_depth * np.sin(2 * np.pi * spec.vibrato_hz * seg_t)
            + 0.05 * np.sin(2 * np.pi * 0.6 * seg_t + rng.uniform(0, 6.28))
            + spec.jitter * rng.standard_normal(hold).cumsum() / np.sqrt(np.arange(1, hold + 1))
        )
        src = _glottal_source(f0, sr, rng)
        src = (1.0 - spec.breathiness) * src + spec.breathiness * rng.standard_normal(hold)

        seg = np.zeros(hold)
        for freq, bw in ((f1, 80.0), (f2, 110.0), (f3, 160.0)):
            b, a = _resonator_coeffs(freq * spec.formant_scale, bw, sr)
            seg += lfilter(b, a, src)
        # amplitude envelope (attack/decay)
        env = np.minimum(1.0, np.minimum(np.arange(hold), np.arange(hold)[::-1]) / (0.02 * sr))
        out[pos : pos + hold] = seg * env
        pos += hold

    peak = np.max(np.abs(out)) + 1e-9
    return (0.5 * out / peak).astype(np.float32)


def build_meeting(meeting_id: int, n_speakers: int, n_turns: int, turn_s: float,
                  sr: int = SR) -> tuple[np.ndarray, list[tuple[float, float, str]]]:
    """(waveform, reference segments) of a turn-taking meeting; the same
    audio and reference as the DER benchmark's clean train-family meeting."""
    rng = np.random.default_rng(500 + meeting_id)
    placed = []
    ref = []
    t = 0.0
    prev = -1
    for turn in range(n_turns):
        spk = int(rng.integers(n_speakers))
        if spk == prev:
            spk = (spk + 1) % n_speakers
        prev = spk
        dur = float(rng.uniform(turn_s * 0.7, turn_s * 1.3))
        placed.append((t, synth_utterance(spk, 1000 * meeting_id + turn, dur)))
        ref.append((t, t + dur, f"SPK{spk}"))
        t += dur
    wav = np.zeros(int(np.ceil(t * sr)) + 1, dtype=np.float64)
    for start, piece in placed:
        a = int(start * sr)
        wav[a : a + len(piece)] += piece
    wav = 0.5 * wav / (np.max(np.abs(wav)) + 1e-9)
    return wav.astype(np.float32), ref
