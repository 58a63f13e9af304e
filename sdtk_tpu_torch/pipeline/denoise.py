"""Meeting-adaptive bed suppression in front of the embedder.

The r5 music-tier decomposition (docs/PERFORMANCE.md): once VAD v4 gates
bed-only windows, the residual DER is embedder CONFUSION under the bed —
the tower was never trained on pitched interference, and the bed's
spectral signature dominates the inter-speaker differences.

The bed, however, is approximately stationary across a meeting, and the
trained VAD has ALREADY located bed-only audio (the regions outside its
speech intervals).  That makes classical spectral subtraction free:

1. estimate the bed's power spectrum as the per-bin MEDIAN over
   bed-only STFT frames (median, not mean — robust to leaked speech);
2. apply an over-subtracting Wiener-style gain per (frame, bin),
   ``G = max(1 - beta·N/P, floor)``, amplitude ``sqrt(G)``, with the
   mixture phase;
3. overlap-add back to a waveform that feeds the embedder unchanged.

The estimate self-gates: in clean/reverb/telephone meetings the
non-speech regions are near-silence, so ``N ≈ 0`` and the gain is ~1
everywhere (measured no-op); an additional energy gate skips the pass
entirely when the bed is >30 dB below speech.  Offline only — the
streaming path cannot see the future bed (pipeline/streaming.py keeps
the raw feed).

The reference has no analogue: its cloud provider owns the acoustic
front end (speechmatics_backend.py); this framework owns it.

A NumPy copy of ``sdtk_tpu/pipeline/denoise.py`` (identical numerics).
"""

from __future__ import annotations

import numpy as np


def estimate_and_subtract(
    wav: np.ndarray,
    sr: int,
    speech_spans: list[tuple[float, float]],
    frame_probs: tuple[float, np.ndarray] | None = None,
    n_fft: int = 512,
    hop: int = 128,
    beta: float = 1.6,
    gain_floor: float = 0.08,
    min_bed_seconds: float = 1.0,
    max_bed_gap_db: float = 30.0,
    bed_prob_bar: float = 0.25,
) -> np.ndarray:
    """Suppress the stationary bed estimated from non-speech regions.

    ``frame_probs`` — the VAD's raw (frame_period, 10 ms probability
    grid) — is the preferred bed locator: frames below ``bed_prob_bar``
    are bed.  The merged ``speech_spans`` are a fallback only; their
    0.25 s padding and 0.3 s gap-bridging deliberately swallow exactly
    the short bed-only gaps the estimator needs (measured: a 100 s
    music-tier meeting left only 0.93 s of span-complement audio).

    Returns the input unchanged when there is not enough bed-only audio
    (< ``min_bed_seconds``) or the bed is already ``max_bed_gap_db``
    quieter than speech (nothing to win; protects clean tiers from any
    processing artifact).
    """
    wav = np.asarray(wav, np.float32)
    n = len(wav)
    if n < n_fft or (not speech_spans and frame_probs is None):
        return wav

    in_speech = np.zeros(n, dtype=bool)
    if frame_probs is not None:
        period, grid = frame_probs
        step = max(1, int(round(period * sr)))
        speech_frames = np.asarray(grid) >= bed_prob_bar
        sample_frame = np.minimum(np.arange(n) // step,
                                  len(speech_frames) - 1)
        in_speech = speech_frames[sample_frame]
    else:
        for a, b in speech_spans:
            in_speech[int(a * sr) : int(b * sr)] = True

    bed_samples = ~in_speech
    if bed_samples.sum() < min_bed_seconds * sr:
        return wav
    bed_rms = float(np.sqrt(np.mean(wav[bed_samples] ** 2) + 1e-12))
    speech_rms = float(np.sqrt(np.mean(wav[in_speech] ** 2) + 1e-12)) \
        if in_speech.any() else bed_rms
    if bed_rms < speech_rms * 10.0 ** (-max_bed_gap_db / 20.0):
        return wav  # bed is negligible; don't touch the audio

    window = np.hanning(n_fft).astype(np.float32)
    n_frames = 1 + (n - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = wav[idx] * window
    spec = np.fft.rfft(frames, axis=1)
    power = np.abs(spec) ** 2

    centers = hop * np.arange(n_frames) + n_fft // 2
    bed_frames = ~in_speech[np.minimum(centers, n - 1)]
    if bed_frames.sum() < max(8, int(min_bed_seconds * sr / hop / 4)):
        return wav
    noise = np.median(power[bed_frames], axis=0)

    gain = np.sqrt(np.maximum(
        1.0 - beta * noise[None, :] / (power + 1e-12), gain_floor ** 2))
    out_spec = spec * gain
    out_frames = np.fft.irfft(out_spec, n=n_fft, axis=1) * window

    out = np.zeros(n, np.float64)
    norm = np.zeros(n, np.float64)
    np.add.at(out, idx, out_frames)
    # explicit tile: np.add.at silently corrupts with broadcast values
    np.add.at(norm, idx,
              np.tile(window.astype(np.float64) ** 2, (n_frames, 1)))
    tail = norm <= 1e-8
    out = out / np.maximum(norm, 1e-8)
    out[tail] = wav[tail]  # un-covered edges keep the original samples
    return out.astype(np.float32)
