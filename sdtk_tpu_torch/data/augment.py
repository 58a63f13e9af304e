"""Training-time waveform augmentation: prosody + channel robustness.

A copy of ``sdtk_tpu/data/augment.py`` (no JAX): the same output, bit
for bit, under the same ``np.random.Generator``.  Each effect is applied
per example with its own probability, on the host, before the batch
reaches the device:

- **speed perturbation** (0.95-1.05): linear-interpolation resample,
  cropped or padded back to the input length;
- **reverb**: synthetic room impulse response — direct path, 3-8 early
  reflections, an exponentially decaying diffuse tail (RT60 0.15-0.7 s);
- **spectral tilt**: first-order pre-/de-emphasis;
- **band-limiting**: 4th-order Butterworth band-pass with random edges;
- **codec companding**: mu-law quantization round trip plus a
  narrow-rate resample round trip (telephone-codec nonlinearity).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SR = 16000


@dataclass(frozen=True)
class AugmentSpec:
    speed_prob: float = 0.0
    speed_range: tuple[float, float] = (0.95, 1.05)
    reverb_prob: float = 0.0
    rt60_range: tuple[float, float] = (0.15, 0.7)
    tilt_prob: float = 0.0
    tilt_range: tuple[float, float] = (-0.6, 0.6)  # pre-emphasis coefficient
    band_prob: float = 0.0
    band_lo_range: tuple[float, float] = (100.0, 400.0)
    band_hi_range: tuple[float, float] = (3000.0, 7500.0)
    codec_prob: float = 0.0
    codec_mu_range: tuple[float, float] = (40.0, 255.0)
    codec_bits_range: tuple[int, int] = (6, 8)
    codec_rate_range: tuple[float, float] = (6000.0, 10000.0)

    @classmethod
    def uniform(cls, prob: float) -> "AugmentSpec":
        """Every effect at the same per-example probability."""
        return cls(speed_prob=prob, reverb_prob=prob, tilt_prob=prob,
                   band_prob=prob, codec_prob=prob)


def speed_perturb(wav: np.ndarray, factor: float) -> np.ndarray:
    """Resample by ``factor`` (linear interpolation), then crop/pad back
    to the original length so batch shapes stay static."""
    n = len(wav)
    m = max(2, int(round(n / factor)))
    src = np.linspace(0.0, n - 1.0, m)
    out = np.interp(src, np.arange(n), wav).astype(np.float32)
    if len(out) >= n:
        return out[:n]
    return np.pad(out, (0, n - len(out)))


def synth_rir(rng: np.random.Generator, sr: int = SR,
              rt60: float = 0.4) -> np.ndarray:
    """Synthetic room impulse response: direct path + sparse early
    reflections + exponentially decaying diffuse (Gaussian) tail."""
    n = int(sr * min(0.5, rt60 * 1.2))
    rir = np.zeros(n, np.float32)
    rir[0] = 1.0
    # 3–8 early reflections in the first 40 ms, decaying amplitude.
    for _ in range(int(rng.integers(3, 9))):
        t = int(rng.uniform(0.003, 0.04) * sr)
        if t < n:
            rir[t] += rng.uniform(0.1, 0.6) * rng.choice([-1.0, 1.0])
    # Diffuse tail: white Gaussian shaped by exp(-6.9 t / RT60)
    # (RT60 = time to decay 60 dB; ln(10^3) ≈ 6.9).
    t_ax = np.arange(n) / sr
    tail = rng.standard_normal(n).astype(np.float32) * np.exp(
        -6.9 * t_ax / rt60
    )
    rir += 0.35 * tail
    return rir / np.max(np.abs(rir))


def apply_reverb(wav: np.ndarray, rir: np.ndarray) -> np.ndarray:
    from scipy.signal import fftconvolve

    wet = fftconvolve(wav, rir)[: len(wav)].astype(np.float32)
    # Preserve loudness so reverb doesn't double as a gain change.
    rms_in = np.sqrt(np.mean(wav**2) + 1e-12)
    rms_out = np.sqrt(np.mean(wet**2) + 1e-12)
    return wet * (rms_in / rms_out)


def spectral_tilt(wav: np.ndarray, coeff: float) -> np.ndarray:
    """First-order tilt: coeff > 0 brightens (pre-emphasis y=x[n]-c·x[n-1]),
    coeff < 0 darkens (one-pole de-emphasis y=x[n]+|c|·y[n-1])."""
    from scipy.signal import lfilter

    if coeff >= 0:
        out = lfilter([1.0, -coeff], [1.0], wav)
    else:
        out = lfilter([1.0 - abs(coeff)], [1.0, -abs(coeff)], wav)
    return out.astype(np.float32)


def band_limit(wav: np.ndarray, lo: float, hi: float, sr: int = SR) -> np.ndarray:
    from scipy.signal import butter, lfilter

    hi = min(hi, 0.499 * sr)
    b, a = butter(4, [lo / (sr / 2.0), hi / (sr / 2.0)], btype="band")
    return lfilter(b, a, wav).astype(np.float32)


def codec_compand(wav: np.ndarray, mu: float, bits: int, rate: float,
                  sr: int = SR) -> np.ndarray:
    """µ-law companding round trip at ``bits`` resolution plus a
    narrow-rate resample round trip — telephone-codec nonlinearity."""
    from scipy.signal import resample_poly

    peak = float(np.max(np.abs(wav))) + 1e-9
    x = wav / peak
    comp = np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)
    levels = float((1 << (bits - 1)) - 1)
    quant = np.round(comp * levels) / levels
    x = np.sign(quant) * np.expm1(np.abs(quant) * np.log1p(mu)) / mu
    # integer-ratio resample round trip near the target rate.  Snap to
    # multiples of 2 kHz: gcd(16k, r) stays >= 2000, so the polyphase
    # filter bank stays tiny (awkward ratios like 87/160 made the
    # augmentation producer the training bottleneck at ~6x the step time).
    from math import gcd

    r = max(2000, int(round(rate / 2000.0)) * 2000)
    g = gcd(sr, r)
    down = resample_poly(x, r // g, sr // g)
    up = resample_poly(down, sr // g, r // g)
    out = np.zeros(len(wav), np.float32)
    n = min(len(wav), len(up))
    out[:n] = up[:n]
    return out * peak


def augment_batch(wavs: np.ndarray, rng: np.random.Generator,
                  spec: AugmentSpec) -> np.ndarray:
    """Apply the augmentation chain per example (in place on a copy)."""
    out = wavs.copy()
    for i in range(len(out)):
        w = out[i]
        if spec.speed_prob and rng.uniform() < spec.speed_prob:
            w = speed_perturb(w, float(rng.uniform(*spec.speed_range)))
        if spec.reverb_prob and rng.uniform() < spec.reverb_prob:
            rir = synth_rir(rng, rt60=float(rng.uniform(*spec.rt60_range)))
            w = apply_reverb(w, rir)
        if spec.tilt_prob and rng.uniform() < spec.tilt_prob:
            w = spectral_tilt(w, float(rng.uniform(*spec.tilt_range)))
        if spec.band_prob and rng.uniform() < spec.band_prob:
            lo = float(rng.uniform(*spec.band_lo_range))
            hi = float(rng.uniform(*spec.band_hi_range))
            w = band_limit(w, lo, hi)
        if spec.codec_prob and rng.uniform() < spec.codec_prob:
            w = codec_compand(
                w,
                mu=float(rng.uniform(*spec.codec_mu_range)),
                bits=int(rng.integers(spec.codec_bits_range[0],
                                      spec.codec_bits_range[1] + 1)),
                rate=float(rng.uniform(*spec.codec_rate_range)),
            )
        out[i] = w
    return out
