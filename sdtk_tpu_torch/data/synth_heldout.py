"""Held-out synthetic voice family + channel-mismatch tiers (no JAX).

A copy of ``sdtk_tpu/data/synth_heldout.py``: the same voices, utterances
and tiers, bit for bit, per seed.

The bundled checkpoint is trained on ``data/synth.py`` (soft-clipped
sawtooth source, static vowel formants, speaker params seeded from
1_000_003·id).  Evaluating on the same generator only measures
self-consistency (r1 VERDICT missing #2).  This module is a DISJOINT
generator family for evaluation:

- **source model**: LF-style asymmetric glottal-flow-derivative pulses
  (open/return phases) with phase-synchronous aspiration — not a
  sawtooth;
- **spectral content**: diphthong formant *trajectories* (continuous
  glides between targets drawn from a different, 8-vowel inventory) with
  speaker-dependent bandwidth scaling and spectral tilt, plus
  fricative-like band-noise bursts between voiced holds;
- **speaker parameters**: different distributions (F0 75–320 Hz,
  tract-length 0.8–1.25, tilt, aspiration) from an unrelated seed stream
  (23_456_789·id + 11), so no speaker coincides with a training speaker.

Channel tiers (applied post-synthesis, eval-only):

- ``clean``      — nothing;
- ``noise``      — additive white + low-frequency "babble-ish" noise at a
                   target SNR;
- ``reverb``     — convolution with a synthetic exponentially-decaying
                   room impulse response (RT60 0.2–0.6 s);
- ``telephone``  — 300–3400 Hz band-pass, mild mu-law companding
                   round-trip, 8 kHz resample round-trip.

Used by ``sdtk_tpu_torch.evals.der --heldout`` and ``sdtk_tpu_torch.evals.eer``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SR = 16000

# A different 8-vowel inventory (F1, F2, F3) than synth.py's 5-vowel table.
_TARGETS = [
    (310, 2020, 2960),  # i-ish
    (400, 1900, 2570),
    (550, 1770, 2490),
    (690, 1660, 2490),
    (710, 1100, 2540),
    (590, 880, 2540),
    (450, 1030, 2380),
    (350, 680, 2430),  # u-ish
]

_FRICS = [(4500.0, 1400.0), (2600.0, 900.0), (6200.0, 1800.0)]


@dataclass(frozen=True)
class HeldoutVoice:
    f0: float
    tract: float  # vocal-tract length factor
    open_quotient: float  # LF open phase fraction
    tilt_db_oct: float  # spectral tilt
    bw_scale: float  # formant bandwidth factor
    aspiration: float
    drift_hz: float

    @classmethod
    def for_speaker(cls, speaker_id: int) -> "HeldoutVoice":
        rng = np.random.default_rng(23_456_789 * (speaker_id + 1) + 11)
        return cls(
            f0=float(rng.uniform(75, 320)),
            tract=float(rng.uniform(0.8, 1.25)),
            open_quotient=float(rng.uniform(0.45, 0.75)),
            tilt_db_oct=float(rng.uniform(-9.0, -3.0)),
            bw_scale=float(rng.uniform(0.8, 1.5)),
            aspiration=float(rng.uniform(0.01, 0.10)),
            drift_hz=float(rng.uniform(0.2, 0.9)),
        )


def _lf_pulse_train(f0_track: np.ndarray, oq: float, sr: int) -> np.ndarray:
    """LF-style glottal flow derivative from a phase accumulator: negative
    main excitation at closure, smooth open phase, zero closed phase."""
    phase = np.cumsum(f0_track / sr) % 1.0
    # open phase: rising flow (positive derivative, sinusoid half-arch)
    open_part = np.sin(np.pi * phase / oq) * (phase < oq)
    # sharp negative spike at the closure instant (return phase)
    ret = np.exp(-((phase - oq) / 0.02) ** 2) * (phase >= oq)
    return open_part - 3.0 * ret


def _resonator(freq: float, bw: float, sr: int):
    r = np.exp(-np.pi * bw / sr)
    theta = 2.0 * np.pi * min(freq, sr * 0.45) / sr
    a = np.array([1.0, -2.0 * r * np.cos(theta), r * r])
    b = np.array([1.0 - r])
    return b, a


def heldout_utterance(
    speaker_id: int, utterance_id: int, seconds: float = 3.0, sr: int = SR
) -> np.ndarray:
    """Deterministic held-out-family utterance."""
    from scipy.signal import lfilter

    voice = HeldoutVoice.for_speaker(speaker_id)
    rng = np.random.default_rng(
        999_983 * (speaker_id + 7) + 104_729 * (utterance_id + 1)
    )
    n = int(seconds * sr)
    out = np.zeros(n)
    pos = 0
    while pos < n:
        hold = min(int(rng.uniform(0.15, 0.45) * sr), n - pos)
        kind = rng.uniform()
        if kind < 0.12:  # silence gap
            pos += hold
            continue
        if kind < 0.27:  # fricative-ish burst
            fc, bw = _FRICS[rng.integers(len(_FRICS))]
            b, a = _resonator(fc * voice.tract, bw, sr)
            seg = lfilter(b, a, rng.standard_normal(hold)) * 0.3
            env = np.minimum(1.0, np.minimum(np.arange(hold),
                                             np.arange(hold)[::-1]) / (0.015 * sr))
            out[pos : pos + hold] = seg * env
            pos += hold
            continue

        # voiced diphthong: glide between two formant targets
        t0 = _TARGETS[rng.integers(len(_TARGETS))]
        t1 = _TARGETS[rng.integers(len(_TARGETS))]
        alpha = np.linspace(0.0, 1.0, hold)
        seg_t = np.arange(hold) / sr
        f0 = voice.f0 * (
            1.0
            + 0.04 * np.sin(2 * np.pi * voice.drift_hz * seg_t + rng.uniform(0, 6.28))
            + 0.01 * rng.standard_normal()
        )
        src = _lf_pulse_train(f0, voice.open_quotient, sr)
        asp = voice.aspiration * rng.standard_normal(hold)
        # aspiration modulated by the open phase (phase-synchronous noise)
        src = src + asp * (np.abs(src) + 0.3)

        # spectral tilt as a one-pole lowpass chosen per tilt value
        tilt_fc = 4000.0 * 10 ** (voice.tilt_db_oct / 20.0)
        rtilt = np.exp(-2 * np.pi * tilt_fc / sr)
        src = lfilter([1 - rtilt], [1, -rtilt], src)

        # time-varying formant filtering: piecewise over 4 sub-segments
        seg = np.zeros(hold)
        nsub = 4
        for s in range(nsub):
            lo, hi = (hold * s) // nsub, (hold * (s + 1)) // nsub
            if hi <= lo:
                continue
            amid = float(alpha[(lo + hi) // 2])
            sub = np.zeros(hi - lo)
            for j, bw0 in enumerate((90.0, 120.0, 170.0)):
                freq = (t0[j] * (1 - amid) + t1[j] * amid) * voice.tract
                b, a = _resonator(freq, bw0 * voice.bw_scale, sr)
                sub += lfilter(b, a, src[lo:hi])
            seg[lo:hi] = sub
        env = np.minimum(1.0, np.minimum(np.arange(hold),
                                         np.arange(hold)[::-1]) / (0.02 * sr))
        out[pos : pos + hold] = seg * env
        pos += hold

    peak = np.max(np.abs(out)) + 1e-9
    return (0.5 * out / peak).astype(np.float32)


# ---------------------------------------------------------------- channels


def apply_noise(x: np.ndarray, snr_db: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(314_159 + seed)
    from scipy.signal import lfilter

    white = rng.standard_normal(len(x))
    # low-frequency heavy "babble-ish" component
    r = np.exp(-2 * np.pi * 600.0 / SR)
    babble = lfilter([1 - r], [1, -r], rng.standard_normal(len(x)))
    noise = 0.6 * white + 0.4 * babble / (np.std(babble) + 1e-9)
    sig_p = np.mean(x**2) + 1e-12
    noise_p = np.mean(noise**2) + 1e-12
    gain = np.sqrt(sig_p / (noise_p * 10 ** (snr_db / 10.0)))
    return (x + gain * noise).astype(np.float32)


def apply_reverb(x: np.ndarray, rt60: float = 0.4, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(271_828 + seed)
    n_rir = int(rt60 * SR)
    t = np.arange(n_rir) / SR
    rir = rng.standard_normal(n_rir) * np.exp(-6.91 * t / rt60)
    rir[0] = 1.0
    rir /= np.sqrt(np.sum(rir**2))
    y = np.convolve(x, rir)[: len(x)]
    return (0.5 * y / (np.max(np.abs(y)) + 1e-9)).astype(np.float32)


def apply_telephone(x: np.ndarray) -> np.ndarray:
    from scipy.signal import butter, resample_poly, sosfilt

    sos = butter(4, [300.0, 3400.0], btype="band", fs=SR, output="sos")
    y = sosfilt(sos, x)
    # mild mu-law companding round-trip (codec-ish nonlinearity)
    mu = 255.0
    peak = np.max(np.abs(y)) + 1e-9
    yn = y / peak
    comp = np.sign(yn) * np.log1p(mu * np.abs(yn)) / np.log1p(mu)
    quant = np.round(comp * 127.0) / 127.0
    yn = np.sign(quant) * (np.expm1(np.abs(quant) * np.log1p(mu))) / mu
    y = yn * peak
    # 8 kHz round-trip
    y = resample_poly(resample_poly(y, 1, 2), 2, 1)[: len(x)]
    out = np.zeros(len(x), dtype=np.float32)
    out[: len(y)] = y
    return out


def heldout_music(seconds: float, seed: int = 0, sr: int = SR) -> np.ndarray:
    """Held-out music bed — implementation-disjoint from the training bed
    generator (data/nonspeech.music: additive harmonic CHORDS on a bar
    grid with a fixed 0.5 s thump pulse).  This one is an FM-synthesized
    MELODY (vibrato, random-walk pentatonic line on a swung eighth-note
    grid), a slowly swelling band-passed noise pad, and a long-short
    swing percussion pattern.  The eval tier must not share a generator
    with training's ``--bed-prob`` augmentation — the same circularity
    rule as the held-out voice family (r2 finding)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    x = np.zeros(n, np.float64)
    # melody: FM voice over a pentatonic random walk
    scale = np.array([0, 2, 4, 7, 9])
    base = float(rng.uniform(180.0, 420.0))
    step = float(rng.uniform(0.22, 0.45))
    deg, tm = 0, 0.0
    while tm < seconds:
        dur = step * (1.5 if rng.uniform() < 0.3 else 1.0)
        a, z = int(tm * sr), min(n, int((tm + dur) * sr))
        if a >= z:
            break
        deg = int(np.clip(deg + rng.integers(-2, 3), -5, 9))
        f = base * 2.0 ** ((scale[deg % 5] + 12 * (deg // 5)) / 12.0)
        tb = t[a:z] - t[a]
        vib = 1.0 + 0.01 * np.sin(2 * np.pi * 5.5 * tb)
        phase = 2 * np.pi * f * vib * tb + float(
            rng.uniform(1.0, 3.0)
        ) * np.sin(2 * np.pi * 2 * f * tb)
        env = np.minimum(tb / 0.02, 1.0) * np.exp(
            -tb / float(rng.uniform(0.25, 0.6))
        )
        x[a:z] += env * np.sin(phase)
        tm += dur
    # pad: band-passed noise with a slow amplitude swell
    spec = np.fft.rfft(rng.standard_normal(n))
    freqs = np.fft.rfftfreq(n, 1 / sr)
    band = np.exp(-0.5 * ((freqs - rng.uniform(300.0, 900.0)) / 250.0) ** 2)
    pad = np.fft.irfft(spec * band, n)
    swell = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.05, 0.2) * t)
    x += 0.4 * pad / (np.abs(pad).max() + 1e-9) * swell
    # percussion: long-short swing, slower decay than the training thump
    beat, k, tp = float(rng.uniform(0.4, 0.7)), 0, 0.0
    while tp < seconds:
        a, dur = int(tp * sr), int(0.08 * sr)
        if a + 4 >= n:
            break
        burst = rng.standard_normal(dur) * np.exp(
            -np.arange(dur) / (0.025 * sr)
        )
        x[a : a + dur] += (0.6 if k % 2 == 0 else 0.3) * burst[: max(0, n - a)]
        tp += beat * (1.32 if k % 2 == 0 else 0.68)
        k += 1
    return (x / (np.abs(x).max() + 1e-9)).astype(np.float32)


TIERS = ("clean", "noise", "reverb", "telephone", "music")


def apply_tier(x: np.ndarray, tier: str, seed: int = 0,
               snr_db: float = 15.0) -> np.ndarray:
    if tier == "clean":
        return x
    if tier == "noise":
        return apply_noise(x, snr_db, seed)
    if tier == "reverb":
        return apply_reverb(x, seed=seed)
    if tier == "telephone":
        return apply_telephone(x)
    if tier == "music":
        # continuous music bed under the WHOLE meeting (including any
        # silence gaps) — the tier that separates a trained VAD from the
        # energy gate, which clusters music-only windows as speakers.
        # Uses the HELD-OUT bed generator, never the training one
        # (data/nonspeech.music feeds --bed-prob augmentation).
        from .nonspeech import mix_at_snr

        bed = heldout_music(len(x) / 16000.0 + 1.0, seed=seed + 77)
        return mix_at_snr(x, bed, snr_db)
    raise ValueError(f"unknown tier '{tier}' (use one of {TIERS})")
