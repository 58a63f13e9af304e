"""Seeded speech-like audio: a pool of synthetic voices, crops and meetings.

The voice model is that of ``sdtk_tpu_torch/data/synth.py`` (a glottal
pulse train at a speaker's F0, with vibrato, drift and jitter, through three
formant resonators of a random vowel per 120-350 ms hold, an attack/decay
envelope per hold and pauses), frozen here so that a later change to the
program cannot move the inputs.  It is computed in a vectorized form: each
hold's three resonators start from rest, as ``lfilter`` does there, so a hold
is the convolution of its source with the resonators' closed-form impulse
response, done by FFT for all holds at once.  The program's version takes
60-430 ms per 3 s utterance; this one makes a pool of minutes in well under a
second.  The noise draws come in another order than there, so the samples
are not the program's, only its voices.
"""

from __future__ import annotations

import numpy as np

SR = 16000

# Vowel formant templates (F1, F2, F3) in Hz and the resonators' bandwidths.
VOWELS = np.array([(730, 1090, 2440), (530, 1840, 2480), (270, 2290, 3010),
                   (570, 840, 2410), (300, 870, 2240)], np.float64)
BANDWIDTHS = np.array([80.0, 110.0, 160.0])
MAX_HOLD_S = 0.35


def rng_for(*key: int) -> np.random.Generator:
    """A NumPy generator for a tuple of whole numbers of any size."""
    return np.random.default_rng([int(k) & (2**63 - 1) for k in key])


def voice(speaker_id: int) -> dict:
    """The speaker's fixed voice parameters (``VoiceSpec.for_speaker``'s law)."""
    rng = np.random.default_rng(1_000_003 * (speaker_id + 1))
    return {"f0": rng.uniform(85, 280), "formant_scale": rng.uniform(0.85, 1.2),
            "vibrato_hz": rng.uniform(4.0, 7.0), "vibrato_depth": rng.uniform(0.005, 0.03),
            "jitter": rng.uniform(0.003, 0.02), "breathiness": rng.uniform(0.02, 0.12)}


def _holds(rng: np.random.Generator, n: int) -> list[tuple[int, int, int, float]]:
    """(start, length, vowel or -1 for a pause, drift phase) of each hold."""
    out, pos = [], 0
    while pos < n:
        hold = min(int(rng.uniform(0.12, MAX_HOLD_S) * SR), n - pos)
        if rng.uniform() < 0.15:
            out.append((pos, hold, -1, 0.0))
        else:
            out.append((pos, hold, int(rng.integers(len(VOWELS))), rng.uniform(0, 6.28)))
        pos += hold
    return out


def _impulse(freqs: np.ndarray, length: int) -> np.ndarray:
    """Sum of the three two-pole resonators' impulse responses, (V, length),
    for (V, 3) formant frequencies: (1 − r)·rⁿ·sin((n + 1)θ)/sin θ."""
    n = np.arange(length)[None, None, :]
    r = np.exp(-np.pi * BANDWIDTHS / SR)[None, :, None]
    theta = (2.0 * np.pi * freqs / SR)[:, :, None]
    h = (1.0 - r) * r ** n * np.sin((n + 1) * theta) / np.sin(theta)
    return h.sum(axis=1)


def utterances(speaker_ids: list[int], seconds: float, seed: int) -> np.ndarray:
    """(len(speaker_ids), seconds·SR) float32 utterances, peak 0.5, the
    i-th in the voice of ``speaker_ids[i]``, drawn from ``seed``."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    lmax = int(MAX_HOLD_S * SR)
    nfft = 1 << int(np.ceil(np.log2(2 * lmax)))
    out = np.zeros((len(speaker_ids), n), np.float64)
    for u, spk in enumerate(speaker_ids):
        v = voice(spk)
        rng = rng_for(seed, u, spk)
        holds = [h for h in _holds(rng, n) if h[2] >= 0]
        jit = rng.standard_normal(n)
        breath = rng.standard_normal(n)
        if not holds:
            continue
        # every voiced sample at once: its hold, its place in the hold
        starts = np.array([h[0] for h in holds])
        lens = np.array([h[1] for h in holds])
        hid = np.repeat(np.arange(len(holds)), lens)
        k = np.arange(hid.size) - np.repeat(np.cumsum(lens) - lens, lens)
        idx = starts[hid] + k
        seg_t = t[idx]

        def seg_cumsum(x):  # cumulative sum restarting at each hold
            c = np.cumsum(x)
            return c - np.repeat(c[np.cumsum(lens) - lens] - x[np.cumsum(lens) - lens], lens)

        phase = np.array([h[3] for h in holds])[hid]
        f0 = v["f0"] * (1.0 + v["vibrato_depth"] * np.sin(2 * np.pi * v["vibrato_hz"] * seg_t)
                        + 0.05 * np.sin(2 * np.pi * 0.6 * seg_t + phase)
                        + v["jitter"] * seg_cumsum(jit[idx]) / np.sqrt(k + 1))
        saw = 2.0 * (seg_cumsum(f0 / SR) % 1.0) - 1.0
        pulse = np.sign(saw) * np.sqrt(np.sqrt(np.abs(saw)))
        src = np.zeros((len(holds), lmax))
        src[hid, k] = (1.0 - v["breathiness"]) * pulse + v["breathiness"] * breath[idx]
        vowel = np.array([h[2] for h in holds])
        spectra = np.fft.rfft(_impulse(VOWELS * v["formant_scale"], lmax), nfft)  # (5, bins)
        seg = np.fft.irfft(np.fft.rfft(src, nfft) * spectra[vowel], nfft)[:, :lmax]
        env = np.minimum(1.0, np.minimum(k, lens[hid] - 1 - k) / (0.02 * SR))
        out[u, idx] = seg[hid, k] * env
    peak = np.abs(out).max(axis=1, keepdims=True) + 1e-9
    return (0.5 * out / peak).astype(np.float32)


def speakers(seed: int, count: int) -> list[int]:
    """``count`` distinct speaker ids drawn from ``seed``."""
    return [int(s) for s in rng_for(seed, 1).choice(100_000, size=count, replace=False)]


def voice_pool(seed: int, n_speakers: int, per_speaker: int, seconds: float
               ) -> tuple[np.ndarray, list[int]]:
    """(n_speakers · per_speaker, seconds·SR) utterances, speaker-major, and
    the speaker ids."""
    ids = speakers(seed, n_speakers)
    return utterances([s for s in ids for _ in range(per_speaker)], seconds, seed), ids


def meeting(pool: np.ndarray, n_speakers: int, seconds: float, turn_s: tuple[float, float],
            gain: tuple[float, float], seed: int, index: int,
            out: np.ndarray | None = None) -> np.ndarray:
    """Recording ``index`` of ``seed``: (seconds·SR,) float32, turns of
    ``turn_s`` seconds taken in turn by the pool's ``n_speakers`` speakers
    (never the same twice in a row), each a slice of one of the speaker's
    utterances at a random offset and gain.  ``pool`` is speaker-major;
    ``out``, when given, is filled and returned."""
    rng = rng_for(seed, 2, index)
    per = pool.shape[0] // n_speakers
    ulen = pool.shape[1]
    n = int(seconds * SR)
    out = np.empty(n, np.float32) if out is None else out
    pos, prev = 0, -1
    while pos < n:
        spk = int(rng.integers(n_speakers - 1 if prev >= 0 else n_speakers))
        spk = spk + (spk >= prev) if prev >= 0 else spk
        m = min(int(rng.uniform(*turn_s) * SR), n - pos, ulen)
        row = spk * per + int(rng.integers(per))
        off = int(rng.integers(ulen - m + 1))
        np.multiply(pool[row, off : off + m], np.float32(rng.uniform(*gain)),
                    out=out[pos : pos + m])
        pos += m
        prev = spk
    return out
