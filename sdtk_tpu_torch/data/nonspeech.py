"""Non-speech beds for training augmentation (no JAX).

A copy of ``sdtk_tpu/data/nonspeech.py``: the same clips, bit for bit,
per seed.  White and pink noise, mains hum, keyboard clicks, chord-bed
music, a monophonic melody, Karplus-Strong plucked strings, percussion
and an ensemble of the three musical ones.  ``sample_nonspeech`` picks a
class by seed; ``mix_at_snr`` lays a bed under speech at a given SNR.
"""

from __future__ import annotations

import numpy as np

SR = 16000


def white_noise(seconds: float, seed: int = 0, sr: int = SR) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal(int(seconds * sr)).astype(np.float32)


def pink_noise(seconds: float, seed: int = 0, sr: int = SR) -> np.ndarray:
    """1/f noise via FFT shaping."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    spec = np.fft.rfft(rng.standard_normal(n))
    f = np.maximum(np.fft.rfftfreq(n, 1 / sr), 1.0)
    x = np.fft.irfft(spec / np.sqrt(f), n)
    return (x / (np.abs(x).max() + 1e-9)).astype(np.float32)


def hum(seconds: float, seed: int = 0, sr: int = SR) -> np.ndarray:
    """Mains hum + harmonics (50/60 Hz family)."""
    rng = np.random.default_rng(seed)
    base = float(rng.choice([50.0, 60.0]))
    t = np.arange(int(seconds * sr)) / sr
    x = sum(
        rng.uniform(0.2, 1.0) / (k + 1) * np.sin(2 * np.pi * base * (k + 1) * t
                                                 + rng.uniform(0, 2 * np.pi))
        for k in range(4)
    )
    return (x / (np.abs(x).max() + 1e-9)).astype(np.float32)


def keyboard(seconds: float, seed: int = 0, sr: int = SR) -> np.ndarray:
    """Typing: sparse wideband clicks with fast decay."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    x = np.zeros(n, np.float32)
    t_click = 0.0
    while t_click < seconds:
        t_click += float(rng.exponential(0.12))
        a = int(t_click * sr)
        if a >= n:
            break
        dur = int(rng.uniform(0.004, 0.02) * sr)
        click = rng.standard_normal(dur) * np.exp(-np.arange(dur) / (0.003 * sr))
        x[a : a + dur] += rng.uniform(0.3, 1.0) * click[: max(0, n - a)]
    return (x / (np.abs(x).max() + 1e-9)).astype(np.float32)


def music(seconds: float, seed: int = 0, sr: int = SR) -> np.ndarray:
    """Music bed: chord progression of harmonic tones with slow note
    envelopes, a bass line, and a percussive pulse — broadband, pitched,
    and amplitude-modulated like real background music, but with none of
    speech's formant structure or syllabic (~4 Hz) modulation."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    x = np.zeros(n, np.float64)
    root = float(rng.uniform(90.0, 260.0))
    # randomized progression and tempo — one fixed voicing was enough
    # structure for the VAD to memorize around (r4: a specific 4/3 chord
    # bar scored 0.61 speech)
    pool = [1.0, 9 / 8, 5 / 4, 4 / 3, 3 / 2, 5 / 3, 15 / 8]
    ratios = [1.0] + [float(rng.choice(pool)) for _ in range(3)]
    bar = float(rng.uniform(1.0, 2.5))
    for b in range(int(np.ceil(seconds / bar))):
        a = int(b * bar * sr)
        z = min(n, int((b + 1) * bar * sr))
        if a >= z:
            break
        tb = t[a:z] - t[a]
        f = root * ratios[b % len(ratios)]
        env = np.exp(-tb / rng.uniform(0.8, 1.6))
        for mult, amp in ((1, 1.0), (5 / 4, 0.6), (3 / 2, 0.7), (2, 0.4)):
            for h in range(1, 5):
                x[a:z] += (amp / h) * env * np.sin(
                    2 * np.pi * f * mult * h * tb + rng.uniform(0, 2 * np.pi))
        # bass
        x[a:z] += 0.8 * np.sin(2 * np.pi * (f / 2) * tb)
    # percussive pulse every 0.5 s
    for beat in np.arange(0.0, seconds, 0.5):
        a = int(beat * sr)
        dur = int(0.05 * sr)
        if a + 4 >= n:
            break
        thump = np.exp(-np.arange(dur) / (0.01 * sr)) * rng.standard_normal(dur)
        x[a : a + dur] += 0.5 * thump[: max(0, n - a)]
    return (x / (np.abs(x).max() + 1e-9)).astype(np.float32)


def melody(seconds: float, seed: int = 0, sr: int = SR) -> np.ndarray:
    """Monophonic melodic instrument — the negative CLASS the chord-bed
    ``music()`` generator does not cover (r4 finding: a VAD trained only
    on ``music()`` passed 68% of a held-out melodic bed as speech — a
    moving pitch with vibrato mimics prosody).  Subtractive-style
    sawtooth voice (harmonic 1/h sum), sharp attack / exponential decay,
    diatonic random walk with leaps, per-note vibrato drawn from a wide
    range, occasional third dyads.  Implementation stays disjoint from
    the held-out eval bed (synth_heldout.heldout_music: FM synthesis,
    swing percussion, noise pad) — this covers the *category*, not the
    test."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    x = np.zeros(n, np.float64)
    scale = np.array([0, 2, 4, 5, 7, 9, 11])
    base = float(rng.uniform(150.0, 500.0))
    deg, tm = 0, 0.0
    while tm < seconds:
        dur = float(rng.uniform(0.15, 0.5))
        a, z = int(tm * sr), min(n, int((tm + dur * 1.2) * sr))
        if a >= z:
            break
        deg = int(np.clip(deg + int(rng.integers(-3, 4)), -7, 14))
        f = base * 2.0 ** ((scale[deg % 7] + 12 * (deg // 7)) / 12.0)
        tb = t[a:z] - t[a]
        vib_hz = float(rng.uniform(3.0, 7.0))
        vib_amt = float(rng.uniform(0.003, 0.02))
        inst = f * tb * (1.0 + vib_amt * np.sin(2 * np.pi * vib_hz * tb))
        env = np.minimum(tb / 0.005, 1.0) * np.exp(
            -tb / float(rng.uniform(0.12, 0.4))
        )
        note = sum(
            (1.0 / h) * np.sin(2 * np.pi * h * inst + rng.uniform(0, 2 * np.pi))
            for h in range(1, 7)
        )
        x[a:z] += env * note
        if rng.uniform() < 0.25:  # third dyad
            x[a:z] += 0.5 * env * np.sin(2 * np.pi * 1.26 * inst)
        tm += dur
    return (x / (np.abs(x).max() + 1e-9)).astype(np.float32)


def plucked(seconds: float, seed: int = 0, sr: int = SR) -> np.ndarray:
    """Plucked-string melody via Karplus-Strong synthesis (burst-excited
    recirculating delay with averaging damping) — a third melodic
    IMPLEMENTATION family, disjoint from both the subtractive ``melody``
    voice and the eval bed's FM synthesis (synth_heldout.heldout_music).
    The delay-line update is vectorized per period, not per sample."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    x = np.zeros(n, np.float64)
    scale = np.array([0, 3, 5, 7, 10])  # minor pentatonic
    base = float(rng.uniform(110.0, 330.0))
    deg, tm = 0, 0.0
    while tm < seconds:
        dur = float(rng.uniform(0.2, 0.6))
        deg = int(np.clip(deg + int(rng.integers(-2, 3)), -5, 10))
        f = base * 2.0 ** ((scale[deg % 5] + 12 * (deg // 5)) / 12.0)
        period = max(int(sr / f), 2)
        buf = rng.uniform(-1.0, 1.0, period)
        damp = float(rng.uniform(0.991, 0.999))
        n_per = int(dur * sr / period) + 1
        chunks = []
        for _ in range(n_per):
            chunks.append(buf.copy())
            buf = damp * 0.5 * (buf + np.roll(buf, -1))
        note = np.concatenate(chunks)[: int(dur * sr)]
        a = int(tm * sr)
        z = min(n, a + len(note))
        x[a:z] += note[: z - a]
        tm += dur * float(rng.uniform(0.8, 1.0))
    return (x / (np.abs(x).max() + 1e-9)).astype(np.float32)


def percussion(seconds: float, seed: int = 0, sr: int = SR) -> np.ndarray:
    """Drum pattern: kick (decaying sine pitch-sweep) + hat (high-passed
    noise burst) on a tempo grid with per-hit timing jitter."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    x = np.zeros(n, np.float64)
    beat = 60.0 / float(rng.uniform(70.0, 140.0))
    tm = 0.0
    k = 0
    while tm < seconds:
        a = max(0, int((tm + rng.uniform(-0.01, 0.01)) * sr))
        if a >= n:
            break
        if k % 2 == 0:  # kick
            dur = int(0.12 * sr)
            tb = np.arange(min(dur, n - a)) / sr
            f0 = float(rng.uniform(50.0, 90.0))
            x[a : a + len(tb)] += np.exp(-tb / 0.05) * np.sin(
                2 * np.pi * (f0 + 60.0 * np.exp(-tb / 0.02)) * tb)
        else:  # hat
            dur = int(0.05 * sr)
            m = min(dur, n - a)
            burst = rng.standard_normal(m)
            if m >= 9:  # high-pass; np.convolve 'same' needs m >= kernel
                burst -= np.convolve(burst, np.ones(9) / 9.0, mode="same")
            x[a : a + m] += 0.5 * np.exp(-np.arange(m) / (0.012 * sr)) * burst
        k += 1
        tm += beat / 2.0
    return (x / (np.abs(x).max() + 1e-9)).astype(np.float32)


def ensemble(seconds: float, seed: int = 0, sr: int = SR) -> np.ndarray:
    """Melody + chord pad + percussion TOGETHER — the structural shape of
    real background music (and of the held-out eval bed), which no single
    training class exhibits.  Built purely from the training-side
    generators, so implementation disjointness from the eval bed is
    preserved; only the CATEGORY (simultaneous pitched lead, sustained
    harmony, rhythm) is covered."""
    rng = np.random.default_rng(seed)
    lead_fn = plucked if rng.uniform() < 0.5 else melody
    lead = lead_fn(seconds, seed=seed + 1, sr=sr)
    pad = music(seconds, seed=seed + 2, sr=sr)
    perc = percussion(seconds, seed=seed + 3, sr=sr)
    m = min(len(lead), len(pad), len(perc))
    x = (float(rng.uniform(0.5, 1.0)) * lead[:m]
         + float(rng.uniform(0.3, 0.8)) * pad[:m]
         + float(rng.uniform(0.2, 0.7)) * perc[:m])
    return (x / (np.abs(x).max() + 1e-9)).astype(np.float32)


GENERATORS = {
    "white": white_noise,
    "pink": pink_noise,
    "hum": hum,
    "keyboard": keyboard,
    "music": music,
    "melody": melody,
    "plucked": plucked,
    "percussion": percussion,
    "ensemble": ensemble,
}


def sample_nonspeech(seconds: float, seed: int, sr: int = SR) -> np.ndarray:
    """One random non-speech clip (class chosen by seed)."""
    rng = np.random.default_rng(seed)
    kind = list(GENERATORS)[int(rng.integers(len(GENERATORS)))]
    x = GENERATORS[kind](seconds, seed=seed + 1, sr=sr)
    return (x * float(rng.uniform(0.2, 1.0))).astype(np.float32)


def mix_at_snr(speech: np.ndarray, bed: np.ndarray, snr_db: float
               ) -> np.ndarray:
    """speech + bed scaled to the given speech-to-bed SNR."""
    n = len(speech)
    if len(bed) < n:
        bed = np.tile(bed, -(-n // len(bed)))
    bed = bed[:n]
    ps = float(np.mean(speech**2) + 1e-12)
    pb = float(np.mean(bed**2) + 1e-12)
    g = np.sqrt(ps / (pb * 10.0 ** (snr_db / 10.0)))
    return (speech + g * bed).astype(np.float32)
