"""Multi-family procedural voice corpus for training (no JAX).

A copy of ``sdtk_tpu/data/synth_families.py``: the same batches, bit for
bit, per (family, speaker, utterance).  Family 0 is ``data/synth.py``'s
corpus; families 1-4 vary the source model (Rosenberg glottal flow,
soft-clip sawtooth, narrow pulse train, soft-clipped square), the
formant inventories (static holds or diphthong glides, fricative
bursts), and per-family voice-quality ranges (tilt, bandwidth,
aspiration, open quotient).  Every random stream is seeded by an
``np.random.default_rng`` sequence seed disjoint from ``data/synth.py``'s.
Training one AAM class per (family, speaker) pair makes speaker identity
the only signal that survives family shuffling.

Used by ``sdtk_tpu_torch.training --families``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SR = 16000

# Per-family formant inventories (F1, F2, F3).  Chosen inside plausible
# adult ranges but distinct from synth.py's _VOWELS and
# synth_heldout's _TARGETS tables.
_INV_ROSENBERG = (
    (640, 1190, 2390),
    (480, 1720, 2520),
    (290, 2190, 2890),
    (520, 920, 2330),
    (330, 800, 2180),
    (600, 1500, 2600),
)
_INV_SAW_GLIDE = (
    (740, 1180, 2300),
    (620, 1660, 2430),
    (430, 2080, 2750),
    (280, 2340, 3080),
    (500, 1000, 2280),
    (340, 760, 2260),
    (560, 1330, 2480),
)
_INV_PULSE = (
    (700, 1220, 2600),
    (560, 1550, 2700),
    (380, 1950, 2850),
    (260, 2250, 3150),
    (620, 990, 2450),
    (420, 880, 2300),
    (310, 2050, 2650),
    (660, 1400, 2550),
)
_INV_SQUARE = (
    (710, 1150, 2350),
    (450, 1780, 2560),
    (300, 2150, 2950),
    (540, 870, 2250),
    (380, 1500, 2450),
)


@dataclass(frozen=True)
class FamilySpec:
    """Generator axes for one synthetic voice family."""

    fid: int
    source: str  # "rosenberg" | "saw" | "pulse" | "square"
    inventory: tuple[tuple[float, float, float], ...]
    glide: bool  # formant trajectories between targets vs static holds
    fric_prob: float  # fricative-burst probability per hold
    pause_prob: float
    hold_s: tuple[float, float]
    f0_hz: tuple[float, float]
    tract: tuple[float, float]  # vocal-tract length factor range
    tilt_db_oct: tuple[float, float] | None  # spectral tilt range (None: off)
    bw_scale: tuple[float, float]  # formant bandwidth factor range
    aspiration: tuple[float, float]
    nasal: bool  # extra low nasal-ish resonator


FAMILIES: dict[int, FamilySpec] = {
    1: FamilySpec(
        fid=1, source="rosenberg", inventory=_INV_ROSENBERG, glide=False,
        fric_prob=0.0, pause_prob=0.18, hold_s=(0.10, 0.30),
        f0_hz=(95, 240), tract=(0.9, 1.3), tilt_db_oct=(-8.0, -2.0),
        bw_scale=(0.7, 1.2), aspiration=(0.02, 0.10), nasal=True,
    ),
    2: FamilySpec(
        fid=2, source="saw", inventory=_INV_SAW_GLIDE, glide=True,
        fric_prob=0.18, pause_prob=0.10, hold_s=(0.15, 0.40),
        f0_hz=(75, 330), tract=(0.82, 1.18), tilt_db_oct=None,
        bw_scale=(0.9, 1.6), aspiration=(0.01, 0.08), nasal=False,
    ),
    3: FamilySpec(
        fid=3, source="pulse", inventory=_INV_PULSE, glide=True,
        fric_prob=0.10, pause_prob=0.14, hold_s=(0.12, 0.50),
        f0_hz=(110, 300), tract=(0.85, 1.25), tilt_db_oct=(-10.0, -4.0),
        bw_scale=(0.8, 1.4), aspiration=(0.03, 0.12), nasal=False,
    ),
    4: FamilySpec(
        fid=4, source="square", inventory=_INV_SQUARE, glide=False,
        fric_prob=0.25, pause_prob=0.12, hold_s=(0.10, 0.35),
        f0_hz=(80, 320), tract=(0.78, 1.10), tilt_db_oct=(-6.0, -1.0),
        bw_scale=(0.75, 1.3), aspiration=(0.02, 0.14), nasal=True,
    ),
}

_FRIC_BANDS = ((5200.0, 1600.0), (3100.0, 1000.0), (6800.0, 2000.0))


@dataclass(frozen=True)
class FamilyVoice:
    """Per-speaker voice parameters drawn from the family's distributions."""

    f0: float
    tract: float
    open_quotient: float
    tilt_db_oct: float | None
    bw_scale: float
    aspiration: float
    vibrato_hz: float
    vibrato_depth: float
    jitter: float
    nasal_hz: float
    duty: float  # pulse-train duty cycle (pulse source only)

    @classmethod
    def for_speaker(cls, spec: FamilySpec, speaker_id: int) -> "FamilyVoice":
        # Sequence seed → a stream disjoint from synth.py / synth_heldout
        # integer-product seeds for all ids.
        rng = np.random.default_rng([0x5D7C, spec.fid, speaker_id, 0xFA31])
        tilt = (
            float(rng.uniform(*spec.tilt_db_oct))
            if spec.tilt_db_oct is not None
            else None
        )
        return cls(
            f0=float(rng.uniform(*spec.f0_hz)),
            tract=float(rng.uniform(*spec.tract)),
            open_quotient=float(rng.uniform(0.4, 0.8)),
            tilt_db_oct=tilt,
            bw_scale=float(rng.uniform(*spec.bw_scale)),
            aspiration=float(rng.uniform(*spec.aspiration)),
            vibrato_hz=float(rng.uniform(3.5, 7.5)),
            vibrato_depth=float(rng.uniform(0.003, 0.035)),
            jitter=float(rng.uniform(0.002, 0.025)),
            nasal_hz=float(rng.uniform(240.0, 460.0)),
            duty=float(rng.uniform(0.06, 0.16)),
        )


def _resonator(freq: float, bw: float, sr: int):
    r = np.exp(-np.pi * bw / sr)
    theta = 2.0 * np.pi * min(freq, sr * 0.45) / sr
    return np.array([1.0 - r]), np.array([1.0, -2.0 * r * np.cos(theta), r * r])


def _source(spec: FamilySpec, voice: FamilyVoice, f0_track: np.ndarray,
            sr: int) -> np.ndarray:
    """Excitation signal for one hold, per the family's source model."""
    phase = np.cumsum(f0_track / sr) % 1.0
    if spec.source == "saw":
        saw = 2.0 * phase - 1.0
        return np.sign(saw) * np.abs(saw) ** 0.25
    if spec.source == "square":
        sq = np.sign(np.sin(2.0 * np.pi * phase) + 1e-12)
        return np.tanh(2.5 * sq + 0.6 * np.sin(4.0 * np.pi * phase))
    if spec.source == "pulse":
        # Narrow rectangular pulses at each glottal cycle, DC-removed.
        p = (phase < voice.duty).astype(np.float64)
        return p - p.mean()
    if spec.source == "rosenberg":
        # Rosenberg-C glottal flow (quadratic rise over the open phase,
        # quadratic fall over the return phase), differentiated to a flow
        # derivative — a different pulse shape from synth_heldout's
        # sine-arch + gaussian-return LF approximation.
        oq = voice.open_quotient
        cq = 0.3 * oq  # closing phase fraction
        rise = phase / oq
        flow_open = (3.0 - 2.0 * rise) * rise**2 * (phase < oq)
        fall = np.clip((phase - oq) / max(cq, 1e-3), 0.0, 1.0)
        flow_close = (1.0 - fall**2) * ((phase >= oq) & (phase < oq + cq))
        flow = flow_open + flow_close
        d = np.diff(flow, prepend=flow[:1])
        peak = np.max(np.abs(d)) + 1e-9
        return d / peak
    raise ValueError(f"unknown source '{spec.source}'")


def family_utterance(
    family_id: int,
    speaker_id: int,
    utterance_id: int,
    seconds: float = 3.0,
    sr: int = SR,
) -> np.ndarray:
    """Deterministic utterance for (family, speaker, utterance).

    Family 0 delegates to data/synth.py (the original corpus, unchanged);
    families 1–4 use this module's parametric synthesizer.
    """
    if family_id == 0:
        from .synth import synth_utterance

        return synth_utterance(speaker_id, utterance_id, seconds, sr)
    from scipy.signal import lfilter

    spec = FAMILIES[family_id]
    voice = FamilyVoice.for_speaker(spec, speaker_id)
    rng = np.random.default_rng(
        [0x7E55, family_id, speaker_id, utterance_id, 0x1C9B]
    )

    n = int(seconds * sr)
    out = np.zeros(n)
    pos = 0
    while pos < n:
        hold = min(int(rng.uniform(*spec.hold_s) * sr), n - pos)
        roll = rng.uniform()
        if roll < spec.pause_prob:
            pos += hold
            continue
        if roll < spec.pause_prob + spec.fric_prob:
            fc, bw = _FRIC_BANDS[rng.integers(len(_FRIC_BANDS))]
            b, a = _resonator(fc * voice.tract, bw, sr)
            seg = lfilter(b, a, rng.standard_normal(hold)) * 0.3
            env = np.minimum(
                1.0,
                np.minimum(np.arange(hold), np.arange(hold)[::-1]) / (0.015 * sr),
            )
            out[pos : pos + hold] = seg * env
            pos += hold
            continue

        # F0 track: base + vibrato + slow drift + jitter random walk.
        seg_t = np.arange(hold) / sr
        f0 = voice.f0 * (
            1.0
            + voice.vibrato_depth
            * np.sin(2 * np.pi * voice.vibrato_hz * seg_t + rng.uniform(0, 6.28))
            + 0.04 * np.sin(2 * np.pi * 0.5 * seg_t + rng.uniform(0, 6.28))
            + voice.jitter
            * rng.standard_normal(hold).cumsum()
            / np.sqrt(np.arange(1, hold + 1))
        )
        src = _source(spec, voice, f0, sr)
        # aspiration noise, amplitude-tied to the excitation
        src = src + voice.aspiration * rng.standard_normal(hold) * (
            np.abs(src) + 0.4
        )
        if voice.tilt_db_oct is not None:
            tilt_fc = 4000.0 * 10 ** (voice.tilt_db_oct / 20.0)
            rt = np.exp(-2 * np.pi * tilt_fc / sr)
            src = lfilter([1 - rt], [1, -rt], src)

        t0 = spec.inventory[rng.integers(len(spec.inventory))]
        if spec.glide:
            t1 = spec.inventory[rng.integers(len(spec.inventory))]
        else:
            t1 = t0
        seg = np.zeros(hold)
        nsub = 4 if spec.glide else 1
        for s in range(nsub):
            lo, hi = (hold * s) // nsub, (hold * (s + 1)) // nsub
            if hi <= lo:
                continue
            amid = (lo + hi) / 2.0 / max(hold, 1)
            sub = np.zeros(hi - lo)
            for j, bw0 in enumerate((85.0, 115.0, 165.0)):
                freq = (t0[j] * (1 - amid) + t1[j] * amid) * voice.tract
                b, a = _resonator(freq, bw0 * voice.bw_scale, sr)
                sub += lfilter(b, a, src[lo:hi])
            if spec.nasal:
                b, a = _resonator(voice.nasal_hz * voice.tract, 90.0, sr)
                sub += 0.35 * lfilter(b, a, src[lo:hi])
            seg[lo:hi] = sub
        env = np.minimum(
            1.0, np.minimum(np.arange(hold), np.arange(hold)[::-1]) / (0.02 * sr)
        )
        out[pos : pos + hold] = seg * env
        pos += hold

    peak = np.max(np.abs(out)) + 1e-9
    return (0.5 * out / peak).astype(np.float32)


def synth_family_batch(
    family_ids: np.ndarray,
    speaker_ids: np.ndarray,
    utterance_ids: np.ndarray,
    seconds: float = 3.0,
    sr: int = SR,
) -> np.ndarray:
    """(B,) family + (B,) speaker + (B,) utterance ids → (B, n) float32."""
    return np.stack(
        [
            family_utterance(int(f), int(s), int(u), seconds, sr)
            for f, s, u in zip(family_ids, speaker_ids, utterance_ids)
        ]
    )
