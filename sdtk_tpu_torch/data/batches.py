"""The training batch stream: synthesized, cropped, gained and augmented
waveforms with their AAM class labels (no JAX, no torch).

:func:`make_batch` is the body of the JAX trainer's ``make_batch``
closure (``sdtk_tpu/training.py``) as a function of ``(rng, spec)``.  It
draws from ``rng`` in the same order — classes, utterance ids, crop
offsets, gain, the augmentation chain, the noise mask and SNR, the beds —
so one seed gives the same batches in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .synth import SR


@dataclass(frozen=True)
class BatchSpec:
    family_ids: tuple[int, ...] = (0,)
    n_speakers: int = 64  # per family: one class per (family, speaker)
    batch: int = 32
    seconds: float = 3.0  # synthesized utterance length
    crop_seconds: float = 1.5  # random crop fed to the model
    aug_prob: float = 0.0
    noise_prob: float = 0.0
    noise_snr_db: tuple[float, float] = (5.0, 25.0)
    bed_prob: float = 0.0
    bed_snr_db: tuple[float, float] = (3.0, 20.0)

    @property
    def n_classes(self) -> int:
        return self.n_speakers * len(self.family_ids)

    @property
    def n_samples(self) -> int:
        return int(min(self.crop_seconds or self.seconds, self.seconds) * SR)


def make_batch(rng: np.random.Generator, spec: BatchSpec) -> tuple[np.ndarray, np.ndarray]:
    """One batch: ((batch, n_samples) float32 waveforms, (batch,) int64
    class ids)."""
    from .synth_families import synth_family_batch

    batch, n_samples = spec.batch, spec.n_samples
    full_len = int(spec.seconds * SR)
    cls = rng.integers(0, spec.n_classes, batch)
    fam_idx, sids = np.divmod(cls, spec.n_speakers)
    fams = np.asarray([spec.family_ids[i] for i in fam_idx])
    uids = rng.integers(0, 1_000_000, batch)
    wavs = synth_family_batch(fams, sids, uids, spec.seconds)
    if n_samples < full_len:
        offs = rng.integers(0, full_len - n_samples + 1, batch)
        wavs = np.stack([w[o : o + n_samples] for w, o in zip(wavs, offs)])
    wavs = wavs * rng.uniform(0.3, 1.2, (batch, 1)).astype(np.float32)
    if spec.aug_prob > 0:
        from .augment import AugmentSpec, augment_batch

        wavs = augment_batch(wavs, rng, AugmentSpec.uniform(spec.aug_prob))
    if spec.noise_prob > 0:
        # additive white noise at a random SNR on a random subset
        mask_n = rng.uniform(size=batch) < spec.noise_prob
        if mask_n.any():
            rms = np.sqrt((wavs**2).mean(axis=1, keepdims=True) + 1e-12)
            snr_db = rng.uniform(*spec.noise_snr_db, (batch, 1))
            sigma = rms * 10.0 ** (-snr_db / 20.0) * mask_n[:, None]
            wavs = (wavs + sigma * rng.standard_normal(wavs.shape)).astype(np.float32)
    if spec.bed_prob > 0:
        # structured non-speech beds (music, hum, keyboard, pink) under the speech
        from .nonspeech import mix_at_snr, sample_nonspeech

        for i in np.nonzero(rng.uniform(size=batch) < spec.bed_prob)[0]:
            bed = sample_nonspeech(n_samples / SR + 0.1, int(rng.integers(1 << 30)))
            wavs[i] = mix_at_snr(wavs[i], bed, float(rng.uniform(*spec.bed_snr_db)))
    return wavs, cls
